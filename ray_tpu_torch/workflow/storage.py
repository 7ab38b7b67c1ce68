"""Durable workflow storage.

Counterpart of ``ray_tpu/workflow/storage.py`` on the port's runtime;
importing it imports no torch.

Parity: `python/ray/workflow/workflow_storage.py:229` over
`ray.storage` — step results + metadata persisted so a crashed or killed
workflow resumes from its last completed step. Filesystem-backed (a cloud
URI scheme would plug in behind the same read/write seam); writes are
tmp+rename atomic.
"""

from __future__ import annotations

import json
import os
import pickle
import tempfile
import time

import cloudpickle

STATUS_RUNNING = "RUNNING"
STATUS_SUCCESSFUL = "SUCCESSFUL"
STATUS_FAILED = "FAILED"
STATUS_RESUMABLE = "RESUMABLE"


def default_base_dir() -> str:
    """``RAY_TPU_TORCH_WORKFLOW_DIR``, else ``<temp dir>/ray_tpu_torch/
    workflows``, beside the port's sessions and job logs (the
    reference's default is ``~/.ray_tpu/workflows``)."""
    return os.environ.get(
        "RAY_TPU_TORCH_WORKFLOW_DIR",
        os.path.join(tempfile.gettempdir(), "ray_tpu_torch", "workflows"),
    )


class WorkflowStorage:
    def __init__(self, workflow_id: str, base_dir: str | None = None):
        self.workflow_id = workflow_id
        self.root = os.path.join(base_dir or default_base_dir(), workflow_id)
        os.makedirs(os.path.join(self.root, "steps"), exist_ok=True)

    # ---- atomic file helpers ----

    @staticmethod
    def _write(path: str, data: bytes) -> None:
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    # ---- workflow level ----

    def save_spec(self, dag_blob: bytes, meta: dict) -> None:
        self._write(os.path.join(self.root, "dag.pkl"), dag_blob)
        self.save_meta({**meta, "created_at": time.time()})

    def load_spec(self) -> bytes:
        with open(os.path.join(self.root, "dag.pkl"), "rb") as f:
            return f.read()

    def save_meta(self, meta: dict) -> None:
        self._write(os.path.join(self.root, "meta.json"),
                    json.dumps(meta).encode())

    def load_meta(self) -> dict:
        try:
            with open(os.path.join(self.root, "meta.json")) as f:
                return json.load(f)
        except FileNotFoundError:
            return {}

    def set_status(self, status: str) -> None:
        meta = self.load_meta()
        meta["status"] = status
        meta["updated_at"] = time.time()
        self.save_meta(meta)

    def status(self) -> str | None:
        return self.load_meta().get("status")

    # ---- step level ----

    def _step_path(self, step_id: str) -> str:
        return os.path.join(self.root, "steps", f"{step_id}.pkl")

    def has_step(self, step_id: str) -> bool:
        return os.path.exists(self._step_path(step_id))

    def save_step_result(self, step_id: str, value) -> None:
        self._write(self._step_path(step_id), cloudpickle.dumps(value))

    def load_step_result(self, step_id: str):
        with open(self._step_path(step_id), "rb") as f:
            return pickle.loads(f.read())

    def completed_steps(self) -> list[str]:
        d = os.path.join(self.root, "steps")
        return [fn[:-4] for fn in os.listdir(d) if fn.endswith(".pkl")]


def list_workflows(base_dir: str | None = None) -> list[tuple[str, str | None]]:
    base = base_dir or default_base_dir()
    if not os.path.isdir(base):
        return []
    out = []
    for wid in sorted(os.listdir(base)):
        st = WorkflowStorage(wid, base).status()
        out.append((wid, st))
    return out
