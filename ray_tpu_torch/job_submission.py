"""Job submission: run driver scripts on the cluster and track them.

Parity: `dashboard/modules/job/` — `JobSubmissionClient`
(`sdk.py:40`, `submit_job:125`), `JobManager` running each entrypoint as a
supervised subprocess on the head with its logs captured. Here the manager
is a detached named actor (so any client reaches it) and the REST surface
is served by ray_tpu_torch.dashboard.

Counterpart of ``ray_tpu/job_submission.py``. A job's driver attaches to
the port's cluster and to no other: its environment maps the manager's
``RAY_TPU_TORCH_GCS_ADDRESS`` to ``RAY_TPU_TORCH_ADDRESS``, which
``ray_tpu_torch.init()`` reads. Job logs land under ``ray_tpu_torch`` in
the temp directory (``TMPDIR``), as the runtime's sessions do, never in
a fixed path.
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
import threading
import time
import urllib.request
import uuid
from typing import Any

import ray_tpu_torch

JOB_MANAGER_NAME = "raytpu_job_manager"

PENDING, RUNNING, SUCCEEDED, FAILED, STOPPED = (
    "PENDING", "RUNNING", "SUCCEEDED", "FAILED", "STOPPED")


def default_log_dir() -> str:
    """``<temp dir>/ray_tpu_torch/job_logs``."""
    return os.path.join(tempfile.gettempdir(), "ray_tpu_torch", "job_logs")


def job_env(env: dict | None = None) -> dict:
    """A job driver's environment: this process's, with the cluster's
    GCS address as ``RAY_TPU_TORCH_ADDRESS`` (the driver's
    ``ray_tpu_torch.init()`` attaches to this cluster), then ``env``."""
    full_env = dict(os.environ)
    gcs = os.environ.get("RAY_TPU_TORCH_GCS_ADDRESS")
    if gcs:
        full_env["RAY_TPU_TORCH_ADDRESS"] = gcs
    full_env.update(env or {})
    return full_env


class _JobManager:
    """Detached actor supervising job subprocesses on its node."""

    def __init__(self, log_dir: str | None = None):
        self.log_dir = log_dir or default_log_dir()
        os.makedirs(self.log_dir, exist_ok=True)
        self.jobs: dict[str, dict] = {}
        self._procs: dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()

    def submit(self, entrypoint: str, *, job_id: str | None = None,
               env: dict | None = None, cwd: str | None = None,
               metadata: dict | None = None) -> str:
        job_id = job_id or f"raysubmit_{uuid.uuid4().hex[:12]}"
        with self._lock:
            if job_id in self.jobs:
                raise ValueError(f"job {job_id} already exists")
            log_path = os.path.join(self.log_dir, f"{job_id}.log")
            self.jobs[job_id] = {
                "job_id": job_id,
                "entrypoint": entrypoint,
                "status": PENDING,
                "submitted_at": time.time(),
                "log_path": log_path,
                "metadata": metadata or {},
                "return_code": None,
            }
        full_env = job_env(env)
        log = open(log_path, "ab")
        try:
            proc = subprocess.Popen(
                entrypoint, shell=True, stdout=log, stderr=log,
                cwd=cwd, env=full_env, start_new_session=True,
            )
        except OSError as e:
            with self._lock:
                self.jobs[job_id]["status"] = FAILED
                self.jobs[job_id]["error"] = repr(e)
            return job_id
        with self._lock:
            self._procs[job_id] = proc
            self.jobs[job_id]["status"] = RUNNING
        threading.Thread(target=self._reap, args=(job_id, proc),
                         daemon=True).start()
        return job_id

    def _reap(self, job_id: str, proc: subprocess.Popen) -> None:
        rc = proc.wait()
        with self._lock:
            job = self.jobs[job_id]
            job["return_code"] = rc
            job["finished_at"] = time.time()
            if job["status"] != STOPPED:
                job["status"] = SUCCEEDED if rc == 0 else FAILED
            self._procs.pop(job_id, None)

    def stop(self, job_id: str) -> bool:
        with self._lock:
            proc = self._procs.get(job_id)
            if proc is None:
                return False
            self.jobs[job_id]["status"] = STOPPED
        proc.terminate()
        return True

    def status(self, job_id: str) -> dict | None:
        with self._lock:
            return dict(self.jobs[job_id]) if job_id in self.jobs else None

    def list(self) -> list[dict]:
        with self._lock:
            return [dict(j) for j in self.jobs.values()]

    def logs(self, job_id: str, tail: int | None = None) -> str:
        job = self.status(job_id)
        if job is None:
            return ""
        try:
            with open(job["log_path"], "rb") as f:
                data = f.read().decode(errors="replace")
        except FileNotFoundError:
            return ""
        if tail is not None:
            data = "\n".join(data.splitlines()[-tail:])
        return data


def get_job_manager():
    """The cluster's (detached, named) job manager actor."""
    return ray_tpu_torch.remote(_JobManager).options(
        name=JOB_MANAGER_NAME, get_if_exists=True, lifetime="detached",
        num_cpus=0, max_concurrency=8,
    ).remote()


class JobSubmissionClient:
    """SDK facade. `address` may be a GCS address ("host:port", direct actor
    calls) or a dashboard URL ("http://host:port", REST)."""

    def __init__(self, address: str | None = None):
        self._http = address.rstrip("/") if (
            address and address.startswith("http")) else None
        if self._http is None:
            if address is not None and not ray_tpu_torch.is_initialized():
                ray_tpu_torch.init(address=address)
            self._mgr = get_job_manager()

    # ---- REST transport ----

    def _rest(self, method: str, path: str, body: dict | None = None) -> Any:
        req = urllib.request.Request(
            self._http + path, method=method,
            data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read().decode())

    # ---- API ----

    def submit_job(self, *, entrypoint: str, job_id: str | None = None,
                   runtime_env: dict | None = None,
                   metadata: dict | None = None) -> str:
        env = (runtime_env or {}).get("env_vars")
        if self._http:
            out = self._rest("POST", "/api/jobs/", {
                "entrypoint": entrypoint, "job_id": job_id,
                "env": env, "metadata": metadata,
            })
            return out["job_id"]
        return ray_tpu_torch.get(self._mgr.submit.remote(
            entrypoint, job_id=job_id, env=env, metadata=metadata))

    def get_job_status(self, job_id: str) -> str:
        return self.get_job_info(job_id)["status"]

    def get_job_info(self, job_id: str) -> dict:
        if self._http:
            return self._rest("GET", f"/api/jobs/{job_id}")
        info = ray_tpu_torch.get(self._mgr.status.remote(job_id))
        if info is None:
            raise ValueError(f"job {job_id} not found")
        return info

    def list_jobs(self) -> list[dict]:
        if self._http:
            return self._rest("GET", "/api/jobs/")
        return ray_tpu_torch.get(self._mgr.list.remote())

    def get_job_logs(self, job_id: str) -> str:
        if self._http:
            return self._rest("GET", f"/api/jobs/{job_id}/logs")["logs"]
        return ray_tpu_torch.get(self._mgr.logs.remote(job_id))

    def stop_job(self, job_id: str) -> bool:
        if self._http:
            return self._rest("POST", f"/api/jobs/{job_id}/stop")["stopped"]
        return ray_tpu_torch.get(self._mgr.stop.remote(job_id))

    def wait_until_finished(self, job_id: str, timeout: float = 300.0) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.get_job_status(job_id)
            if status in (SUCCEEDED, FAILED, STOPPED):
                return status
            time.sleep(0.25)
        raise TimeoutError(f"job {job_id} still {status} after {timeout}s")
