"""Node: process supervisor that spawns GCS + raylet subprocesses.

Parity with the reference's Node (`python/ray/_private/
node.py:895,928,1045` start_gcs_server/start_raylet/start_head_processes):
readiness is signalled through a pipe fd instead of polling log files.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import uuid

from ray_tpu_torch.core.config import Config


def _spawn_with_ready_fd(cmd: list[str], log_path: str, timeout: float = 20.0):
    """Spawn `cmd + [--ready-fd N]`; wait for `host:port\\n` on the pipe."""
    r, w = os.pipe()
    os.set_inheritable(w, True)
    log = open(log_path, "ab")
    proc = subprocess.Popen(
        cmd + ["--ready-fd", str(w)],
        pass_fds=(w,), stdout=log, stderr=log,
    )
    os.close(w)
    buf = b""
    deadline = time.monotonic() + timeout
    while not buf.endswith(b"\n"):
        if time.monotonic() > deadline:
            proc.terminate()
            raise TimeoutError(f"process {cmd[2]} not ready; see {log_path}")
        chunk = os.read(r, 256)
        if not chunk:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"process died during startup; see {log_path}"
                )
            time.sleep(0.05)
            continue
        buf += chunk
    os.close(r)
    host, port = buf.decode().strip().rsplit(":", 1)
    return proc, (host, int(port))


class Node:
    def __init__(
        self,
        config: Config,
        *,
        head: bool,
        resources: dict[str, float],
        gcs_address: tuple[str, int] | None = None,
        session_dir: str | None = None,
        labels: dict[str, str] | None = None,
    ):
        self.config = config
        self.head = head
        self.resources = resources
        self.gcs_address = gcs_address
        self.labels = labels or {}
        self.raylet_address: tuple[str, int] | None = None
        self.procs: list[subprocess.Popen] = []
        self.session_dir = session_dir or os.path.join(
            config.session_dir, f"session-{uuid.uuid4().hex[:8]}"
        )
        os.makedirs(os.path.join(self.session_dir, "logs"), exist_ok=True)
        self._config_path = os.path.join(self.session_dir, "config.json")
        with open(self._config_path, "w") as f:
            f.write(config.to_json())

    def start(self) -> None:
        logs = os.path.join(self.session_dir, "logs")
        if self.head:
            gcs_proc, self.gcs_address = _spawn_with_ready_fd(
                [sys.executable, "-m", "ray_tpu_torch.core.gcs",
                 "--config", self._config_path,
                 "--snapshot-path",
                 os.path.join(self.session_dir, "gcs_snapshot.pkl")],
                os.path.join(logs, "gcs.log"),
            )
            self.procs.append(gcs_proc)
        assert self.gcs_address is not None
        raylet_proc, self.raylet_address = _spawn_with_ready_fd(
            [sys.executable, "-m", "ray_tpu_torch.core.raylet",
             "--gcs", f"{self.gcs_address[0]}:{self.gcs_address[1]}",
             "--resources", json.dumps(self.resources),
             "--labels", json.dumps(self.labels),
             "--config", self._config_path,
             "--session-dir", self.session_dir],
            os.path.join(logs, "raylet.log"),
        )
        self.procs.append(raylet_proc)

    def restart_gcs(self) -> None:
        """Kill and restart the GCS at the same port with its snapshot —
        the fault-injection hook for GCS failover tests
        (ref: tests/test_gcs_fault_tolerance.py)."""
        assert self.head and self.procs, "not a running head node"
        gcs_proc = self.procs[0]
        gcs_proc.kill()
        gcs_proc.wait(timeout=10)
        logs = os.path.join(self.session_dir, "logs")
        new_proc, self.gcs_address = _spawn_with_ready_fd(
            [sys.executable, "-m", "ray_tpu_torch.core.gcs",
             "--config", self._config_path,
             "--port", str(self.gcs_address[1]),
             "--snapshot-path",
             os.path.join(self.session_dir, "gcs_snapshot.pkl")],
            os.path.join(logs, "gcs.log"),
        )
        self.procs[0] = new_proc

    def stop(self) -> None:
        for p in reversed(self.procs):
            try:
                p.terminate()
            except ProcessLookupError:
                pass
        for p in reversed(self.procs):
            try:
                p.wait(timeout=3)
            except subprocess.TimeoutExpired:
                p.kill()
        self.procs.clear()
