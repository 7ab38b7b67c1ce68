"""The port's runtime, case for case as the JAX package's
``tests/test_remote_driver.py``.

Remote drivers ("Ray Client" parity) + driver log streaming.

The reference needs a gRPC proxy (`util/client/ARCHITECTURE.md`) because its
drivers must colocate with plasma. Here the control plane is already plain
TCP, so a remote driver connects DIRECTLY to the GCS + a raylet — the only
same-host dependency is the /dev/shm object plane, replaced in remote mode
by an RPC object plane (`ray://` address scheme).
"""

import os
import subprocess
import sys
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster


def test_remote_driver_over_rpc_object_plane():
    """A driver in a separate process with NO access to the cluster's shm
    arena (remote mode) runs tasks, puts/gets large objects, uses actors."""
    cluster = Cluster(head_node_args={"num_cpus": 4})
    try:
        host, port = cluster.gcs_address
        code = f"""
import numpy as np
import ray_tpu_torch

ray_tpu_torch.init(address="ray://{host}:{port}")

@ray_tpu_torch.remote
def double(x):
    return x * 2

# large object: forces the RPC object plane (no shm attach remotely)
arr = np.arange(1 << 16, dtype=np.int64)
ref = ray_tpu_torch.put(arr)
out = ray_tpu_torch.get(double.remote(ref), timeout=120)
assert int(out[5]) == 10, out[5]

@ray_tpu_torch.remote
class Acc:
    def __init__(self):
        self.n = 0
    def add(self, k):
        self.n += k
        return self.n

a = Acc.remote()
assert ray_tpu_torch.get(a.add.remote(7), timeout=120) == 7
assert ray_tpu_torch.get(a.add.remote(5), timeout=120) == 12
print("REMOTE-DRIVER-OK")
"""
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            timeout=300, env=env,
        )
        assert "REMOTE-DRIVER-OK" in out.stdout, (out.stdout, out.stderr[-2000:])
    finally:
        cluster.shutdown()


def test_worker_prints_stream_to_driver():
    """User print() inside a task reaches the driver's stderr
    (ref: _private/log_monitor.py:100 → worker.py print_logs)."""
    code = """
import time
import ray_tpu_torch

ray_tpu_torch.init(num_cpus=2)

@ray_tpu_torch.remote
def chatty():
    print("hello-from-task-xyzzy")
    return 1

assert ray_tpu_torch.get(chatty.remote(), timeout=120) == 1
time.sleep(2.5)  # log monitor tick + pubsub delivery
ray_tpu_torch.shutdown()
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "hello-from-task-xyzzy" in out.stderr, out.stderr[-2000:]


def test_remote_driver_chunked_large_objects():
    """Objects above remote_object_chunk_bytes stream in chunks both ways
    (a big put from a ray:// driver must not die on the RPC frame
    cap). Chunk size shrunk to 1 MiB so a 5 MiB array
    exercises multi-chunk upload AND download cheaply."""
    cluster = Cluster(head_node_args={"num_cpus": 2})
    try:
        host, port = cluster.gcs_address
        code = f"""
import numpy as np
import ray_tpu_torch

ray_tpu_torch.init(address="ray://{host}:{port}",
             _system_config={{"remote_object_chunk_bytes": 1 << 20}})

arr = np.arange((5 << 20) // 8, dtype=np.int64)   # 5 MiB payload
ref = ray_tpu_torch.put(arr)

@ray_tpu_torch.remote
def head_tail(x):
    return int(x[0]), int(x[-1]), len(x)

h, t, n = ray_tpu_torch.get(head_tail.remote(ref), timeout=120)
assert (h, t, n) == (0, len(arr) - 1, len(arr)), (h, t, n)

# Round-trip: a large TASK RETURN streams back to the driver chunked.
@ray_tpu_torch.remote
def big():
    return np.full((5 << 20) // 8, 7, dtype=np.int64)

out = ray_tpu_torch.get(big.remote(), timeout=120)
assert out.shape[0] == (5 << 20) // 8 and int(out[123]) == 7
back = ray_tpu_torch.get(ref, timeout=120)
assert np.array_equal(back, arr)
ray_tpu_torch.shutdown()
print("CHUNKED_OK")
"""
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
        r = subprocess.run([sys.executable, "-c", code], env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-1500:]
        assert "CHUNKED_OK" in r.stdout
    finally:
        cluster.shutdown()
