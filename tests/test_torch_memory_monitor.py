"""The port's runtime, case for case as the JAX package's
``tests/test_memory_monitor.py``.

Memory monitor + OOM worker-killing policy.

A memory-hog task triggers kill+retry instead
of taking the node down. Ref: common/memory_monitor.h:48,
raylet/worker_killing_policy.h:58 (RetriableLIFO).
"""

import os
import tempfile
import time

import pytest

import ray_tpu_torch


@pytest.fixture
def small_memory_cluster():
    # Cap the summed worker RSS at 400 MiB; host-fraction path stays off.
    ray_tpu_torch.init(num_cpus=4, _system_config={
        "memory_limit_bytes": 400 * 1024 * 1024,
        "memory_monitor_period_s": 0.2,
        "memory_usage_threshold": 1.1,
    })
    yield
    ray_tpu_torch.shutdown()


def test_hog_killed_then_retry_succeeds(small_memory_cluster):
    """First attempt hogs memory and gets OOM-killed; the retry (which
    doesn't hog — simulating freed pressure) succeeds. The node survives."""
    marker = os.path.join(tempfile.gettempdir(),
                          f"raytpu-oom-marker-{os.getpid()}")
    if os.path.exists(marker):
        os.unlink(marker)

    @ray_tpu_torch.remote(max_retries=3)
    def maybe_hog(marker_path):
        if not os.path.exists(marker_path):
            open(marker_path, "w").close()
            blob = bytearray(600 * 1024 * 1024)  # exceed the node limit
            blob[::4096] = b"x" * len(blob[::4096])  # force residency
            time.sleep(30)  # parked until the monitor kills us
            return -1
        return 7

    assert ray_tpu_torch.get(maybe_hog.remote(marker), timeout=120) == 7
    os.unlink(marker)

    # Node is still healthy: ordinary work proceeds.
    @ray_tpu_torch.remote
    def ok():
        return "alive"

    assert ray_tpu_torch.get(ok.remote(), timeout=60) == "alive"


def test_persistent_hog_fails_cleanly(small_memory_cluster):
    """A task that always exceeds the limit exhausts its retries and fails
    with a worker-crash error — not a hung node."""

    @ray_tpu_torch.remote(max_retries=1)
    def always_hog():
        blob = bytearray(600 * 1024 * 1024)
        blob[::4096] = b"x" * len(blob[::4096])
        time.sleep(30)
        return -1

    with pytest.raises(ray_tpu_torch.api.RayTaskError) as err:
        ray_tpu_torch.get(always_hog.remote(), timeout=120)
    assert "WorkerCrashed" in str(err.value) or "died" in str(err.value)

    @ray_tpu_torch.remote
    def ok():
        return 1

    assert ray_tpu_torch.get(ok.remote(), timeout=60) == 1
