"""Serve replicas and the "GPU" resource on the port's cluster.

- ``ray_actor_options={"num_gpus": x}`` asks for the logical ``"GPU"``
  resource, as ``remote(num_gpus=x)`` does: two replicas at 0.5 both
  place on a ``resources={"GPU": 1}`` cluster, a third stays pending.
- ``num_tpus`` raises ``ValueError`` before anything is deployed (the
  port has no TPU resource; the JAX package maps it to ``"TPU"``).
- ``LLMDeployment`` with ``device`` None serves on cuda: on a host
  without CUDA its constructor raises, and `serve.run` reports that
  failure instead of serving on the CPU.

Exact comparisons (counts and resources); no float tolerance.
"""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4, resources={"GPU": 1})
    yield
    serve.shutdown()
    ray_tpu_torch.shutdown()


def test_half_gpu_replicas_place_and_a_third_pends(cluster):
    @serve.deployment(name="halfgpu", num_replicas=2,
                      ray_actor_options={"num_gpus": 0.5})
    class Half:
        def __call__(self, req):
            import os

            return os.getpid()

    dep = Half.bind()
    handle = serve.run(dep, timeout=120.0)
    pids = {ray_tpu_torch.get(handle.remote({}), timeout=60)
            for _ in range(12)}
    assert len(pids) == 2
    assert serve.status()["halfgpu"]["live_replicas"] == 2
    # The resource view follows the raylet's report: poll for it.
    deadline = time.monotonic() + 30
    while (time.monotonic() < deadline and ray_tpu_torch
           .available_resources().get("GPU", 0.0) > 0.0):
        time.sleep(0.2)
    assert ray_tpu_torch.available_resources().get("GPU", 0.0) == 0.0
    # A third half-GPU replica cannot place: it stays pending while the
    # two live ones keep serving.
    serve.run(dep.options(num_replicas=3), _blocking_until_ready=False)
    deadline = time.monotonic() + 3.0
    while time.monotonic() < deadline:
        st = serve.status()["halfgpu"]
        assert st["num_replicas"] == 3 and st["live_replicas"] == 2, st
        time.sleep(0.2)
    assert ray_tpu_torch.get(handle.remote({}), timeout=60) in pids
    serve.delete("halfgpu")
    deadline = time.monotonic() + 30
    while (time.monotonic() < deadline and ray_tpu_torch
           .available_resources().get("GPU", 0.0) < 1.0):
        time.sleep(0.2)
    assert ray_tpu_torch.available_resources().get("GPU") == 1.0


def test_num_tpus_raises(cluster):
    @serve.deployment(name="tpuask", ray_actor_options={"num_tpus": 1})
    def f(req):
        return 1

    with pytest.raises(ValueError, match="num_tpus"):
        serve.run(f)
    assert "tpuask" not in serve.status()


def test_default_device_without_cuda_fails_serve_run(cluster):
    import torch

    from ray_tpu_torch.serve.llm import LLMDeployment

    assert not torch.cuda.is_available()
    dep = serve.deployment(LLMDeployment, name="nogpu").options(
        num_replicas=1, ray_actor_options={"num_gpus": 1}).bind(
        "tiny", n_slots=2, max_len=64,
        engine_kwargs={"kv_mode": "paged", "page_size": 16,
                       "prefill_chunk": 16})
    with pytest.raises(RuntimeError, match="failed to start.*no GPU"):
        serve.run(dep, timeout=120.0)
    assert "nogpu" not in serve.status()
