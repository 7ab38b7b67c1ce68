"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu for NVIDIA Hopper.

The JAX package ``ray_tpu`` stays the reference; this package mirrors its
layout and names so each counterpart is easy to find:

- ``models/gpt.py``       GPTConfig, parameter init, block helpers, the
                          training forward and ``loss_fn``
- ``models/decode.py``    rotary, QKV, MLP, LM head, token sampling
- ``models/paged_kv.py``  the paged KV pool and the chunked-prefill /
                          fused-decode programs
- ``ops/paged_attention.py``  the two paged-attention kernels (CUDA C++
                          for sm_90a, sources in ``ops/csrc/``) and their
                          plain PyTorch versions
- ``ops/attention.py``    flash attention forward and backward (three
                          CUDA kernels) as an autograd op, with their
                          plain versions
- ``serve/llm.py``        the continuous-batching LLMEngine (paged KV,
                          chunked prefill) and the LLMDeployment class
- ``serve/``              the serve plane: ``run``, handles, the HTTP
                          proxy, the controller and its autoscaler, the
                          KV page-set stores (in process and cluster);
                          ``state.py`` and ``slo.py`` read the cluster
- ``train/``              the single-device train step (``spmd.py``) and
                          an AdamW with optax's semantics (``optim.py``)
- ``profiling.py``, ``metrics.py``, ``tracing.py``, ``chaos.py``
                          the host-side event ring and metrics registry,
                          trace context and fault injection the engine
                          reports through (copies of the JAX package's)
- ``api.py``, ``core/``   the distributed runtime (tasks, actors, objects:
                          ``init``, ``remote``, ``get``, ``put``...), the
                          port's own copy of the JAX package's, with
                          ``num_gpus`` for the ``"GPU"`` resource and its
                          own environment prefix (``RAY_TPU_TORCH_``),
                          session directory and shared-memory names, so
                          the two runtimes never attach to each other

The package imports torch, numpy, cloudpickle and the standard library
only. Importing the package (and the runtime's daemons) imports no torch:
the API names below load lazily. Every entry point runs on ``cuda``
unless the caller passes ``device="cpu"``; without a GPU the default
raises instead of running on the CPU.
"""

__all__ = ["chaos", "metrics", "models", "ops", "profiling", "serve",
           "tracing", "train"]

_API_EXPORTS = (
    "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
    "free", "kill", "cancel", "get_actor", "method", "nodes",
    "cluster_resources", "available_resources", "ObjectRef",
    "get_runtime_context", "RayTaskError",
)


def __getattr__(name):
    if name in _API_EXPORTS:
        from ray_tpu_torch import api

        return getattr(api, name)
    if name in ("GetTimeoutError", "TaskCancelledError", "ActorDiedError",
                "ActorUnavailableError", "RayActorError"):
        from ray_tpu_torch import exceptions

        return getattr(exceptions, name)
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")
