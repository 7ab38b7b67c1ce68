"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu for NVIDIA Hopper.

The JAX package ``ray_tpu`` stays the reference; this package mirrors its
layout and names so each counterpart is easy to find:

- ``models/gpt.py``       GPTConfig, parameter init, block helpers
- ``models/decode.py``    rotary, QKV, MLP, LM head, token sampling
- ``models/paged_kv.py``  the paged KV pool and the chunked-prefill /
                          fused-decode programs
- ``ops/paged_attention.py``  the two paged-attention kernels (CUDA C++
                          for sm_90a, sources in ``ops/csrc/``) and their
                          plain PyTorch versions
- ``serve/llm.py``        the continuous-batching LLMEngine (paged KV,
                          chunked prefill)

The package imports torch, numpy and the standard library only. Every
entry point runs on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU the default raises instead of running on the CPU.
"""

__all__ = ["models", "ops", "serve"]
