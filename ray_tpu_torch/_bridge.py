"""Weight and KV-pool bridge from the JAX package's numpy arrays.

Takes plain numpy arrays (``np.asarray`` of a JAX pytree leaf) and
never imports JAX: the caller does the device→host pull. bf16 leaves
arrive as ``ml_dtypes.bfloat16`` arrays, which torch cannot read
directly; they go through float32 (bf16 → fp32 → bf16 is exact).
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device


def _to_tensor(a, dtype, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    t = torch.from_numpy(np.array(arr, copy=True))   # owned, writable
    return t.to(device=device, dtype=dtype)


def params_from_jax(np_params: dict, cfg, device=None) -> dict:
    """JAX parameter dict (numpy leaves) → the port's parameters, in
    ``cfg.param_dtype`` on ``device``. int8 planes are not ported."""
    dev = resolve_device(device)
    out = {}
    for name, a in np_params.items():
        if np.asarray(a).dtype == np.int8:
            raise NotImplementedError("int8 weights not yet ported")
        out[name] = _to_tensor(a, cfg.param_dtype, dev)
    return out


def pool_from_jax(np_pool: dict, cfg, device=None) -> dict:
    """JAX KV pool dict ({"k", "v"} numpy planes [L, P+1, ps, H, K]) →
    the port's pool in ``cfg.dtype``. int8 pools are not ported."""
    dev = resolve_device(device)
    if set(np_pool) != {"k", "v"}:
        raise NotImplementedError("int8 pools not yet ported")
    return {k: _to_tensor(v, cfg.dtype, dev) for k, v in np_pool.items()}


__all__ = ["params_from_jax", "pool_from_jax"]
