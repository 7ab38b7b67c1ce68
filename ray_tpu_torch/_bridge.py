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


def _is_int8(a) -> bool:
    return np.asarray(a).dtype == np.int8


def params_from_jax(np_params: dict, cfg, device=None) -> dict:
    """JAX parameter dict (numpy leaves) → the port's parameters on
    ``device``: float leaves in ``cfg.param_dtype``, quantized planes
    (`quantize_params`) as ``torch.int8`` beside their ``{name}_scale``
    companions in fp32."""
    dev = resolve_device(device)
    out = {}
    for name, a in np_params.items():
        if _is_int8(a):
            dtype = torch.int8
        elif name.endswith("_scale") and _is_int8(
                np_params.get(name[:-len("_scale")], 0.0)):
            dtype = torch.float32
        else:
            dtype = cfg.param_dtype
        out[name] = _to_tensor(a, dtype, dev)
    return out


def pool_from_jax(np_pool: dict, cfg, device=None) -> dict:
    """JAX KV pool dict → the port's pool: the float pool's {"k", "v"}
    planes [L, P+1, ps, H, K] in ``cfg.dtype``; the int8 pool's int8
    planes with their bf16 {"k_scale", "v_scale"} planes [L, P+1]. Float
    planes may have any shape, so the JAX dense KV cache ({"k", "v"} of
    [L, B, T_max, H, K], `init_kv_cache`) carries over the same way."""
    dev = resolve_device(device)
    if set(np_pool) == {"k", "v", "k_scale", "v_scale"}:
        return {k: _to_tensor(v, torch.int8 if _is_int8(v) else
                              torch.bfloat16, dev)
                for k, v in np_pool.items()}
    if set(np_pool) != {"k", "v"}:
        raise ValueError(f"unknown pool planes {sorted(np_pool)}")
    return {k: _to_tensor(v, cfg.dtype, dev) for k, v in np_pool.items()}


__all__ = ["params_from_jax", "pool_from_jax"]
