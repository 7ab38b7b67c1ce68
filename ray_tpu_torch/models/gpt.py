"""GPT decoder configuration, parameters and block helpers (PyTorch).

Counterpart of ``ray_tpu/models/gpt.py`` (GPTConfig, param_specs,
init_params, weight_view, stack_block_params, _layer_norm). Parameters
are a flat dict of tensors; block weights carry a leading ``layers``
axis exactly as in the JAX package, so a JAX checkpoint maps one to one
(``ray_tpu_torch/_bridge.py``). A Python loop over layer slices takes
the place of ``lax.scan``.

Training-only fields of the JAX config (remat, attention impl and tile
sizes, loss chunking) are not part of this serving slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ray_tpu_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304          # GPT-2 BPE rounded up to a multiple of 128
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_seq: int = 1024
    rotary_dim: int = 64             # per-head dims that get rotary; <= head_dim
    dtype: Any = torch.bfloat16      # activation/compute dtype
    param_dtype: Any = torch.float32
    tie_embeddings: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def gpt2_124m(cls, **kw) -> "GPTConfig":
        return cls(d_model=768, n_layers=12, n_heads=12, d_ff=3072, **kw)

    @classmethod
    def gpt2_350m(cls, **kw) -> "GPTConfig":
        return cls(d_model=1024, n_layers=24, n_heads=16, d_ff=4096, **kw)

    @classmethod
    def gpt2_2_7b(cls, **kw) -> "GPTConfig":
        return cls(d_model=2560, n_layers=32, n_heads=32, d_ff=10240,
                   rotary_dim=64, tie_embeddings=False, **kw)

    @classmethod
    def gptj_6b(cls, **kw) -> "GPTConfig":
        return cls(d_model=4096, n_layers=28, n_heads=16, d_ff=16384,
                   rotary_dim=64, tie_embeddings=False, **kw)

    @classmethod
    def opt_1_3b(cls, **kw) -> "GPTConfig":
        """OPT-1.3B-class decoder (the repo's serving target)."""
        return cls(d_model=2048, n_layers=24, n_heads=32, d_ff=8192,
                   rotary_dim=64, tie_embeddings=False, **kw)

    @classmethod
    def tiny(cls, **kw) -> "GPTConfig":
        """For tests on the CPU."""
        kw.setdefault("vocab_size", 256)
        kw.setdefault("max_seq", 128)
        kw.setdefault("rotary_dim", 4)
        kw.setdefault("d_model", 64)
        kw.setdefault("n_layers", 2)
        kw.setdefault("n_heads", 8)
        kw.setdefault("d_ff", 128)
        return cls(**kw)

    @classmethod
    def tiny_untied(cls, **kw) -> "GPTConfig":
        """Tiny with the big-model head/embedding layout (gptj/opt style)."""
        kw.setdefault("tie_embeddings", False)
        return cls.tiny(**kw)

    _REGISTRY = ("gpt2_124m", "gpt2_350m", "gpt2_2_7b", "gptj_6b",
                 "opt_1_3b", "tiny", "tiny_untied")

    @classmethod
    def by_name(cls, name: str, **kw) -> "GPTConfig":
        if name not in cls._REGISTRY:
            raise KeyError(f"unknown model {name!r}; one of {cls._REGISTRY}")
        return getattr(cls, name)(**kw)


def param_specs(cfg: GPTConfig) -> dict[str, dict[str, Any]]:
    """name → {shape, init, scale}; the same table as the JAX package.

    Block params carry a leading `layers` axis.
    """
    D, H, K, F, L, V = (
        cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.n_layers,
        cfg.vocab_size,
    )
    norm = lambda *s: {"init": "normal", "scale": 0.02, "shape": s}
    resid = lambda *s: {"init": "normal", "scale": 0.02 / math.sqrt(2 * L),
                        "shape": s}
    ones = lambda *s: {"init": "ones", "shape": s}
    zeros = lambda *s: {"init": "zeros", "shape": s}

    specs: dict[str, dict[str, Any]] = {
        "wte": norm(V, D),
        "ln_f_scale": ones(D),
        "ln_f_bias": zeros(D),
        "ln1_scale": ones(L, D),
        "ln1_bias": zeros(L, D),
        "wq": norm(L, D, H, K),
        "wk": norm(L, D, H, K),
        "wv": norm(L, D, H, K),
        "wo": resid(L, H, K, D),
        "ln2_scale": ones(L, D),
        "ln2_bias": zeros(L, D),
        "w_up": norm(L, D, F),
        "b_up": zeros(L, F),
        "w_down": resid(L, F, D),
        "b_down": zeros(L, D),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = norm(D, V)
    return specs


def init_params(cfg: GPTConfig, generator: torch.Generator | None = None,
                device=None) -> dict[str, torch.Tensor]:
    """Random parameters from ``generator`` (a torch.Generator on
    ``device``; a fresh one seeded 0 when None). Same shapes, scales and
    dtypes as the JAX ``init_params``; the numbers differ (another RNG)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    params = {}
    for name, spec in sorted(param_specs(cfg).items()):
        shape = spec["shape"]
        if spec["init"] == "normal":
            w = torch.randn(shape, generator=generator, device=dev,
                            dtype=cfg.param_dtype)
            params[name] = w.mul_(spec["scale"])
        elif spec["init"] == "ones":
            params[name] = torch.ones(shape, device=dev,
                                      dtype=cfg.param_dtype)
        else:
            params[name] = torch.zeros(shape, device=dev,
                                       dtype=cfg.param_dtype)
    return params


def weight_view(tree: dict[str, torch.Tensor], name: str,
                dtype) -> torch.Tensor:
    """Compute-dtype view of weight `name` (float planes only; int8
    planes are not ported yet). ``Tensor.to`` returns the tensor itself
    when it already has ``dtype``, so weights cast once at load cost
    nothing here."""
    w = tree[name]
    if w.dtype == torch.int8:
        raise NotImplementedError("int8 weights not yet ported")
    return w.to(dtype)


_BLOCK_KEYS = (
    "ln1_scale", "ln1_bias", "wq", "wk", "wv", "wo",
    "ln2_scale", "ln2_bias", "w_up", "b_up", "w_down", "b_down",
)


def stack_block_params(params: dict[str, torch.Tensor],
                       dtype=None) -> dict[str, torch.Tensor]:
    """Per-layer stacked leaf dict (`_BLOCK_KEYS`), float leaves cast to
    `dtype` when given. Layer ``l`` of a leaf is ``leaf[l]`` (a view)."""
    stacked = {}
    for k in _BLOCK_KEYS:
        w = params[k]
        if w.dtype == torch.int8:
            raise NotImplementedError("int8 weights not yet ported")
        stacked[k] = w if dtype is None else w.to(dtype)
    return stacked


def _layer_norm(x: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """fp32 layer norm with the POPULATION variance and eps 1e-5, as the
    JAX package computes it (``torch.var`` would be unbiased)."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + 1e-5)
    return (y * scale + bias).to(x.dtype)


__all__ = ["GPTConfig", "param_specs", "init_params", "weight_view",
           "stack_block_params"]
