"""Llama-family decoder: configuration, parameters, forward and loss
(PyTorch).

Counterpart of ``ray_tpu/models/llama.py`` (LlamaConfig, param_specs,
logical_axes, init_params, _rms_norm, _rotary, _gqa_attention, _block,
forward, loss_fn, num_params): RMSNorm (no bias, no mean), a SwiGLU MLP
and grouped-query attention (n_kv_heads < n_heads), rotary over the full
head dim. Parameters are a flat dict of tensors whose block weights
carry a leading ``layers`` axis exactly as in the JAX package, so a JAX
checkpoint maps one to one (``ray_tpu_torch/_bridge.py``
`params_from_jax`). As in ``models/gpt.py``, a Python loop over layer
slices takes the place of ``lax.scan`` and ``torch.utils.checkpoint``
the place of ``jax.checkpoint``.

Attention is plain (``attn_impl="xla"``), the flash kernels
(``"flash"``) or ring attention over an sp mesh (``"ring"``); each kv
head is repeated in place to its group of query heads first
(``repeat_interleave``, the counterpart of ``jnp.repeat(k, groups,
axis=2)``: a tiled copy would give the same shapes and the wrong heads).
The reference's ring path takes ``mesh=None`` without a check; the
port's raises the ``ValueError`` GPT's ring path raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8              # GQA: kv heads < query heads
    d_ff: int = 11008                # SwiGLU hidden
    max_seq: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = False
    attn_impl: str = "xla"           # "xla" | "flash" | "ring"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def llama2_7b(cls, **kw) -> "LlamaConfig":
        kw.setdefault("remat", True)
        return cls(d_model=4096, n_layers=32, n_heads=32, n_kv_heads=32,
                   d_ff=11008, **kw)

    @classmethod
    def llama3_8b(cls, **kw) -> "LlamaConfig":
        kw.setdefault("vocab_size", 128256)
        kw.setdefault("rope_theta", 500000.0)
        kw.setdefault("remat", True)
        return cls(d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
                   d_ff=14336, **kw)

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        """For tests on the CPU."""
        kw.setdefault("vocab_size", 256)
        kw.setdefault("max_seq", 128)
        kw.setdefault("d_model", 64)
        kw.setdefault("n_layers", 2)
        kw.setdefault("n_heads", 8)
        kw.setdefault("n_kv_heads", 4)
        kw.setdefault("d_ff", 128)
        return cls(**kw)


def param_specs(cfg: LlamaConfig) -> dict[str, dict[str, Any]]:
    """name → {shape, axes, init, scale}; the JAX package's table."""
    D, H, KV, K, F_, L, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.head_dim, cfg.d_ff, cfg.n_layers,
                             cfg.vocab_size)
    norm = lambda *s: {"init": "normal", "scale": 0.02, "shape": s}
    resid = lambda *s: {"init": "normal",
                        "scale": 0.02 / math.sqrt(2 * L), "shape": s}
    ones = lambda *s: {"init": "ones", "shape": s}
    return {
        "tok_emb": {**norm(V, D), "axes": ("vocab", "embed")},
        "norm_f": {**ones(D), "axes": ("embed",)},
        "lm_head": {**norm(D, V), "axes": ("embed", "vocab")},
        "attn_norm": {**ones(L, D), "axes": ("layers", "embed")},
        "wq": {**norm(L, D, H, K), "axes": ("layers", "embed", "heads", "kv")},
        "wk": {**norm(L, D, KV, K),
               "axes": ("layers", "embed", "kv_heads", "kv")},
        "wv": {**norm(L, D, KV, K),
               "axes": ("layers", "embed", "kv_heads", "kv")},
        "wo": {**resid(L, H, K, D), "axes": ("layers", "heads", "kv", "embed")},
        "mlp_norm": {**ones(L, D), "axes": ("layers", "embed")},
        "w_gate": {**norm(L, D, F_), "axes": ("layers", "embed", "mlp")},
        "w_up": {**norm(L, D, F_), "axes": ("layers", "embed", "mlp")},
        "w_down": {**resid(L, F_, D), "axes": ("layers", "mlp", "embed")},
    }


def logical_axes(cfg: LlamaConfig) -> dict[str, tuple]:
    return {k: v["axes"] for k, v in param_specs(cfg).items()}


def init_params(cfg: LlamaConfig, generator: torch.Generator | None = None,
                device=None) -> dict[str, torch.Tensor]:
    """Random parameters from ``generator`` (a torch.Generator on
    ``device``; a fresh one seeded 0 when None), drawn in
    ``cfg.param_dtype`` as the JAX ``init_params`` draws them. Same
    shapes and scales; the numbers differ (another RNG)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    params = {}
    for name, spec in sorted(param_specs(cfg).items()):
        if spec["init"] == "normal":
            w = torch.randn(spec["shape"], generator=generator, device=dev,
                            dtype=cfg.param_dtype)
            params[name] = w.mul_(spec["scale"])
        else:
            params[name] = torch.ones(spec["shape"], device=dev,
                                      dtype=cfg.param_dtype)
    return params


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in fp32 (``rsqrt`` of the mean square plus eps), cast back."""
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (y * scale).to(x.dtype)


def _rotary(x: torch.Tensor, theta: float, offset: int = 0) -> torch.Tensor:
    """Full-head-dim rotary over x [..., S, H, K]: interleaved pairs
    (x[..., 0::2], x[..., 1::2]), angles in fp32, sin and cos cast to
    x's dtype before the products."""
    S, K = x.shape[-3], x.shape[-1]
    exps = torch.arange(0, K, 2, device=x.device, dtype=torch.float32) / K
    inv_freq = 1.0 / torch.pow(theta, exps)
    pos = torch.arange(offset, offset + S, device=x.device,
                       dtype=torch.float32)[:, None] * inv_freq[None, :]
    sin = torch.sin(pos)[:, None, :].to(x.dtype)             # [S, 1, K/2]
    cos = torch.cos(pos)[:, None, :].to(x.dtype)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape)


def _repeat_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, T, KV, K] → [B, T, KV·groups, K], each kv head repeated in
    place (head h of the result is kv head h // groups)."""
    return torch.repeat_interleave(x, groups, dim=2)


def _gqa_attention(q, k, v, cfg: LlamaConfig, *, causal_offset: int = 0,
                   mesh=None):
    """q [B, S, H, K]; k, v [B, T, KV, K] with KV | H. Each kv head is
    repeated in place to its group of query heads, then the configured
    attention runs: flash, ring (over ``mesh``) or plain fp32 softmax at
    a causal offset."""
    groups = cfg.n_heads // cfg.n_kv_heads
    if groups > 1:
        k, v = _repeat_kv(k, groups), _repeat_kv(v, groups)
    if cfg.attn_impl == "flash" and causal_offset == 0:
        from ray_tpu_torch.ops.attention import flash_attention

        return flash_attention(q, k, v, causal=True)
    if cfg.attn_impl == "ring" and causal_offset == 0:
        from ray_tpu_torch.models.gpt import causal_ring_attention

        return causal_ring_attention(q, k, v, mesh)
    S, T = q.shape[-3], k.shape[-3]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    logits = torch.einsum("bshk,bthk->bhst", q.float(), k.float()) * scale
    qpos = torch.arange(S, device=q.device)[:, None] + causal_offset
    mask = qpos >= torch.arange(T, device=q.device)[None, :]
    logits = torch.where(mask[None, None], logits,
                         torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthk->bshk", probs, v)


def _block(x, layer, cfg: LlamaConfig, mesh=None):
    """One pre-norm block: GQA attention, then the SwiGLU MLP
    (``silu(gate) * up``). x: [B, S, D]."""
    from ray_tpu_torch.models.decode import _proj

    w = lambda name: layer[name].to(cfg.dtype)
    h = _rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    q = _rotary(_proj(h, w("wq")), cfg.rope_theta)
    k = _rotary(_proj(h, w("wk")), cfg.rope_theta)
    v = _proj(h, w("wv"))
    attn = _gqa_attention(q, k, v, cfg, mesh=mesh)
    x = x + _proj(attn.flatten(-2), w("wo").flatten(0, 1))
    h = _rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    gate = _proj(h, w("w_gate"))
    up = _proj(h, w("w_up"))
    return x + _proj(F.silu(gate) * up, w("w_down"))


_BLOCK_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
               "w_gate", "w_up", "w_down")


def forward(params, tokens, cfg: LlamaConfig, mesh=None) -> torch.Tensor:
    """tokens [B, S] int → logits [B, S, V] fp32 (from fp32 sums)."""
    from ray_tpu_torch.models.gpt import _checkpointed, _logits, unbind_layers

    x = params["tok_emb"].to(cfg.dtype)[tokens.long()]
    for layer in unbind_layers({k: params[k] for k in _BLOCK_KEYS}):
        if cfg.remat:
            x = _checkpointed(_block, x, layer, cfg, mesh)
        else:
            x = _block(x, layer, cfg, mesh)
    x = _rms_norm(x, params["norm_f"], cfg.norm_eps)
    return _logits(x, params["lm_head"].to(cfg.dtype))


def loss_fn(params, tokens, targets, cfg: LlamaConfig,
            mesh=None) -> torch.Tensor:
    """Mean next-token cross-entropy: logsumexp - gold logit."""
    logits = forward(params, tokens, cfg, mesh)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return (logz - gold).mean()


def num_params(cfg: LlamaConfig) -> int:
    return sum(math.prod(s["shape"]) for s in param_specs(cfg).values())


__all__ = ["LlamaConfig", "param_specs", "logical_axes", "init_params",
           "forward", "loss_fn", "num_params"]
