"""Per-token transformer pieces shared by the paged programs (PyTorch).

Counterpart of ``ray_tpu/models/decode.py``: `_rotary_pos`, `_qkv`,
`_mlp`, `_head` and `sample_token`. Three details carry the reference's
numerics and are pinned by tests/test_torch_model.py:

- rotary rotates INTERLEAVED even/odd pairs of the leading
  ``rotary_dim`` dims (not the half-split ``rotate_half`` layout), with
  sin/cos computed in fp32 and cast to the activation dtype;
- GELU is the tanh form (``jax.nn.gelu``'s default);
- the LM head returns fp32 logits accumulated in fp32 (a bf16 matmul
  would round logits to bf16 and flip near-tie argmaxes).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ray_tpu_torch.models.gpt import _layer_norm, weight_view


def _rotary_pos(x: torch.Tensor, rotary_dim: int,
                pos: torch.Tensor) -> torch.Tensor:
    """Rotary with explicit per-row positions. x: [B, S, H, K];
    pos: [B, S] integer."""
    rot, rest = x[..., :rotary_dim], x[..., rotary_dim:]
    exps = torch.arange(0, rotary_dim, 2, device=x.device,
                        dtype=torch.float32) / rotary_dim
    inv_freq = 1.0 / torch.pow(10000.0, exps)
    ang = pos.to(torch.float32)[..., None] * inv_freq       # [B, S, R/2]
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)          # [B, S, 1, R/2]
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = rot[..., 0::2], rot[..., 1::2]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    rot = torch.stack([out1, out2], dim=-1).reshape(rot.shape)
    return torch.cat([rot, rest], dim=-1)


def _proj(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h [..., D] @ w [D, *out] → [..., *out] as one 2-D matmul."""
    D = w.shape[0]
    out = h.reshape(-1, D) @ w.reshape(D, -1)
    return out.reshape(*h.shape[:-1], *w.shape[1:])


def _qkv(h, layer, cfg):
    q = _proj(h, weight_view(layer, "wq", cfg.dtype))       # [B, S, H, K]
    k = _proj(h, weight_view(layer, "wk", cfg.dtype))
    v = _proj(h, weight_view(layer, "wv", cfg.dtype))
    return q, k, v


def _attn_out(attn: torch.Tensor, layer, cfg) -> torch.Tensor:
    """attn [..., H, K] @ wo [H, K, D] → [..., D]."""
    wo = weight_view(layer, "wo", cfg.dtype)
    H, K, D = wo.shape
    out = attn.reshape(-1, H * K) @ wo.reshape(H * K, D)
    return out.reshape(*attn.shape[:-2], D)


def _mlp(x, layer, cfg):
    """Feed-forward block with the tanh GELU."""
    h = _layer_norm(x, layer["ln2_scale"], layer["ln2_bias"])
    up = F.gelu(_proj(h, weight_view(layer, "w_up", cfg.dtype))
                + layer["b_up"].to(cfg.dtype), approximate="tanh")
    down = _proj(up, weight_view(layer, "w_down", cfg.dtype))
    return x + (down + layer["b_down"].to(cfg.dtype))


class _MatmulF32(torch.autograd.Function):
    """[M, D] @ [D, N] with fp32 accumulation AND an fp32 result. On
    CUDA the GEMM writes fp32 straight from its fp32 accumulators; on
    the CPU both operands are upcast (the same products — bf16 values
    are exact in fp32). ``torch.mm(..., out_dtype=)`` has no derivative,
    so the backward is written here: the fp32 cotangent is rounded to the
    operands' dtype and both products run in that dtype with fp32 sums,
    as every other bf16 product's backward in the model does (and as a
    TPU runs an fp32-by-bf16 product at default precision)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.is_cuda and x.dtype != torch.float32:
            return torch.mm(x, w, out_dtype=torch.float32)
        return x.float() @ w.float()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = g @ w.t() if ctx.needs_input_grad[0] else None
        gw = x.t() @ g if ctx.needs_input_grad[1] else None
        return gx, gw


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[M, D] @ [D, N] → fp32 [M, N] from fp32 sums, differentiable."""
    return _MatmulF32.apply(x, w)


def _head(params, cfg, x):
    """Final layer norm + LM head → fp32 logits [..., V]."""
    x = _layer_norm(x, params["ln_f_scale"], params["ln_f_bias"])
    head = params["lm_head"] if not cfg.tie_embeddings else params["wte"].T
    head = head.to(cfg.dtype)
    logits = _matmul_f32(x.reshape(-1, x.shape[-1]), head)
    return logits.reshape(*x.shape[:-1], head.shape[1])


def sample_token(logits: torch.Tensor, *, temperature: float = 0.0,
                 top_k: int = 0,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """Greedy (temperature=0) or temperature/top-k sampling.
    logits: [V] or [B, V] fp32 tensor."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    scaled = logits / temperature
    if top_k > 0:
        kth = torch.sort(scaled, dim=-1).values[..., -top_k][..., None]
        scaled = torch.where(scaled < kth,
                             torch.full_like(scaled, -1e30), scaled)
    if generator is None:
        raise ValueError("sampling needs a torch.Generator")
    return _categorical(scaled, generator)


def _gumbel(u: torch.Tensor) -> torch.Tensor:
    """Gumbel noise -log(-log(u)) from uniforms u in [0, 1), with u first
    raised to the smallest normal float32, as `jax.random.gumbel` draws
    it from [tiny, 1): a draw of exactly 0 then gives about -4.47, never
    -inf, so no token with a finite logit is ever excluded."""
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _categorical(scaled: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(scaled) by the Gumbel-max trick:
    argmax(scaled + Gumbel noise), the noise from ``generator``."""
    u = torch.rand(scaled.shape, generator=generator,
                   device=scaled.device, dtype=torch.float32)
    return torch.argmax(scaled.float() + _gumbel(u), dim=-1)


__all__ = ["sample_token"]
