"""GPT decoder: configuration, parameters, forward and loss (PyTorch).

Counterpart of ``ray_tpu/models/gpt.py`` (GPTConfig, param_specs,
init_params, QUANT_RULES, quant_axes, quantize_params, dequant,
weight_view, stack_block_params, _layer_norm, _rotary, _attention,
_block, forward_hidden, forward, loss_fn, num_params).
Parameters are a flat dict of tensors; block weights carry a leading
``layers`` axis exactly as in the JAX package, so a JAX checkpoint maps
one to one (``ray_tpu_torch/_bridge.py``). A Python loop over layer
slices takes the place of ``lax.scan``, and
``torch.utils.checkpoint(..., use_reentrant=False)`` the place of
``jax.checkpoint``. Training goes through ``loss_fn``; attention is the
plain fp32-softmax path (``attn_impl="xla"``) or the flash kernels
(``"flash"``, ``ray_tpu_torch/ops/attention.py``).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any

import torch
import torch.nn.functional as F

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
    remat: bool = False              # checkpoint each block (recompute in bwd)
    attn_impl: str = "xla"           # "xla" (plain) | "flash" (kernels)
    # Tile sizes of the JAX package's Pallas flash kernel, kept so the
    # presets carry over; the CUDA kernels tile by 64 and do not read them.
    attn_block_q: int = 1024
    attn_block_kv: int = 1024
    # Cross-entropy head chunking: logits and loss over sequence chunks of
    # this many tokens, each recomputed in the backward, so only one fp32
    # [B, chunk, V] logits block is live at a time. None = one full head.
    loss_chunk: int | None = None

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
        kw.setdefault("remat", True)
        kw.setdefault("attn_block_q", 512)
        kw.setdefault("attn_block_kv", 512)
        return cls(d_model=2560, n_layers=32, n_heads=32, d_ff=10240,
                   rotary_dim=64, tie_embeddings=False, **kw)

    @classmethod
    def gptj_6b(cls, **kw) -> "GPTConfig":
        kw.setdefault("remat", True)
        return cls(d_model=4096, n_layers=28, n_heads=16, d_ff=16384,
                   rotary_dim=64, tie_embeddings=False, **kw)

    @classmethod
    def opt_1_3b(cls, **kw) -> "GPTConfig":
        """OPT-1.3B-class decoder (the repo's serving target)."""
        kw.setdefault("remat", True)
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


# --------------------------------------------------------------------------
# int8 weight quantization (serving), as in the JAX package: symmetric
# per-output-channel int8 for the matmul planes only. Each rule names the
# CONTRACTION axes (reduced with keepdim), so a quantized leaf `name`
# gains an fp32 `name_scale` companion of the same rank. Norms,
# embeddings, biases and the LM head stay float.

QUANT_RULES: tuple = (
    (r"^w[qkv]$", (1,)),      # [L, D, H, K]: reduce D  → scale [L, 1, H, K]
    (r"^wo$", (1, 2)),        # [L, H, K, D]: reduce HK → scale [L, 1, 1, D]
    (r"^w_up$", (1,)),        # [L, D, F]:    reduce D  → scale [L, 1, F]
    (r"^w_down$", (1,)),      # [L, F, D]:    reduce F  → scale [L, 1, D]
)


def quant_axes(name: str):
    """Contraction axes for a quantizable leaf name, else None."""
    for pat, axes in QUANT_RULES:
        if re.search(pat, name):
            return axes
    return None


def quantize_params(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of the matmul
    weights (QUANT_RULES), from their fp32 values. Idempotent: int8
    leaves pass through with their existing scales."""
    out = dict(params)
    for name, w in params.items():
        axes = quant_axes(name)
        if axes is None or name.endswith("_scale") or w.dtype == torch.int8:
            continue
        w32 = w.float()
        absmax = w32.abs().amax(dim=axes, keepdim=True)
        scale = torch.clamp(absmax, min=1e-8) / 127.0
        out[name] = torch.clamp(torch.round(w32 / scale),
                                -127, 127).to(torch.int8)
        out[name + "_scale"] = scale
    return out


def dequant(plane: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """int8 plane → ``dtype``, the product taken in ``dtype`` as the JAX
    package takes it (an fp32 product cast afterwards rounds otherwise).
    Eager PyTorch materializes the float plane here, where XLA fuses it
    into the consuming matmul."""
    return plane.to(dtype) * scale.to(dtype)


def weight_view(tree: dict[str, torch.Tensor], name: str,
                dtype) -> torch.Tensor:
    """Compute-dtype view of weight `name`: dequantized when the stored
    plane is int8 (its ``{name}_scale`` companion rides in the same
    tree), a cast otherwise. ``Tensor.to`` returns the tensor itself when
    it already has ``dtype``, so weights cast once at load cost nothing
    here."""
    w = tree[name]
    if w.dtype == torch.int8:
        return dequant(w, tree[name + "_scale"], dtype)
    return w.to(dtype)


_BLOCK_KEYS = (
    "ln1_scale", "ln1_bias", "wq", "wk", "wv", "wo",
    "ln2_scale", "ln2_bias", "w_up", "b_up", "w_down", "b_down",
)


def stack_block_params(params: dict[str, torch.Tensor],
                       dtype=None) -> dict[str, torch.Tensor]:
    """Per-layer stacked leaf dict (`_BLOCK_KEYS` plus the ``_scale``
    companions of any int8 plane), float leaves cast to `dtype` when
    given; int8 planes stay compressed. Layer ``l`` of a leaf is
    ``leaf[l]`` (a view; a [L, 1, ...] scale slices to [1, ...], which
    broadcasts in `dequant`)."""
    stacked = {}
    for k in _BLOCK_KEYS:
        w = params[k]
        if w.dtype == torch.int8:
            stacked[k] = w
            stacked[k + "_scale"] = params[k + "_scale"]
        else:
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


# --------------------------------------------------------------------------
# Training forward and loss. The per-token pieces (_rotary_pos, _qkv,
# _attn_out, _mlp, _matmul_f32) live in decode.py, which imports this
# module, hence the import inside the functions.


def _rotary(x: torch.Tensor, rotary_dim: int, offset: int = 0) -> torch.Tensor:
    """Rotary over positions offset .. offset + S - 1 of x [B, S, H, K]."""
    from ray_tpu_torch.models.decode import _rotary_pos

    B, S = x.shape[0], x.shape[1]
    pos = torch.arange(offset, offset + S, device=x.device)
    return _rotary_pos(x, rotary_dim, pos[None, :].expand(B, S))


def _attention(q, k, v, cfg: GPTConfig):
    """Causal attention of q, k, v [B, S, H, K]: the flash kernels
    ("flash") or the plain fp32-softmax version ("xla")."""
    from ray_tpu_torch.ops.attention import flash_attention, reference_attention

    if cfg.attn_impl == "flash":
        return flash_attention(q, k, v, causal=True)
    if cfg.attn_impl == "xla":
        return reference_attention(q, k, v, causal=True)
    if cfg.attn_impl == "ring":
        raise NotImplementedError(
            "attn_impl='ring' (sequence-parallel ring attention) is not "
            "ported yet")
    raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")


def _block(x: torch.Tensor, layer: dict[str, torch.Tensor],
           cfg: GPTConfig) -> torch.Tensor:
    """One pre-norm transformer block. x: [B, S, D]."""
    from ray_tpu_torch.models.decode import _attn_out, _mlp, _qkv

    h = _layer_norm(x, layer["ln1_scale"], layer["ln1_bias"])
    q, k, v = _qkv(h, layer, cfg)
    q = _rotary(q, cfg.rotary_dim)
    k = _rotary(k, cfg.rotary_dim)
    x = x + _attn_out(_attention(q, k, v, cfg), layer, cfg)
    return _mlp(x, layer, cfg)


def _checkpointed(fn, *args):
    """fn(*args), its activations recomputed in the backward."""
    from torch.utils.checkpoint import checkpoint

    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def forward_hidden(params: dict[str, torch.Tensor], tokens: torch.Tensor,
                   cfg: GPTConfig) -> torch.Tensor:
    """tokens: [B, S] int → final-norm hidden states [B, S, D] (cfg.dtype).
    The embedding gathers from the table cast to cfg.dtype, so its
    gradient is a scatter-add in cfg.dtype, as in the JAX package."""
    x = params["wte"].to(cfg.dtype)[tokens.long()]
    stacked = stack_block_params(params)
    for i in range(cfg.n_layers):
        layer = {k: w[i] for k, w in stacked.items()}
        if cfg.remat:
            x = _checkpointed(_block, x, layer, cfg)
        else:
            x = _block(x, layer, cfg)
    return _layer_norm(x, params["ln_f_scale"], params["ln_f_bias"])


def _head_matrix(params, cfg: GPTConfig) -> torch.Tensor:
    head = params["lm_head"] if not cfg.tie_embeddings else params["wte"].T
    return head.to(cfg.dtype)


def _logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """x [..., D] @ head [D, V] → fp32 logits [..., V] from fp32 sums."""
    from ray_tpu_torch.models.decode import _matmul_f32

    out = _matmul_f32(x.reshape(-1, x.shape[-1]), head)
    return out.reshape(*x.shape[:-1], head.shape[1])


def forward(params: dict[str, torch.Tensor], tokens: torch.Tensor,
            cfg: GPTConfig) -> torch.Tensor:
    """tokens: [B, S] int → logits [B, S, V] (fp32)."""
    return _logits(forward_hidden(params, tokens, cfg),
                   _head_matrix(params, cfg))


def _ce_sum(x, head, targets):
    """Summed next-token cross-entropy of one chunk (fp32 logits)."""
    logits = _logits(x, head)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1).long(), reduction="sum")


def loss_fn(params: dict[str, torch.Tensor], tokens: torch.Tensor,
            targets: torch.Tensor, cfg: GPTConfig) -> torch.Tensor:
    """Mean next-token cross-entropy. tokens/targets: [B, S] int.

    With cfg.loss_chunk set, the vocab projection and CE run chunk by
    chunk over the sequence, each chunk checkpointed: only one fp32
    [B, chunk, V] logits block is live at a time, forward and backward
    (the chunk recomputes its logits in the backward; the head gradient
    accumulates across chunks)."""
    x = forward_hidden(params, tokens, cfg)
    head = _head_matrix(params, cfg)
    B, S = tokens.shape
    if cfg.loss_chunk is None or S <= cfg.loss_chunk:
        logits = _logits(x, head)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               targets.reshape(-1).long())
    C = cfg.loss_chunk
    if S % C != 0:
        raise ValueError(f"seq len {S} not divisible by loss_chunk {C}")
    total = torch.zeros((), device=x.device, dtype=torch.float32)
    for c in range(0, S, C):
        total = total + _checkpointed(_ce_sum, x[:, c:c + C], head,
                                      targets[:, c:c + C])
    return total / (B * S)


def num_params(cfg: GPTConfig) -> int:
    return sum(math.prod(s["shape"]) for s in param_specs(cfg).values())


__all__ = ["GPTConfig", "param_specs", "init_params", "QUANT_RULES",
           "quant_axes", "quantize_params", "dequant", "weight_view",
           "stack_block_params", "forward_hidden", "forward", "loss_fn",
           "num_params"]
