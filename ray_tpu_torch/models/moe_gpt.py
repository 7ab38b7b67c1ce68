"""MoE-GPT: the Mixtral-class sparse decoder family (PyTorch).

Counterpart of ``ray_tpu/models/moe_gpt.py`` (`MoEGPTConfig`,
`param_specs`, `logical_axes`, `_as_gpt_cfg`, `init_params`,
`_moe_mlp_layer`, `_moe_block`, `forward_hidden`, `forward`, `loss_fn`,
`num_params`): every block's dense MLP is a top-2 MoE layer
(``ops/moe.py``). The attention half is the port's GPT
(``models/gpt.py``), so ``attn_impl="flash"`` reaches the CUDA flash
kernels on CUDA tensors and ``"ring"`` runs over the sp ``mesh``, as for
GPT. The expert stacks [L, E, ...] carry the logical ``expert`` axis;
``ep_mesh`` (``parallel/mesh.py::device_mesh(n, axis="ep")``) runs each
layer's experts over the ep shards, with the stacks placed on their
shards by ``models/partition.py::place_on_axis`` (``moe_w_up@s``, ...)
or whole. The load-balance aux loss is summed over the layers and its
mean joins the CE loss with weight ``aux_coef``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch._params import init_from_specs
from ray_tpu_torch.models import gpt as _gpt
from ray_tpu_torch.ops.moe import MoEConfig


@dataclasses.dataclass(frozen=True)
class MoEGPTConfig:
    vocab_size: int = 50304
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072                  # per-expert FFN width
    n_experts: int = 8
    capacity_factor: float = 1.5
    aux_coef: float = 0.01            # load-balance loss weight
    max_seq: int = 1024
    rotary_dim: int = 64
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    tie_embeddings: bool = True
    remat: bool = False
    attn_impl: str = "xla"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def moe_cfg(self) -> MoEConfig:
        return MoEConfig(self.d_model, self.d_ff, self.n_experts,
                         capacity_factor=self.capacity_factor,
                         dtype=self.dtype, param_dtype=self.param_dtype)

    @classmethod
    def tiny(cls, **kw) -> "MoEGPTConfig":
        kw.setdefault("vocab_size", 256)
        kw.setdefault("max_seq", 128)
        kw.setdefault("rotary_dim", 4)
        kw.setdefault("d_model", 64)
        kw.setdefault("n_layers", 2)
        kw.setdefault("n_heads", 8)
        kw.setdefault("d_ff", 128)
        kw.setdefault("n_experts", 4)
        return cls(**kw)

    @classmethod
    def moe_8x350m(cls, **kw) -> "MoEGPTConfig":
        """~1.76B total parameters, top-2 of 8 experts per token."""
        kw.setdefault("remat", True)
        return cls(d_model=1024, n_layers=24, n_heads=16, d_ff=4096,
                   n_experts=8, **kw)

    _REGISTRY = ("tiny", "moe_8x350m")

    @classmethod
    def by_name(cls, name: str, **kw) -> "MoEGPTConfig":
        if name not in cls._REGISTRY:
            raise KeyError(f"unknown model {name!r}; one of {cls._REGISTRY}")
        return getattr(cls, name)(**kw)


def param_specs(cfg: MoEGPTConfig) -> dict[str, dict[str, Any]]:
    """Attention and embedding specs follow gpt.py; the MLP is replaced
    by per-layer expert stacks [L, E, ...] with the `expert` logical
    axis."""
    D, F_, L, E = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.n_experts
    base = _gpt.param_specs(_as_gpt_cfg(cfg))
    for k in ("w_up", "b_up", "w_down", "b_down"):
        del base[k]
    norm = lambda *s: {"init": "normal", "scale": 0.02, "shape": s}
    resid = lambda *s: {"init": "normal",
                        "scale": 0.02 / math.sqrt(2 * L), "shape": s}
    zeros = lambda *s: {"init": "zeros", "shape": s}
    base.update({
        "wg": {**norm(L, D, E), "axes": ("layers", "embed", None)},
        "moe_w_up": {**norm(L, E, D, F_),
                     "axes": ("layers", "expert", "embed", "mlp")},
        "moe_b_up": {**zeros(L, E, F_), "axes": ("layers", "expert", "mlp")},
        "moe_w_down": {**resid(L, E, F_, D),
                       "axes": ("layers", "expert", "mlp", "embed")},
        "moe_b_down": {**zeros(L, E, D),
                       "axes": ("layers", "expert", "embed")},
    })
    return base


def logical_axes(cfg: MoEGPTConfig) -> dict[str, tuple]:
    return {k: v["axes"] for k, v in param_specs(cfg).items()}


def _as_gpt_cfg(cfg: MoEGPTConfig) -> _gpt.GPTConfig:
    """The attention and embedding half of the model is exactly GPT."""
    return _gpt.GPTConfig(
        vocab_size=cfg.vocab_size, d_model=cfg.d_model,
        n_layers=cfg.n_layers, n_heads=cfg.n_heads, d_ff=cfg.d_ff,
        max_seq=cfg.max_seq, rotary_dim=cfg.rotary_dim, dtype=cfg.dtype,
        param_dtype=cfg.param_dtype, tie_embeddings=cfg.tie_embeddings,
        remat=cfg.remat, attn_impl=cfg.attn_impl)


def init_params(cfg: MoEGPTConfig, generator: torch.Generator | None = None,
                device=None) -> dict[str, torch.Tensor]:
    """Random parameters from ``generator`` on ``device`` (CUDA unless
    the caller asks for the CPU): the reference's shapes, scales and
    dtypes; the numbers differ (another RNG)."""
    return init_from_specs(param_specs(cfg), cfg.param_dtype, generator,
                           resolve_device(device))


_ATTN_KEYS = ("ln1_scale", "ln1_bias", "wq", "wk", "wv", "wo",
              "ln2_scale", "ln2_bias")
_MOE_KEYS = ("wg", "moe_w_up", "moe_b_up", "moe_w_down", "moe_b_down")


def _moe_mlp_layer(h: torch.Tensor, layer: dict, cfg: MoEGPTConfig,
                   ep_mesh=None):
    """h [B, S, D] (post-ln2) → (y [B, S, D], aux scalar): this layer's
    expert stack (whole, or its ``@s`` shards) through ops.moe.moe_mlp."""
    from ray_tpu_torch.ops.moe import moe_mlp

    params = {k.removeprefix("moe_"): w for k, w in layer.items()
              if k == "wg" or k.startswith("moe_")}
    return moe_mlp(h, params, cfg.moe_cfg(), mesh=ep_mesh)


def _moe_block(x, layer, cfg: MoEGPTConfig, mesh=None, ep_mesh=None):
    from ray_tpu_torch.models.decode import _attn_out, _qkv

    gcfg = _as_gpt_cfg(cfg)
    h = _gpt._layer_norm(x, layer["ln1_scale"], layer["ln1_bias"])
    q, k, v = _qkv(h, layer, gcfg)
    q = _gpt._rotary(q, cfg.rotary_dim)
    k = _gpt._rotary(k, cfg.rotary_dim)
    x = x + _attn_out(_gpt._attention(q, k, v, gcfg, mesh), layer, gcfg)
    h = _gpt._layer_norm(x, layer["ln2_scale"], layer["ln2_bias"])
    y, aux = _moe_mlp_layer(h, layer, cfg, ep_mesh)
    return x + y, aux


def forward_hidden(params, tokens, cfg: MoEGPTConfig, mesh=None,
                   ep_mesh=None):
    """tokens [B, S] int → (final-norm hidden [B, S, D], the mean aux
    loss over the layers). ``mesh`` is the sp mesh of
    ``attn_impl="ring"``; ``ep_mesh`` the expert-parallel mesh."""
    x = params["wte"].to(cfg.dtype)[tokens.long()]
    blocks = _ATTN_KEYS + _MOE_KEYS
    stacked = {k: w for k, w in params.items()
               if k.partition("@")[0] in blocks}
    aux_sum = torch.zeros((), device=x.device, dtype=torch.float32)
    for layer in _gpt.unbind_layers(stacked):
        if cfg.remat:
            x, aux = _gpt._checkpointed(_moe_block, x, layer, cfg, mesh,
                                        ep_mesh)
        else:
            x, aux = _moe_block(x, layer, cfg, mesh, ep_mesh)
        aux_sum = aux_sum + aux
    x = _gpt._layer_norm(x, params["ln_f_scale"], params["ln_f_bias"])
    return x, aux_sum / cfg.n_layers


def forward(params, tokens, cfg: MoEGPTConfig, mesh=None, ep_mesh=None):
    """tokens [B, S] → (logits [B, S, V] fp32, aux scalar)."""
    x, aux = forward_hidden(params, tokens, cfg, mesh, ep_mesh)
    return _gpt._logits(x, _gpt._head_matrix(params, cfg)), aux


def loss_fn(params, tokens, targets, cfg: MoEGPTConfig, mesh=None,
            ep_mesh=None):
    """Next-token CE + aux_coef × the load-balance loss."""
    logits, aux = forward(params, tokens, cfg, mesh, ep_mesh)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         targets.reshape(-1).long())
    return ce + cfg.aux_coef * aux


def num_params(cfg: MoEGPTConfig) -> tuple[int, int]:
    """→ (total, active-per-token) parameter counts. Active counts top-2
    of E experts per MoE layer."""
    specs = param_specs(cfg)
    total = sum(math.prod(s["shape"]) for s in specs.values())
    expert = sum(math.prod(specs[k]["shape"])
                 for k in ("moe_w_up", "moe_b_up", "moe_w_down",
                           "moe_b_down"))
    active = total - expert + (expert * 2) // cfg.n_experts
    return total, active


__all__ = ["MoEGPTConfig", "forward", "forward_hidden", "init_params",
           "logical_axes", "loss_fn", "num_params", "param_specs"]
