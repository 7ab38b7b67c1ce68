"""GPT decoder: configuration, parameters, forward and loss (PyTorch).

Counterpart of ``ray_tpu/models/gpt.py`` (GPTConfig, param_specs,
partition_rules, init_params, QUANT_RULES, quant_axes, quantize_params,
dequant, weight_view, stack_block_params, _layer_norm, _rotary,
_attention, _block, forward_hidden, forward, forward_pipeline,
pipeline_loss_fn, loss_fn, num_params).
Parameters are a flat dict of tensors; block weights carry a leading
``layers`` axis exactly as in the JAX package, so a JAX checkpoint maps
one to one (``ray_tpu_torch/_bridge.py``). A Python loop over layer
slices takes the place of ``lax.scan``, and
``torch.utils.checkpoint(..., use_reentrant=False)`` the place of
``jax.checkpoint``. Training goes through ``loss_fn``; attention is the
plain fp32-softmax path (``attn_impl="xla"``), the flash kernels
(``"flash"``, ``ray_tpu_torch/ops/attention.py``) or ring attention
over a sequence-parallel mesh (``"ring"``, ``parallel/ring.py``; pass
``mesh=``).

One rank of a process mesh (``parallel/mesh.py::ProcessMesh``) runs the
model on its own pieces of the parameters (``train/spmd.py::
sharded_init``) through a `RankPlan` (``loss_fn(..., plan=)``), which
`rank_plan` builds from the pieces' shardings. Under fsdp each
layer's slice of the stacked [L, ...] leaves is gathered whole inside
the layer's checkpointed call, so at most one layer's leaves are whole
at a time, forward and backward (the gather is repeated in the
recompute, its gradient reduce-scattered per layer); the embedding,
the final norm and the head are gathered around their own use. Under
tp the block is megatron's: the heads, the MLP's hidden width and the
vocabulary are split across the tp ranks, the attention-out and
MLP-down partial sums are all-reduced in fp32 and cast to
``cfg.dtype`` after, and the loss is a vocab-parallel cross-entropy
(no rank builds the whole logits).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch._params import init_from_specs
from ray_tpu_torch.parallel.mesh import gather_leaf, reduce_from


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
    attn_impl: str = "xla"           # "xla" (plain) | "flash" (kernels) | "ring"
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
    """name → {shape, axes, init, scale}; the same table as the JAX
    package. ``axes`` are the logical axis names of each dimension
    (``parallel/mesh.py`` `DEFAULT_LOGICAL_RULES` maps them to mesh
    axes); the memory audit resolves them with
    ``models/partition.py::logical_to_spec``.

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
        "wte": {**norm(V, D), "axes": ("vocab", "embed")},
        "ln_f_scale": {**ones(D), "axes": ("embed",)},
        "ln_f_bias": {**zeros(D), "axes": ("embed",)},
        "ln1_scale": {**ones(L, D), "axes": ("layers", "embed")},
        "ln1_bias": {**zeros(L, D), "axes": ("layers", "embed")},
        "wq": {**norm(L, D, H, K), "axes": ("layers", "embed", "heads", "kv")},
        "wk": {**norm(L, D, H, K), "axes": ("layers", "embed", "heads", "kv")},
        "wv": {**norm(L, D, H, K), "axes": ("layers", "embed", "heads", "kv")},
        "wo": {**resid(L, H, K, D), "axes": ("layers", "heads", "kv", "embed")},
        "ln2_scale": {**ones(L, D), "axes": ("layers", "embed")},
        "ln2_bias": {**zeros(L, D), "axes": ("layers", "embed")},
        "w_up": {**norm(L, D, F), "axes": ("layers", "embed", "mlp")},
        "b_up": {**zeros(L, F), "axes": ("layers", "mlp")},
        "w_down": {**resid(L, F, D), "axes": ("layers", "mlp", "embed")},
        "b_down": {**zeros(L, D), "axes": ("layers", "embed")},
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = {**norm(D, V), "axes": ("embed", "vocab")}
    return specs


def logical_axes(cfg: GPTConfig) -> dict[str, tuple]:
    return {k: v["axes"] for k, v in param_specs(cfg).items()}


def partition_rules() -> tuple:
    """Rule table of serving tensor parallelism for the stacked-block
    layout (``models/partition.py`` `match_partition_rules`: rules match
    the ``/``-joined path, first match wins; each gives the dimension
    split across the shards, or None for replicated).

    Shards along the axis decode already parallelizes over: attention
    QKV on heads, the out projection on its head input, the MLP on its
    hidden width. Embeddings, norms, the residual-side bias and the LM
    head stay whole on every shard (the head runs once per window, on
    the summed hidden states). Shapes per param_specs(): wq/wk/wv
    [L, D, H, K], wo [L, H, K, D], w_up [L, D, F], b_up [L, F],
    w_down [L, F, D]."""
    return (
        (r"^w[qkv]$", 2),
        (r"^wo$", 1),
        (r"^w_up$", 2),
        (r"^b_up$", 1),
        (r"^w_down$", 1),
        # int8 scale companions (quantize_params): same rank as their
        # plane with the contracted axes kept at size 1, so a
        # head-sharded plane's scales shard with it. The wo and w_down
        # scales are per output channel over the sharded axis: size 1
        # there, replicated. Quantize first, then shard.
        (r"^w[qkv]_scale$", 2),
        (r"^w_up_scale$", 2),
        (r"^(wo|w_down)_scale$", None),
        # Replicated tail (explicit: an unmatched leaf is an error).
        (r"^(wte|lm_head|ln|b_down)", None),
    )


def init_params(cfg: GPTConfig, generator: torch.Generator | None = None,
                device=None) -> dict[str, torch.Tensor]:
    """Random parameters from ``generator`` (a torch.Generator on
    ``device``; a fresh one seeded 0 when None). Same shapes, scales and
    dtypes as the JAX ``init_params``; the numbers differ (another RNG)."""
    return init_from_specs(param_specs(cfg), cfg.param_dtype, generator,
                           resolve_device(device))


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


def unbind_layers(stacked: dict[str, torch.Tensor]) -> list[dict]:
    """Per-layer leaf dicts of a stacked dict, by one ``unbind`` per
    leaf: its backward stacks the layers' gradients once, where indexing
    ``leaf[i]`` layer by layer would make each layer's gradient a
    zero-filled copy of the whole leaf, summed L times."""
    names = list(stacked)
    return [dict(zip(names, ws))
            for ws in zip(*(stacked[k].unbind(0) for k in names))]


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


def causal_ring_attention(q, k, v, mesh):
    """Causal ring attention of q, k, v [B, S, H, K] over the sp mesh
    (``parallel/ring.py``): the flash kernels on CUDA tensors, plain
    attention on CPU tensors (the reference's ``"flash" if backend ==
    "tpu" else "xla"``, the card in the TPU's place)."""
    from ray_tpu_torch.parallel.ring import ring_attention_sharded

    if mesh is None:
        raise ValueError("attn_impl='ring' requires forward(..., mesh=)")
    impl = "flash" if q.device.type == "cuda" else "xla"
    return ring_attention_sharded(q, k, v, mesh, causal=True, impl=impl)


def _attention(q, k, v, cfg: GPTConfig, mesh=None):
    """Causal attention of q, k, v [B, S, H, K]: the flash kernels
    ("flash"), the plain fp32-softmax version ("xla"), or ring attention
    over the sp ``mesh`` ("ring")."""
    from ray_tpu_torch.ops.attention import flash_attention, reference_attention

    if cfg.attn_impl == "flash":
        return flash_attention(q, k, v, causal=True)
    if cfg.attn_impl == "xla":
        return reference_attention(q, k, v, causal=True)
    if cfg.attn_impl == "ring":
        return causal_ring_attention(q, k, v, mesh)
    raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")


def _block(x: torch.Tensor, layer: dict[str, torch.Tensor],
           cfg: GPTConfig, mesh=None, plan=None) -> torch.Tensor:
    """One pre-norm transformer block. x: [B, S, D]. ``plan``: a rank's
    `RankPlan` on a process mesh (its fsdp slices are gathered here,
    inside the layer's checkpointed call)."""
    from ray_tpu_torch.models.decode import _attn_out, _mlp, _qkv

    tp = None
    if plan is not None:
        layer, tp = plan.gather_layer(layer), plan.tp
    h = _layer_norm(x, layer["ln1_scale"], layer["ln1_bias"])
    q, k, v = _qkv(h, layer, cfg, tp)
    q = _rotary(q, cfg.rotary_dim)
    k = _rotary(k, cfg.rotary_dim)
    x = x + _attn_out(_attention(q, k, v, cfg, mesh), layer, cfg, tp)
    return _mlp(x, layer, cfg, tp)


@dataclasses.dataclass(frozen=True)
class RankPlan:
    """How one rank of a process mesh runs the model on its pieces:
    ``fsdp_dims``, the dimension of each leaf split over fsdp (gathered
    around its use); ``tp``, the mesh when tp > 1 (megatron); ``vocab``,
    this rank's [start, stop) of the vocabulary."""

    mesh: Any
    fsdp_dims: dict
    tp: Any
    vocab: tuple[int, int]

    def gathered(self, name: str, w: torch.Tensor, layer: bool = False):
        """Leaf ``name``'s piece ``w`` (one layer's slice when ``layer``)
        whole over fsdp; tp pieces stay as they are."""
        dim = self.fsdp_dims.get(name)
        if dim is None:
            return w
        return gather_leaf(w, self.mesh, "fsdp", dim - 1 if layer else dim)

    def gather_layer(self, layer: dict) -> dict:
        return {k: self.gathered(k, w, True) for k, w in layer.items()}


def rank_plan(cfg: GPTConfig, process_mesh, shardings: dict):
    """The `RankPlan` of this rank of ``process_mesh``, whose pieces are
    cut by ``shardings`` (by leaf name; `train/spmd.py::sharded_init`'s);
    None where neither fsdp nor tp is live (a dp rank holds whole leaves
    and runs the model as one controller does)."""
    if not (process_mesh.live("fsdp") or process_mesh.live("tp")):
        return None
    vocab = shardings["wte"].bounds((cfg.vocab_size, cfg.d_model))[0]
    return RankPlan(
        mesh=process_mesh,
        fsdp_dims={k: s.split_dim("fsdp") for k, s in shardings.items()
                   if s.split_dim("fsdp") is not None},
        tp=process_mesh if process_mesh.live("tp") else None, vocab=vocab)


def _checkpointed(fn, *args):
    """fn(*args), its activations recomputed in the backward."""
    from torch.utils.checkpoint import checkpoint

    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def forward_hidden(params: dict[str, torch.Tensor], tokens: torch.Tensor,
                   cfg: GPTConfig, mesh=None, *,
                   plan: RankPlan | None = None) -> torch.Tensor:
    """tokens: [B, S] int → final-norm hidden states [B, S, D] (cfg.dtype).
    The embedding gathers from the table cast to cfg.dtype, so its
    gradient is a scatter-add in cfg.dtype, as in the JAX package.
    ``mesh`` (``parallel/ring.py::make_sp_mesh``) is read only when
    cfg.attn_impl == "ring"; ``plan``: ``params`` are this rank's
    pieces, run by the `RankPlan` (see the module docstring)."""
    return _hidden(params, tokens, cfg, mesh, plan)


def _embed(params, tokens: torch.Tensor, cfg: GPTConfig,
           plan) -> torch.Tensor:
    """The token embeddings [B, S, D] in cfg.dtype; under tp a masked
    lookup of this rank's vocabulary rows, summed over tp (each token's
    row is on one rank: the sum is exact)."""
    tokens = tokens.long()
    if plan is None:
        return params["wte"].to(cfg.dtype)[tokens]
    wte = plan.gathered("wte", params["wte"]).to(cfg.dtype)
    if plan.tp is None:
        return wte[tokens]
    start, stop = plan.vocab
    local = tokens - start
    inside = ((local >= 0) & (local < stop - start))[..., None]
    rows = wte[local.clamp(0, stop - start - 1)]
    return reduce_from(torch.where(inside, rows, torch.zeros_like(rows)),
                       plan.tp, "tp")


def _hidden(params, tokens, cfg: GPTConfig, mesh, plan) -> torch.Tensor:
    """`forward_hidden` under a `RankPlan` (or None). Under fsdp every
    layer runs checkpointed, so that its gathered leaves are freed after
    its forward and gathered again in its recompute."""
    x = _embed(params, tokens, cfg, plan)
    per_layer = cfg.remat or (plan is not None and bool(plan.fsdp_dims))
    for layer in unbind_layers(stack_block_params(params)):
        if per_layer:
            x = _checkpointed(_block, x, layer, cfg, mesh, plan)
        else:
            x = _block(x, layer, cfg, mesh, plan)
    scale, bias = params["ln_f_scale"], params["ln_f_bias"]
    if plan is not None:
        scale = plan.gathered("ln_f_scale", scale)
        bias = plan.gathered("ln_f_bias", bias)
    return _layer_norm(x, scale, bias)


def _head_matrix(params, cfg: GPTConfig, plan=None) -> torch.Tensor:
    """The LM head [D, V] in cfg.dtype (this rank's vocabulary columns
    under tp), gathered over fsdp under a `RankPlan`."""
    name = "wte" if cfg.tie_embeddings else "lm_head"
    head = params[name]
    if plan is not None:
        head = plan.gathered(name, head)
    return (head.T if cfg.tie_embeddings else head).to(cfg.dtype)


def _logits(x: torch.Tensor, head: torch.Tensor, tp=None) -> torch.Tensor:
    """x [..., D] @ head [D, V] → fp32 logits [..., V] from fp32 sums;
    under ``tp`` (a megatron rank's process mesh) this rank's
    vocabulary columns, x's gradient summed over tp (`_column_parallel`)."""
    from ray_tpu_torch.models.decode import _column_parallel, _matmul_f32

    x2d = x.reshape(-1, x.shape[-1])
    out = (_matmul_f32(x2d, head) if tp is None
           else _column_parallel(x2d, head, tp, f32=True))
    return out.reshape(*x.shape[:-1], head.shape[1])


def forward(params: dict[str, torch.Tensor], tokens: torch.Tensor,
            cfg: GPTConfig, mesh=None) -> torch.Tensor:
    """tokens: [B, S] int → logits [B, S, V] (fp32)."""
    return _logits(forward_hidden(params, tokens, cfg, mesh),
                   _head_matrix(params, cfg))


def forward_pipeline(params: dict[str, torch.Tensor], tokens: torch.Tensor,
                     cfg: GPTConfig, mesh, n_micro: int) -> torch.Tensor:
    """Pipeline-parallel forward → logits [B, S, V] (fp32): the block
    stack runs the GPipe microbatch schedule over the pp ``mesh``
    (``parallel/pipeline.py``), stage r on its n_layers/pp blocks on
    ``mesh[r]``, each block checkpointed under cfg.remat; the embedding,
    final norm and head stay outside the pipeline, on the controller's
    device. The block leaves are placed on the mesh (``name@r``,
    ``models/partition.py::place_on_axis`` with
    `PIPELINE_LOGICAL_RULES`) or whole (split into stages at each call).
    Requires cfg.n_layers % len(mesh) == 0."""
    from ray_tpu_torch.parallel import pipeline
    from ray_tpu_torch.parallel.mesh import axis_shards

    x = params["wte"].to(cfg.dtype)[tokens.long()]
    stages = [dict(zip(_BLOCK_KEYS, leaves)) for leaves in zip(
        *(axis_shards(params, k, mesh) for k in _BLOCK_KEYS))]

    def stage(local_stack, act):
        for layer in unbind_layers(local_stack):
            if cfg.remat:
                act = _checkpointed(_block, act, layer, cfg)
            else:
                act = _block(act, layer, cfg)
        return act

    x = pipeline.pipeline_apply(stage, stages, x, mesh=mesh, n_micro=n_micro)
    x = _layer_norm(x, params["ln_f_scale"], params["ln_f_bias"])
    return _logits(x, _head_matrix(params, cfg))


def pipeline_loss_fn(params, tokens, targets, cfg: GPTConfig, mesh,
                     n_micro: int) -> torch.Tensor:
    """Mean next-token cross-entropy through `forward_pipeline`."""
    logits = forward_pipeline(params, tokens, cfg, mesh, n_micro)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return (logz - gold).mean()


class _VocabParallelCE(torch.autograd.Function):
    """Per-token cross-entropy from this rank's vocabulary columns of the
    fp32 logits [N, V/tp] (columns ``start`` on): the max, the sum of
    exponentials and the target's logit each all-reduced over tp, so no
    rank builds the whole logits. The backward is softmax - onehot on
    the rank's columns."""

    @staticmethod
    def forward(ctx, logits, targets, start, mesh):
        m = mesh.all_reduce_max(logits.max(dim=-1).values, ("tp",))
        shifted = logits - m[:, None]
        probs = shifted.exp()
        total = mesh.all_reduce_sum(probs.sum(dim=-1), ("tp",))
        local = targets.long() - start
        inside = (local >= 0) & (local < logits.shape[1])
        local = local.clamp(0, logits.shape[1] - 1)
        gold = shifted.gather(1, local[:, None])[:, 0]
        gold = mesh.all_reduce_sum(
            torch.where(inside, gold, torch.zeros_like(gold)), ("tp",))
        ctx.save_for_backward(probs.div_(total[:, None]), local, inside)
        return total.log() - gold

    @staticmethod
    def backward(ctx, grad):
        probs, local, inside = ctx.saved_tensors
        g = probs * grad[:, None]
        rows = torch.arange(g.shape[0], device=g.device)
        g[rows, local] -= torch.where(inside, grad, torch.zeros_like(grad))
        return g, None, None, None


def _ce_sum(x, head, targets, plan=None):
    """Summed next-token cross-entropy of one chunk (fp32 logits); under
    tp from this rank's vocabulary columns (`_VocabParallelCE`)."""
    logits = _logits(x, head, None if plan is None else plan.tp)
    logits, targets = logits.reshape(-1, logits.shape[-1]), targets.reshape(-1)
    if plan is None or plan.tp is None:
        return F.cross_entropy(logits, targets.long(), reduction="sum")
    return _VocabParallelCE.apply(logits, targets, plan.vocab[0],
                                  plan.tp).sum()


def loss_fn(params: dict[str, torch.Tensor], tokens: torch.Tensor,
            targets: torch.Tensor, cfg: GPTConfig, mesh=None, *,
            plan: RankPlan | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy. tokens/targets: [B, S] int.

    With cfg.loss_chunk set, the vocab projection and CE run chunk by
    chunk over the sequence, each chunk checkpointed: only one fp32
    [B, chunk, V] logits block is live at a time, forward and backward
    (the chunk recomputes its logits in the backward; the head gradient
    accumulates across chunks). ``plan``: a `RankPlan`; ``params`` are
    this rank's pieces and ``tokens`` its rows; the loss is the mean over
    the rank's rows (see the module docstring)."""
    x = _hidden(params, tokens, cfg, mesh, plan)
    head = _head_matrix(params, cfg, plan)
    B, S = tokens.shape
    if cfg.loss_chunk is None or S <= cfg.loss_chunk:
        if plan is not None and plan.tp is not None:
            return _ce_sum(x, head, targets, plan) / (B * S)
        logits = _logits(x, head)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               targets.reshape(-1).long())
    C = cfg.loss_chunk
    if S % C != 0:
        raise ValueError(f"seq len {S} not divisible by loss_chunk {C}")
    total = torch.zeros((), device=x.device, dtype=torch.float32)
    for c in range(0, S, C):
        total = total + _checkpointed(_ce_sum, x[:, c:c + C], head,
                                      targets[:, c:c + C], plan)
    return total / (B * S)


def num_params(cfg: GPTConfig) -> int:
    return sum(math.prod(s["shape"]) for s in param_specs(cfg).values())


__all__ = ["GPTConfig", "param_specs", "logical_axes", "partition_rules",
           "init_params",
           "QUANT_RULES", "quant_axes", "quantize_params", "dequant", "weight_view",
           "stack_block_params", "unbind_layers", "forward_hidden", "forward",
           "forward_pipeline", "pipeline_loss_fn", "loss_fn", "num_params",
           "RankPlan", "rank_plan"]
