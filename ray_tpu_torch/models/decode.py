"""Autoregressive decoding with a slotted (dense) KV cache (PyTorch).

Counterpart of ``ray_tpu/models/decode.py``: the per-token transformer
pieces shared with the paged programs (`_rotary_pos`, `_qkv`, `_mlp`
with its cross-shard sum `_reduce`, which is
``parallel/mesh.py::reduce_shards``, `_head`, `sample_token`) and the dense
serving programs: a fixed cache ``{"k", "v"}`` of ``[L, B, T_max, H,
K]`` in ``cfg.dtype``
(`init_kv_cache`), `prefill` (one prompt into one slot from position
0), `prefill_batch` (N prompts into N distinct slots), `decode_step`
(every slot one token at ``positions[b]``, attending over the whole
``T_max`` under the mask ``t <= positions[b]``) and `decode_multi` (a
fused window of k such steps with on-device sampling). The dense
programs are plain PyTorch, as the reference's are plain XLA: fp32
scores, ``-1e30`` masking, an fp32 softmax whose probabilities are cast
to ``cfg.dtype`` before P·V, and the fp32 LM head.

Three details carry the reference's numerics and are pinned by
tests/test_torch_model.py:

- rotary rotates INTERLEAVED even/odd pairs of the leading
  ``rotary_dim`` dims (not the half-split ``rotate_half`` layout), with
  sin/cos computed in fp32 and cast to the activation dtype;
- GELU is the tanh form (``jax.nn.gelu``'s default);
- the LM head returns fp32 logits accumulated in fp32 (a bf16 matmul
  would round logits to bf16 and flip near-tie argmaxes).

Differences from the JAX dense programs, all deliberate:

- The cache is updated IN PLACE (the JAX programs donate it) and is
  still returned, as the paged programs do.
- `prefill` and `prefill_batch` apply the LM head to each row's last
  valid position only (the head is row-wise: the same numbers, without
  an [N, S, V] fp32 tensor).
- JAX clamps `dynamic_update_slice` and drops out-of-range scatters;
  torch raises. Every index is in range by construction: prompts are
  bucketed below ``T_max``, the engine bounds each decode window by
  ``max_len - max(positions)`` (idle slots' positions are 0), and the
  one write that can fall past the cache (a slot whose window ended at
  ``max_len``, finished right after its step) is dropped explicitly.
- The decode step's two products over the cache run as ONE batched
  matmul per side with a block-diagonal query (each head's row holds
  its q at its own K columns and zeros elsewhere) against the cache
  viewed as ``[B, T, H*K]``, then take the diagonal blocks of P·V. The
  sums are the reference's einsums' (zeros add nothing), and no
  permuted copy of the ``[B, T, H, K]`` cache is made, at H times the
  products, which the memory-bound step can afford.
- The fused window samples from a ``torch.Generator`` instead of
  threading a JAX key.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.gpt import (GPTConfig, _layer_norm,
                                      stack_block_params, weight_view)
from ray_tpu_torch.parallel.mesh import reduce_from
from ray_tpu_torch.parallel.mesh import reduce_shards as _reduce


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


def _proj(h: torch.Tensor, w: torch.Tensor, tp=None) -> torch.Tensor:
    """h [..., D] @ w [D, *out] → [..., *out] as one 2-D matmul; under
    ``tp`` (a megatron rank's process mesh) `_column_parallel`."""
    D = w.shape[0]
    h2d, w2d = h.reshape(-1, D), w.reshape(D, -1)
    out = h2d @ w2d if tp is None else _column_parallel(h2d, w2d, tp)
    return out.reshape(*h.shape[:-1], *w.shape[1:])


def _qkv(h, layer, cfg, tp=None):
    """The q, k, v projections [..., H, K] of h [..., D]. ``tp``: the
    process mesh of a megatron rank, whose wq/wk/wv hold its heads: the
    three are one `_column_parallel` product (h's gradient summed over
    tp once)."""
    ws = [weight_view(layer, n, cfg.dtype) for n in ("wq", "wk", "wv")]
    if tp is None:
        return tuple(_proj(h, w) for w in ws)               # [B, S, H, K]
    D = h.shape[-1]
    outs = _column_parallel(h.reshape(-1, D), [w.reshape(D, -1) for w in ws],
                            tp)
    return tuple(o.reshape(*h.shape[:-1], *w.shape[1:])
                 for o, w in zip(outs, ws))


def _row_parallel(x2d: torch.Tensor, w2d: torch.Tensor, tp, dtype):
    """A megatron rank's partial x @ w, its fp32 sums all-reduced over tp
    in fp32, then cast to ``dtype`` (ranks' bf16 partials summed in
    another order would round otherwise)."""
    return reduce_from(_matmul_f32(x2d, w2d), tp, "tp").to(dtype)


def _attn_out(attn: torch.Tensor, layer, cfg, tp=None) -> torch.Tensor:
    """attn [..., H, K] @ wo [H, K, D] → [..., D]; under ``tp`` this
    rank's heads' partial sum, all-reduced (`_row_parallel`)."""
    wo = weight_view(layer, "wo", cfg.dtype)
    H, K, D = wo.shape
    a, w = attn.reshape(-1, H * K), wo.reshape(H * K, D)
    out = a @ w if tp is None else _row_parallel(a, w, tp, cfg.dtype)
    return out.reshape(*attn.shape[:-2], D)


def _mlp(x, layer, cfg, tp=None):
    """Feed-forward block with the tanh GELU. ``layer`` is one layer's
    dict, or under single-controller tensor parallelism the list of
    every shard's (w_up, b_up and w_down sharded on the hidden width):
    the up-projection and GELU are shard-local, and the down-projection
    partials are summed across shards (`_reduce`) BEFORE the replicated
    b_down joins the residual (adding it per shard would count it tp
    times). ``tp``: the process mesh of a megatron rank, whose layer
    holds its slice of the hidden width: the same, the up-projection
    `_column_parallel` and the partials summed by `_row_parallel`."""
    shards = layer if isinstance(layer, list) else [layer]
    first = shards[0]
    h = _layer_norm(x, first["ln2_scale"], first["ln2_bias"])
    parts = []
    for lay in shards:
        hs = h.to(lay["w_up"].device)
        up = F.gelu(_proj(hs, weight_view(lay, "w_up", cfg.dtype), tp)
                    + lay["b_up"].to(cfg.dtype), approximate="tanh")
        w_down = weight_view(lay, "w_down", cfg.dtype)
        if tp is None:
            parts.append(_proj(up, w_down))
        else:
            parts.append(_row_parallel(up.reshape(-1, up.shape[-1]), w_down,
                                       tp, cfg.dtype).reshape(x.shape))
    down = _reduce(parts, x.device)
    return x + (down + first["b_down"].to(cfg.dtype))


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with fp32 sums AND an fp32 result. On CUDA the GEMM writes
    fp32 straight from its fp32 accumulators; on the CPU both operands
    are upcast (the same products — bf16 values are exact in fp32)."""
    if x.is_cuda and x.dtype != torch.float32:
        return torch.mm(x, w, out_dtype=torch.float32)
    return x.float() @ w.float()


class _MatmulF32(torch.autograd.Function):
    """[M, D] @ [D, N] with fp32 accumulation AND an fp32 result
    (`_mm_f32`). ``torch.mm(..., out_dtype=)`` has no derivative, so the
    backward is written here: the fp32 cotangent is rounded to the
    operands' dtype and both products run in that dtype with fp32 sums,
    as every other bf16 product's backward in the model does (and as a
    TPU runs an fp32-by-bf16 product at default precision)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w)

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


class _ColumnParallel(torch.autograd.Function):
    """x [M, D] @ w [D, N / tp] for each w of a megatron rank: its
    columns of products whose input every rank of tp reads whole
    (``f32``: the fp32 results of `_MatmulF32`, their cotangents rounded
    to x's dtype first). The backward sums x's gradient over the
    products and over tp from the ranks' fp32 partials (`reduce`, one
    all-reduce) and rounds the sum once to x's dtype, as one
    controller's product rounds its whole sum once: bf16 partials
    summed across ranks would round again."""

    reduce = staticmethod(lambda t, mesh: mesh.all_reduce_sum(t, ("tp",)))

    @staticmethod
    def forward(ctx, x, mesh, f32, *ws):
        ctx.save_for_backward(x, *ws)
        ctx.mesh = mesh
        return tuple(_mm_f32(x, w) if f32 else x @ w for w in ws)

    @staticmethod
    def backward(ctx, *gs):
        x, *ws = ctx.saved_tensors
        gs = [None if g is None else g.to(x.dtype) for g in gs]
        gx = None
        if ctx.needs_input_grad[0]:
            gx = sum(_mm_f32(g, w.t()) for g, w in zip(gs, ws)
                     if g is not None)
            gx = _ColumnParallel.reduce(gx, ctx.mesh).to(x.dtype)
        gws = [x.t() @ g if g is not None and need else None
               for g, need in zip(gs, ctx.needs_input_grad[3:])]
        return (gx, None, None, *gws)


def _column_parallel(x: torch.Tensor, ws, tp, f32: bool = False):
    """`_ColumnParallel` of x [M, D] and this rank's columns over the
    process mesh ``tp``: of each w [D, n] of the list ``ws`` (→ a tuple
    of products), or of one w (→ its product)."""
    if isinstance(ws, (list, tuple)):
        return _ColumnParallel.apply(x, tp, f32, *ws)
    return _ColumnParallel.apply(x, tp, f32, ws)[0]


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


def _sample_next(logits, temps, generator: torch.Generator):
    """On-device sampling step of a fused window: greedy argmax at
    temp <= 0, else a temperature-scaled categorical draw from
    ``generator`` (a torch.Generator on the logits' device).
    → (next tokens int32, scaled logits)."""
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
    greedy = torch.argmax(logits, dim=-1)
    sampled = _categorical(scaled, generator)
    nxt = torch.where(temps <= 0.0, greedy, sampled).to(torch.int32)
    return nxt, scaled


# ------------------------------------------------------- dense programs

def init_kv_cache(cfg: GPTConfig, n_slots: int, max_len: int, device=None):
    """Dense cache ``{"k", "v"}`` of ``[L, n_slots, max_len, H, K]`` in
    ``cfg.dtype`` (zeros) on ``device`` (default cuda)."""
    shape = (cfg.n_layers, n_slots, max_len, cfg.n_heads, cfg.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[n, M, D] @ [n, D, N] → fp32 [n, M, N] from fp32 sums (the
    reference's ``preferred_element_type=jnp.float32``). On CUDA a bf16
    product writes fp32 straight from its accumulators, with no upcast
    copy of either operand; elsewhere both are upcast (exact)."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _causal_prompt_attention(q, k, v, scale: float, dtype):
    """Causal self-attention of whole prompts, the reference's one-shot
    formulation: fp32 scores [N, H, S, S], -1e30 above the diagonal, an
    fp32 softmax cast to ``dtype`` before P·V. q, k, v: [N, S, H, K]
    → [N, S, H, K] in ``dtype``."""
    N, S, H, K = q.shape
    heads = lambda a: a.transpose(1, 2).reshape(N * H, S, K)
    logits = _bmm_f32(heads(q), heads(k).transpose(1, 2)) * scale
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    logits.masked_fill_(~causal, -1e30)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    attn = torch.bmm(probs, heads(v.to(dtype)))               # [N*H, S, K]
    return attn.reshape(N, H, S, K).transpose(1, 2)


def _prompt_forward(cfg: GPTConfig, params, stacked, tokens, write):
    """Shared body of the one-shot prefill programs (dense and paged):
    embed [N, S] prompts, run every layer of ``stacked`` (the caller's
    `stack_block_params`: the dense programs keep the stored dtype of
    the layer norms, the paged ones cast, as in the reference) with
    causal prompt attention, and hand each layer's rotated K and V
    ([N, S, H, K]) to ``write(l, k, v)``. → hidden states [N, S, D]."""
    N, S = tokens.shape
    x = params["wte"].to(cfg.dtype)[tokens]                  # [N, S, D]
    pos = torch.arange(S, device=tokens.device).expand(N, S)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    for l in range(cfg.n_layers):
        layer = {name: w[l] for name, w in stacked.items()}
        h = _layer_norm(x, layer["ln1_scale"], layer["ln1_bias"])
        q, k, v = _qkv(h, layer, cfg)
        q = _rotary_pos(q, cfg.rotary_dim, pos)
        k = _rotary_pos(k, cfg.rotary_dim, pos)
        attn = _causal_prompt_attention(q, k, v, scale, cfg.dtype)
        x = x + _attn_out(attn, layer, cfg)
        x = _mlp(x, layer, cfg)
        write(l, k, v)
    return x


def _last_token_logits(cfg: GPTConfig, params, x, lengths):
    """The LM head at row i's position ``lengths[i] - 1`` only → [N, V]
    fp32 (the head is row-wise: the reference's numbers, without its
    [N, S, V] logits)."""
    rows = torch.arange(x.shape[0], device=x.device)
    last = lengths.to(device=x.device, dtype=torch.int64) - 1
    return _head(params, cfg, x[rows, last])


def prefill_batch(cfg: GPTConfig, params, tokens, cache, slots, lengths):
    """Prefill N prompts into N DISTINCT cache slots in one dispatch,
    each from position 0 (the padded tail is written too and masked at
    decode time). tokens: [N, S_bucket] padded, S_bucket <= T_max;
    slots, lengths: [N]. The cache is written in place.
    → (last-token logits [N, V] fp32, cache)."""
    S = tokens.shape[1]
    slots = slots.to(device=tokens.device, dtype=torch.int64)

    def write(l, k, v):
        cache["k"][l][slots, :S] = k.to(cfg.dtype)
        cache["v"][l][slots, :S] = v.to(cfg.dtype)
    x = _prompt_forward(cfg, params, stack_block_params(params), tokens,
                        write)
    return _last_token_logits(cfg, params, x, lengths), cache


def prefill(cfg: GPTConfig, params, tokens, cache, slot, length):
    """Write one prompt ([1, S_bucket], padded) into cache slot ``slot``
    from position 0. ``slot`` and ``length`` are ints or 0-d tensors.
    → (last-token logits [V] fp32, cache)."""
    dev = tokens.device
    slots = torch.as_tensor(slot, device=dev).reshape(1)
    lengths = torch.as_tensor(length, device=dev).reshape(1)
    last, cache = prefill_batch(cfg, params, tokens, cache, slots, lengths)
    return last[0], cache


def _dense_attention(q, k_cache_l, v_cache_l, positions, scale: float):
    """One query row per slot over its whole cache row: q [B, H, K],
    caches [B, T, H, K], positions [B] → [B, H, K] in the cache's dtype.
    The reference's ``einsum("bhk,bthk->bht")`` and
    ``einsum("bht,bthk->bhk")`` as batched matmuls on the cache viewed as
    [B, T, H*K] (no copy): the query is block-diagonal, [B, H, H*K] with
    head h's q at columns h*K..(h+1)*K, and P·V keeps the diagonal
    [K]-blocks of its [B, H, H*K] result."""
    B, T, H, K = k_cache_l.shape
    dtype = k_cache_l.dtype
    heads = torch.arange(H, device=q.device)
    q_bd = torch.zeros(B, H, H, K, dtype=dtype, device=q.device)
    q_bd[:, heads, heads] = q.to(dtype)
    logits = _bmm_f32(q_bd.reshape(B, H, H * K),
                      k_cache_l.reshape(B, T, H * K).transpose(1, 2)) * scale
    mask = (torch.arange(T, device=q.device)[None, :]
            <= positions[:, None])                            # [B, T]
    logits.masked_fill_(~mask[:, None, :], -1e30)
    probs = torch.softmax(logits, dim=-1).to(dtype)           # [B, H, T]
    out = torch.bmm(probs, v_cache_l.reshape(B, T, H * K))    # [B, H, H*K]
    return out.reshape(B, H, H, K)[:, heads, heads]


def _decode_once(cfg: GPTConfig, params, tokens, cache, positions):
    """All B slots advance one position: each writes its token's K/V at
    (b, positions[b]) (in place), then attends over its whole cache row
    under the mask t <= positions[b]. → (logits [B, V] fp32, cache)."""
    B, T = tokens.shape[0], cache["k"].shape[2]
    positions = positions.to(device=tokens.device, dtype=torch.int64)
    x = params["wte"].to(cfg.dtype)[tokens][:, None, :]      # [B, 1, D]
    pos = positions[:, None]
    stacked = stack_block_params(params)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    rows = torch.arange(B, device=tokens.device)
    # A slot whose cursor reached T (a window that ended at max_len) is
    # finished by the engine after this step without reading its logits;
    # JAX drops its out-of-range write, and so does this: the write goes
    # to the clamped in-range index with that position's old value.
    keep = (positions < T)[:, None, None]
    write_at = positions.clamp(max=T - 1)
    for l in range(cfg.n_layers):
        layer = {name: w[l] for name, w in stacked.items()}
        h = _layer_norm(x, layer["ln1_scale"], layer["ln1_bias"])
        q, k, v = _qkv(h, layer, cfg)
        q = _rotary_pos(q, cfg.rotary_dim, pos)
        k = _rotary_pos(k, cfg.rotary_dim, pos)
        k_cache_l, v_cache_l = cache["k"][l], cache["v"][l]
        k_cache_l[rows, write_at] = torch.where(
            keep, k[:, 0].to(cfg.dtype), k_cache_l[rows, write_at])
        v_cache_l[rows, write_at] = torch.where(
            keep, v[:, 0].to(cfg.dtype), v_cache_l[rows, write_at])
        attn = _dense_attention(q[:, 0], k_cache_l, v_cache_l, positions,
                                scale)
        x = x + _attn_out(attn, layer, cfg)[:, None, :]
        x = _mlp(x, layer, cfg)
    return _head(params, cfg, x)[:, 0], cache


def decode_step(cfg: GPTConfig, params, tokens, cache, positions):
    """One token for every slot. tokens: [B] (each slot's current
    token); positions: [B] (where it sits). Idle slots produce logits the
    engine ignores. → (logits [B, V] fp32, cache)."""
    return _decode_once(cfg, params, tokens, cache, positions)


def decode_multi(cfg: GPTConfig, params, tokens, cache, positions,
                 n_steps: int, temps, generator: torch.Generator):
    """``n_steps`` fused decode steps with on-device sampling (greedy at
    temps <= 0, else a draw from ``generator``), no host round trip
    inside. The caller keeps positions + n_steps - 1 below T_max.
    → (tokens_out [n_steps, B] int32, cache)."""
    toks = tokens
    pos = positions.to(device=tokens.device, dtype=torch.int64)
    out = []
    for _ in range(n_steps):
        logits, cache = _decode_once(cfg, params, toks, cache, pos)
        toks, _scaled = _sample_next(logits, temps, generator)
        out.append(toks)
        pos = pos + 1
    return torch.stack(out), cache


__all__ = ["sample_token", "init_kv_cache", "prefill", "prefill_batch",
           "decode_step", "decode_multi"]
