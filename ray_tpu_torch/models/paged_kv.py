"""Block-paged KV cache and the paged serving programs (PyTorch).

Counterpart of ``ray_tpu/models/paged_kv.py``:
`init_paged_kv` (float or int8 pool), `_quant_write`,
`_quant_write_full_pages`, the page ops (`copy_pages`, `gather_pages`,
`scatter_pages`), `prefill_batch_paged` (one-shot prefill: plain causal
prompt attention, then whole-page writes), `_chunk_paged_forward`,
`prefill_chunk_paged`, `verify_chunk_paged`, `_decode_once_paged`,
`decode_step_paged`, `decode_multi_paged` (the body of
`_decode_multi_scan`: `_decode_multi`), `spec_draft_propose` (that of
`_spec_propose_scan`: `_spec_propose`) and `_last_valid_logits`; the
fused loops sample through `decode._sample_next`. For tensor
parallelism, `KV_POOL_PARTITION_RULES` and the eight ``*_tp`` twins
(their section below), whose bodies are the programs' own.

Layout (the JAX package's): one pool ``{"k", "v"}`` of
``[L, P+1, page_size, H, K]`` shared by all slots, plus per-slot page
tables ``[B, n_pg]`` of page ids. Page 0 is the reserved null page:
unallocated table entries point at it, masked writes are routed to it,
and every read of it is position-masked. An int8 pool adds one per-page
scale plane per side, ``{"k_scale", "v_scale"}`` ``[L, P+1]`` bf16, set
at a page's first write (`_quant_write`); the programs hand each layer's
scale vectors to the attention beside its planes.

Differences from the JAX programs, all deliberate:

- The pool, scale planes included, is updated IN PLACE (the JAX
  programs donate it through ``donate_argnums`` and return a new one).
  Every program still returns the pool so call sites read the same.
- PyTorch runs eagerly, so nothing here casts weights per call: the
  engine casts them once at load (`serving_params`), after which every
  ``Tensor.to(cfg.dtype)`` below returns the tensor itself. int8 planes
  stay int8 and are dequantized per use (`gpt.weight_view`).
- JAX clamps out-of-range gathers and drops out-of-range scatters
  silently; torch raises (CPU) or device-asserts (CUDA). The explicit
  clamps and null-page routing of the JAX code are kept, and every
  index here is in range by construction.
- `_last_valid_logits` selects each row's last valid hidden state
  BEFORE the LM head instead of after it: the head is row-wise, so the
  numbers are the same, without a [N, C, V] fp32 logits tensor.
  `prefill_batch_paged` does the same at each row's last valid prompt
  position (no [N, S, V] tensor: 2.5 GB at 8 x 1536 x 50,304). The
  verify program (`verify_chunk_paged`) needs the head at every chunk
  position and runs it on the whole [N, C, D] block.
- The fused loops (`decode_multi_paged`, `spec_draft_propose`) sample
  from a ``torch.Generator`` instead of threading a JAX key.
"""

from __future__ import annotations

import contextlib
import math

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.decode import (_attn_out, _head, _last_token_logits,
                                         _mlp, _prompt_forward, _qkv, _reduce,
                                         _rotary_pos, _sample_next)
from ray_tpu_torch.models.gpt import (GPTConfig, _layer_norm,
                                      stack_block_params)
from ray_tpu_torch.models.partition import match_partition_rules
from ray_tpu_torch.ops.paged_attention import (
    paged_attention, paged_prefill_attention, reference_paged_attention,
    reference_paged_prefill_attention)

ATTN_IMPLS = ("gather", "kernel")


def init_paged_kv(cfg: GPTConfig, n_pages: int, page_size: int,
                  kv_dtype: str | None = None, device=None):
    """Shared page pool. Row 0 is the null page (never allocated).

    ``kv_dtype`` None/"bf16": K/V planes in ``cfg.dtype``. "int8": int8
    planes plus one per-page scale plane per side (``k_scale``/
    ``v_scale`` [L, P+1], bf16, zero = never scaled; see
    `_quant_write`)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, n_pages + 1, page_size, cfg.n_heads, cfg.head_dim)
    if kv_dtype in (None, "bf16"):
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}
    if kv_dtype != "int8":
        raise ValueError(f"kv_dtype must be bf16|int8, got {kv_dtype!r}")
    scale_shape = (cfg.n_layers, n_pages + 1)
    return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
            "v": torch.zeros(shape, dtype=torch.int8, device=dev),
            "k_scale": torch.zeros(scale_shape, dtype=torch.bfloat16,
                                   device=dev),
            "v_scale": torch.zeros(scale_shape, dtype=torch.bfloat16,
                                   device=dev)}


def _quant_write(pool_l, scale_l, write_pages, write_offs, values):
    """Quantized scatter of per-token K/V rows into one layer's int8 page
    plane ``pool_l`` [P+1, ps, H, K], maintaining its scale vector
    ``scale_l`` [P+1] (bf16) — both IN PLACE.

    values: [M, H, K] float rows landing at (write_pages[m],
    write_offs[m]). Scale policy, frozen at first write: a page's scale
    is (re)set from this dispatch's scatter-max of |row| over the rows
    landing in it iff some row lands at in-page offset 0 (a fresh or
    recycled page) or its stored scale is <= 0 (never scaled: such a
    page that gets no row takes 1e-8 / 127, as in the JAX package);
    otherwise the stored scale stays and rows clip at ±127. Rows are
    quantized with the fp32 scale and the scale is stored rounded to
    bf16, which is what later reads use. Null-page (id 0) writes only
    move the null scale, which no masked read consumes. The one-shard
    case of `_quant_write_shards`."""
    _quant_write_shards([(pool_l, scale_l, write_pages, write_offs,
                          values)])


def _cross_max(parts: list) -> torch.Tensor:
    """Elementwise maximum of the shards' [P+1] contributions on shard
    0's device (the JAX bodies' ``pmax``; exact in any order)."""
    out = parts[0]
    for p in parts[1:]:
        out = torch.maximum(out, p.to(out.device))
    return out


def _quant_write_shards(shards: list) -> None:
    """`_quant_write` of one layer on every shard: ``shards`` holds one
    ``(pool_l, scale_l, write_pages, write_offs, values)`` per shard, on
    its device, with the shard's heads of the rows. A page's scale
    covers all its heads, so every shard's contribution is computed
    before any shard writes and their maximum sets the scale: each
    shard's copy of the replicated scale plane stays bitwise identical
    (the JAX programs' ``pmax`` across head shards)."""
    parts = []
    for _pool_l, scale_l, write_pages, write_offs, values in shards:
        n_rows = scale_l.shape[0]
        v32 = values.float()
        pages = write_pages.long()
        vmax = v32.abs().flatten(1).amax(dim=1)                # [M]
        starts = torch.zeros(n_rows, dtype=torch.int32, device=v32.device)
        starts.scatter_reduce_(0, pages, (write_offs == 0).to(torch.int32),
                               "amax", include_self=True)
        contrib = torch.zeros(n_rows, dtype=torch.float32,
                              device=v32.device)
        contrib.scatter_reduce_(0, pages, vmax, "amax", include_self=True)
        parts.append((v32, pages, starts, contrib))
    contrib = _cross_max([c for *_x, c in parts])
    for (pool_l, scale_l, _p, write_offs, _v), (v32, pages, starts, _c) in (
            zip(shards, parts)):
        old = scale_l.float()
        new_scale = torch.where(
            (starts > 0) | (old <= 0.0),
            torch.clamp(contrib.to(old.device), min=1e-8) / 127.0, old)
        s = new_scale[pages].reshape((-1,) + (1,) * (v32.dim() - 1))
        q = torch.clamp(torch.round(v32 / s), -127, 127).to(torch.int8)
        pool_l[pages, write_offs.long()] = q
        scale_l.copy_(new_scale)


def _quant_write_full_pages(pool_l, scale_l, pages, values):
    """Whole-page variant of `_quant_write` (one-shot paged prefill):
    values [M, ps, H, K] fill pages[m] end to end, IN PLACE. A whole-page
    write is a first write, so every target page's scale resets from its
    own payload (padded rows included: the last page's scale covers
    them, and the first decode write into that page keeps it). Duplicate
    ids only ever name the null page 0, where any write order gives the
    same harmless result. The one-shard case of
    `_quant_write_full_pages_shards`."""
    _quant_write_full_pages_shards([(pool_l, scale_l, pages, values)])


def _quant_write_full_pages_shards(shards: list) -> None:
    """`_quant_write_full_pages` on every shard (``(pool_l, scale_l,
    pages, values)`` per shard): each page's scale from the maximum of
    every shard's payload, taken before any shard writes."""
    parts = []
    for _pool_l, _scale_l, pages, values in shards:
        v32 = values.float()
        parts.append((v32, pages.long(), v32.abs().flatten(1).amax(dim=1)))
    vmax = _cross_max([m for *_x, m in parts])
    for (pool_l, scale_l, _p, _v), (v32, pages, _m) in zip(shards, parts):
        new_scale = scale_l.float()
        new_scale[pages] = torch.clamp(vmax.to(v32.device), min=1e-8) / 127.0
        s = new_scale[pages].reshape((-1,) + (1,) * (v32.dim() - 1))
        pool_l[pages] = torch.clamp(torch.round(v32 / s), -127,
                                    127).to(torch.int8)
        scale_l.copy_(new_scale)


# ------------------------------------------------------------- page ops
#
# Dict-generic, like the JAX package's: every plane of the pool moves, so
# the int8 pool's scale planes [L, P+1] travel with their pages (a copied
# page keeps the scale its codes were quantized under). Each takes page
# ids [n] on the pool's device; padding pairs/ids are the null page 0,
# whose content no read ever uses unmasked.

def copy_pages(pool, src, dst):
    """Copy-on-write for the prefix cache: duplicate pages ``src[i]`` →
    ``dst[i]`` in every layer of every plane, IN PLACE. Padding pairs
    ``(0, 0)`` copy the null page onto itself (the reads happen before
    the writes, so duplicates of dst 0 all write page 0's own content);
    real dst ids are fresh allocations, never aliased. → pool."""
    src, dst = src.long(), dst.long()
    for plane in pool.values():
        plane[:, dst] = plane[:, src]
    return pool


def gather_pages(pool, pages):
    """Pages ``pages[i]`` of every layer of every plane →
    ``{name: [L, n, ...]}`` (a new tensor per plane; null-page ids read
    the null page)."""
    pages = pages.long()
    return {name: plane[:, pages] for name, plane in pool.items()}


def scatter_pages(pool, pages, payload):
    """Write ``payload[name][:, i]`` into pool rows ``pages[i]`` of every
    plane, IN PLACE: the inverse of `gather_pages`, so an int8 page lands
    with the scales it was quantized under. Padding ids are the null page
    with zero payloads; real ids are fresh allocations. → pool."""
    pages = pages.long()
    for name, plane in pool.items():
        plane[:, pages] = payload[name].to(plane.dtype)
    return pool


def serving_params(cfg: GPTConfig, params: dict, device=None) -> dict:
    """Cast parameters ONCE for the paged programs: every leaf the JAX
    programs cast to ``cfg.dtype`` on each call (block params via
    ``stack_block_params(params, cfg.dtype)``, the embedding and the LM
    head) is stored in ``cfg.dtype``; the final layer norm keeps its
    stored dtype, as there, and so do quantized planes (int8) and their
    ``_scale`` companions (fp32; `gpt.dequant` casts them per use, as
    the JAX programs do). The programs' own casts then cost nothing.
    Tensors move to ``device`` (default cuda)."""
    dev = resolve_device(device)
    out = {}
    for name, w in params.items():
        plane = params.get(name[:-len("_scale")]) if name.endswith(
            "_scale") else None
        keep = (name.startswith("ln_f_") or w.dtype == torch.int8
                or (plane is not None and plane.dtype == torch.int8))
        out[name] = w.to(device=dev, dtype=None if keep else cfg.dtype)
    return out


def _check_impl(attn_impl: str) -> None:
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be gather|kernel, got {attn_impl!r}")


def _layer(stacked: dict, l: int) -> dict:
    return {k: v[l] for k, v in stacked.items()}


def _shards(params, pool, mesh):
    """(per-shard params, per-shard pools, the shards' devices): one
    shard for a single-device program (``mesh`` None, dicts given), else
    the mesh's (lists given, one entry per shard)."""
    if mesh is None:
        return [params], [pool], [pool["k"].device]
    if len(params) != len(mesh):
        raise ValueError(f"{len(params)} parameter shards for a mesh of "
                         f"{len(mesh)} devices")
    return list(params), list(pool), _pool_devices(pool, mesh)


def _pool_devices(pool: list, mesh) -> list:
    """The devices of a sharded pool's shards (one shard per mesh
    device)."""
    if len(pool) != len(mesh):
        raise ValueError(f"{len(pool)} pool shards for a mesh of "
                         f"{len(mesh)} devices")
    return [p["k"].device for p in pool]


def _on_devices(t: torch.Tensor, devs: list) -> list:
    """``t`` on each shard's device: one copy per distinct device, the
    tensor itself where it already lies."""
    copies: dict = {}
    for d in devs:
        if d not in copies:
            copies[d] = t.to(d)
    return [copies[d] for d in devs]


def _launch_guards(devs: list) -> list:
    """A context per shard for its kernel launches: where the shards
    span several devices, the shard's CUDA device made current (a launch
    goes to the current device's stream); else nothing to do."""
    if len(set(devs)) == 1:
        return [contextlib.nullcontext()] * len(devs)
    return [torch.cuda.device(d) if d.type == "cuda"
            else contextlib.nullcontext() for d in devs]


def _write_rows(pools, l, pages, offs, k_rows, v_rows, dtype, quant):
    """Write one dispatch's K/V rows into layer ``l`` of every shard's
    pool (in place): a cast into the float pools, or `_quant_write_shards`
    into the int8 pools and their scale planes. ``pages``, ``offs``,
    ``k_rows`` and ``v_rows`` hold one tensor per shard, on its device.
    → per shard (k plane, v plane, the attention's scale keyword
    arguments) of layer ``l``."""
    if quant:
        for side, rows in (("k", k_rows), ("v", v_rows)):
            _quant_write_shards([
                (pool[side][l], pool[side + "_scale"][l], pg, of, r)
                for pool, pg, of, r in zip(pools, pages, offs, rows)])
        return [(pool["k"][l], pool["v"][l],
                 {"k_scale": pool["k_scale"][l],
                  "v_scale": pool["v_scale"][l]}) for pool in pools]
    out = []
    for pool, pg, of, kr, vr in zip(pools, pages, offs, k_rows, v_rows):
        k_pool_l, v_pool_l = pool["k"][l], pool["v"][l]
        k_pool_l[pg, of] = kr.to(dtype)
        v_pool_l[pg, of] = vr.to(dtype)
        out.append((k_pool_l, v_pool_l, {}))
    return out


def _sharded_layer(cfg, x, layers, devs, pos, write, attend):
    """One transformer layer over every shard, in lockstep: the
    replicated layer norm once, each shard's QKV and rotary
    (shard-local heads), ``write(k_rows, v_rows)`` of all shards' K/V
    (every shard's before any attention reads, which the int8 scale's
    cross-shard maximum needs) → per shard planes, each shard's
    ``attend(s, q, planes)``, the attention-out partials summed
    (`decode._reduce`) before the residual add, then the MLP with its
    own sum. ``pos`` holds the positions per shard. → x."""
    h = _layer_norm(x, layers[0]["ln1_scale"], layers[0]["ln1_bias"])
    qs, ks, vs = [], [], []
    for s, lay in enumerate(layers):
        q, k, v = _qkv(h.to(devs[s]), lay, cfg)
        qs.append(_rotary_pos(q, cfg.rotary_dim, pos[s]))
        ks.append(_rotary_pos(k, cfg.rotary_dim, pos[s]))
        vs.append(v)
    planes = write(ks, vs)
    parts = [_attn_out(attend(s, qs[s], planes[s]), lay, cfg)
             for s, lay in enumerate(layers)]
    x = x + _reduce(parts, x.device)
    return _mlp(x, layers, cfg)


def prefill_batch_paged(cfg: GPTConfig, params, tokens, pool, pages,
                        lengths):
    """One-shot prefill of N prompts: plain causal prompt attention (no
    pool reads), each layer's K/V scattered as whole pages into the float
    or int8 pool (in place).

    tokens: [N, S_bucket]; pages: [N, ceil(S_bucket / page_size)] page
    ids (unallocated tail entries 0: the null page); lengths: [N].
    → (last-token logits [N, V] fp32, pool)."""
    N, S = tokens.shape
    ps = pool["k"].shape[2]
    n_pg = pages.shape[1]
    quant = "k_scale" in pool
    flat = pages.reshape(-1).to(device=tokens.device, dtype=torch.int64)

    def paged(a):                                  # [N, S, H, K] → pages
        a = torch.nn.functional.pad(a, (0, 0, 0, 0, 0, n_pg * ps - S))
        return a.reshape(N * n_pg, ps, *a.shape[2:])

    def write(l, k, v):
        if quant:
            _quant_write_full_pages(pool["k"][l], pool["k_scale"][l], flat,
                                    paged(k))
            _quant_write_full_pages(pool["v"][l], pool["v_scale"][l], flat,
                                    paged(v))
        else:
            pool["k"][l][flat] = paged(k.to(cfg.dtype))
            pool["v"][l][flat] = paged(v.to(cfg.dtype))

    x = _prompt_forward(cfg, params, stack_block_params(params, cfg.dtype),
                        tokens, write)
    return _last_token_logits(cfg, params, x, lengths), pool


def _chunk_paged_forward(cfg: GPTConfig, params, tokens, pool, tables,
                         offsets, n_valid, attn_impl: str, mesh=None):
    """Shared chunk-row transformer body: write one [N, C] chunk batch
    into the page pool at per-row arbitrary offsets (in place) and attend
    causally over each slot's whole written prefix. With ``mesh`` (the
    tensor-parallel twins) ``params`` and ``pool`` are lists of shards
    and every layer runs on all of them in lockstep (`_sharded_layer`);
    everything but the attention-out and MLP-down sums is shard-local.
    → (hidden states [N, C, D] on the tokens' device, pool)."""
    shard_params, pools, devs = _shards(params, pool, mesh)
    N, C = tokens.shape
    ps = pools[0]["k"].shape[2]
    dev = tokens.device
    quant = "k_scale" in pools[0]
    x = shard_params[0]["wte"].to(cfg.dtype)[tokens]          # [N, C, D]
    rel = torch.arange(C, device=dev, dtype=torch.int64)
    offsets = offsets.to(torch.int64)
    n_valid = n_valid.to(torch.int64)
    pos = offsets[:, None] + rel[None, :]                    # [N, C]
    stacked = [stack_block_params(p, cfg.dtype) for p in shard_params]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    # Write targets: pad/inert positions (rel >= n_valid) go to the null
    # page — harmless, read-masked. The page index is clamped because a
    # padded tail's absolute position can run past the (possibly
    # width-sliced) table; only write-masked pad positions ever hit the
    # clamp, since valid positions fall inside the width by construction.
    page_idx = torch.clamp(pos // ps, max=tables.shape[1] - 1)
    row_pages = torch.gather(tables.to(torch.int64), 1, page_idx)  # [N, C]
    write_pages = torch.where(rel[None, :] < n_valid[:, None], row_pages,
                              torch.zeros_like(row_pages)).reshape(-1)
    write_offs = (pos % ps).reshape(-1)                      # [N*C]
    kv_lens = (offsets + n_valid).to(torch.int32)            # [N]
    pos_s, pages_s, offs_s, lens_s, starts_s, tables_s = (
        _on_devices(t, devs) for t in (
            pos, write_pages, write_offs, kv_lens, offsets.to(torch.int32),
            tables.to(torch.int32)))
    guards = _launch_guards(devs)
    fn = (paged_prefill_attention if attn_impl == "kernel"
          else reference_paged_prefill_attention)

    def attend(s, q, planes):
        with guards[s]:
            return fn(q.contiguous(), *planes[:2], tables_s[s], starts_s[s],
                      lens_s[s], sm_scale=scale, **planes[2])

    for l in range(cfg.n_layers):
        # Write before attending (same order as the decode path): each
        # row then reads its own chunk's K/V back through its table, so
        # intra-chunk causality is just the tpos <= qpos mask. Pad rows
        # all land on null-page slots, possibly several on the same one:
        # which duplicate wins is undefined on CUDA, and harmless only
        # because page 0 is never read unmasked.
        def write(ks, vs):
            return _write_rows(
                pools, l, pages_s, offs_s,
                [k.reshape(N * C, *k.shape[2:]) for k in ks],
                [v.reshape(N * C, *v.shape[2:]) for v in vs],
                cfg.dtype, quant)

        x = _sharded_layer(cfg, x, [_layer(st, l) for st in stacked], devs,
                           pos_s, write, attend)
    return x, pool


def _last_valid_logits(cfg: GPTConfig, params, x, n_valid):
    """LM head at each row's last VALID position (inert rows clamp to 0 —
    garbage the engine ignores). → [N, V] fp32."""
    N = x.shape[0]
    last = torch.clamp(n_valid.to(torch.int64) - 1, min=0)
    rows = x[torch.arange(N, device=x.device), last]          # [N, D]
    return _head(params, cfg, rows)


def prefill_chunk_paged(cfg: GPTConfig, params, tokens, pool, tables,
                        offsets, n_valid, *, return_logits: bool = True,
                        attn_impl: str = "gather"):
    """Write ONE chunk per slot of up to N prompts' KV pages, each at its
    own arbitrary token offset (chunked prefill, one dispatch per
    scheduler tick).

    tokens: [N, C] (tail chunks padded); tables: [N, width] page ids,
    width <= max_pages (pages covering ``offsets[i] .. offsets[i] +
    n_valid[i] - 1`` must be allocated and inside the width); offsets:
    [N] absolute position of tokens[i, 0]; n_valid: [N] valid tokens in
    row i (0 = inert row: its writes go to the null page). The pool is
    written in place. → (last-valid-token logits [N, V] fp32 if
    return_logits else None, pool)."""
    _check_impl(attn_impl)
    x, pool = _chunk_paged_forward(cfg, params, tokens, pool, tables,
                                   offsets, n_valid, attn_impl)
    if not return_logits:
        return None, pool
    return _last_valid_logits(cfg, params, x, n_valid), pool


def verify_chunk_paged(cfg: GPTConfig, params, tokens, pool, tables,
                       offsets, n_valid, *, attn_impl: str = "gather"):
    """Speculative verify: score a [N, C] batch of rows ``[pending,
    draft_1, ..., draft_k]`` (C = k+1) written at each slot's decode
    cursor ``offsets`` (in place), with the LM head at EVERY chunk
    position: row i's logits are the target distribution of the token
    after position offsets + i. The body is `prefill_chunk_paged`'s (the
    verify pass is a chunked-prefill row at an arbitrary offset, causal
    within the chunk); rows with ``n_valid`` 0 are inert. Rejected
    positions are rolled back by the engine rewinding its cursors: their
    K/V sit past every kv length and are overwritten by the next write.
    → (logits [N, C, V] fp32, pool)."""
    _check_impl(attn_impl)
    x, pool = _chunk_paged_forward(cfg, params, tokens, pool, tables,
                                   offsets, n_valid, attn_impl)
    return _head(params, cfg, x), pool


def _decode_once_paged(cfg: GPTConfig, params, tokens, pool, positions,
                       tables, attn_impl: str = "gather", write_mask=None,
                       mesh=None):
    """All B slots advance one token against the page pool (in place).

    tokens: [B]; positions: [B]; tables: [B, n_pg]; `write_mask` ([B]
    bool, optional) routes masked rows' K/V writes to the null page.
    With ``mesh``, ``params`` and ``pool`` are lists of shards (see
    `_chunk_paged_forward`); the LM head runs once, on shard 0's
    replicated head and the summed hidden states.
    → (logits [B, V] fp32, pool)."""
    _check_impl(attn_impl)
    shard_params, pools, devs = _shards(params, pool, mesh)
    ps = pools[0]["k"].shape[2]
    quant = "k_scale" in pools[0]
    positions = positions.to(torch.int64)
    x = shard_params[0]["wte"].to(cfg.dtype)[tokens][:, None, :]  # [B, 1, D]
    stacked = [stack_block_params(p, cfg.dtype) for p in shard_params]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    # Loop-invariant across layers. The page index is clamped (like the
    # chunk path): an idle slot's cursor can walk past its table.
    page_idx = torch.clamp(positions // ps, max=tables.shape[1] - 1)
    write_page = torch.gather(tables.to(torch.int64), 1,
                              page_idx[:, None])[:, 0]        # [B]
    if write_mask is not None:
        write_page = torch.where(write_mask, write_page,
                                 torch.zeros_like(write_page))
    write_off = positions % ps                                # [B]
    kv_lengths = (positions + 1).to(torch.int32)              # [B]
    pos_s, pages_s, offs_s, lens_s, tables_s = (
        _on_devices(t, devs) for t in (
            positions[:, None], write_page, write_off, kv_lengths,
            tables.to(torch.int32)))
    guards = _launch_guards(devs)
    fn = (paged_attention if attn_impl == "kernel"
          else reference_paged_attention)

    def attend(s, q, planes):
        with guards[s]:
            return fn(q[:, 0].contiguous(), *planes[:2], tables_s[s],
                      lens_s[s], sm_scale=scale, **planes[2])[:, None]

    for l in range(cfg.n_layers):
        # Idle slots (all-null tables) may write the same null-page slot;
        # the order is undefined on CUDA and harmless (page 0 is masked).
        def write(ks, vs):
            return _write_rows(pools, l, pages_s, offs_s,
                               [k[:, 0] for k in ks], [v[:, 0] for v in vs],
                               cfg.dtype, quant)

        x = _sharded_layer(cfg, x, [_layer(st, l) for st in stacked], devs,
                           pos_s, write, attend)
    logits = _head(shard_params[0], cfg, x)[:, 0]
    return logits, pool


def decode_step_paged(cfg: GPTConfig, params, tokens, pool, positions,
                      tables, *, attn_impl: str = "gather"):
    """One token for every slot against the paged pool (in place).
    → (logits [B, V] fp32, pool)."""
    return _decode_once_paged(cfg, params, tokens, pool, positions, tables,
                              attn_impl)


def _decode_multi(cfg: GPTConfig, params, tokens, pool, positions, tables,
                  n_steps: int, temps, generator, attn_impl: str,
                  mesh=None):
    """Shared body of the fused window (`decode_multi_paged` and its tp
    twin): ``n_steps`` decode passes, each sampled once on the tokens'
    device from ``generator``. → (tokens_out [n_steps, B] int32, pool)."""
    toks = tokens
    pos = positions.to(torch.int64)
    out = []
    for _ in range(n_steps):
        logits, pool = _decode_once_paged(cfg, params, toks, pool, pos,
                                          tables, attn_impl, mesh=mesh)
        toks, _scaled = _sample_next(logits, temps, generator)
        out.append(toks)
        pos = pos + 1
    return torch.stack(out), pool


def decode_multi_paged(cfg: GPTConfig, params, tokens, pool, positions,
                       tables, n_steps: int, temps, generator, *,
                       attn_impl: str = "gather"):
    """`n_steps` fused paged-decode steps with on-device sampling and no
    host round trip inside (the engine pre-allocates pages covering
    positions + n_steps, so tables are fixed across the window).
    → (tokens_out [n_steps, B] int32, pool)."""
    return _decode_multi(cfg, params, tokens, pool, positions, tables,
                         n_steps, temps, generator, attn_impl)


def _spec_propose(cfg: GPTConfig, params, tokens, pool, positions, tables,
                  n_prop, temps, generator, k: int, attn_impl: str,
                  need_probs: bool, mesh=None):
    """Shared body of the draft loop (`spec_draft_propose` and its tp
    twin): k+1 masked decode steps, each sampled once.
    → (proposals [k, B], probs [k, B, V] or None, pool)."""
    _check_impl(attn_impl)
    toks = tokens
    pos = positions.to(torch.int64)
    n_prop = n_prop.to(torch.int64)
    out, probs = [], []
    for i in range(k + 1):
        logits, pool = _decode_once_paged(cfg, params, toks, pool, pos,
                                          tables, attn_impl,
                                          write_mask=n_prop >= i, mesh=mesh)
        toks, scaled = _sample_next(logits, temps, generator)
        out.append(toks)
        if need_probs and i < k:
            probs.append(torch.softmax(scaled, dim=-1))
        pos = pos + 1
    return (torch.stack(out[:k]), torch.stack(probs) if need_probs else None,
            pool)


def spec_draft_propose(cfg: GPTConfig, params, tokens, pool, positions,
                       tables, n_prop, temps, generator, *, k: int,
                       attn_impl: str = "gather", need_probs: bool = True):
    """Fused speculative draft loop: k+1 draft decode steps with on-device
    sampling against the DRAFT's page pool (in place), sharing the
    target's page tables (the draft owns no pages: its pool rows at the
    same page ids mirror the target's token layout, so the target's
    allocation, COW, prefix sharing and rollback govern both).

    Step 0 feeds each slot's pending token at its decode cursor
    (``positions``); step i samples proposal d_i from the previous step's
    logits and feeds it at cursor + i, writing the draft's K/V there only
    where i <= n_prop (else to the null page). The extra (k+1)th step
    exists only for its write: it lands d_k's draft K/V at cursor + k, so
    after an all-accepted tick the draft cursor still equals the
    target's and no catch-up pass is needed.

    tokens: [B] pending token per slot; positions: [B]; n_prop: [B]
    proposal budget per slot (-1 = an inert row); temps: [B] (0 = greedy
    argmax); ``generator``: the torch.Generator the draws come from.
    → (proposals [k, B] int32, the temperature-scaled softmax rows they
    were drawn from [k, B, V] fp32 (what rejection sampling divides by)
    or None when ``need_probs`` is False, pool)."""
    return _spec_propose(cfg, params, tokens, pool, positions, tables,
                         n_prop, temps, generator, k, attn_impl, need_probs)


# ---------------------------------------------------- tensor parallelism
#
# The twins of the programs above over a tp mesh (`partition.make_tp_mesh`:
# a list of devices, one per shard). ``params`` and ``pool`` are lists of
# shards (`partition.shard_by_rules` with gpt.partition_rules and the
# rules below): each shard holds every page id for n_heads / tp heads, so
# page tables, cursors and the host-side allocator are shard-invariant and
# both attention implementations (the CUDA kernels derive H from the
# arrays) run unchanged on a shard's slice. The bodies are the ones above:
# each layer runs on every shard in lockstep, with the attention-out and
# MLP-down partial sums on shard 0's device and, for an int8 pool, the
# per-page scale's maximum across shards. Everything else — the
# embedding, the LM head, sampling from the engine's one generator — runs
# once, on shard 0's device, so a tp engine draws exactly the tp=1
# engine's noise. Index tensors (tokens, tables, cursors) are given on
# shard 0's device; the bodies copy them to the other shards' devices.

# Pool {"k", "v": [L, P+1, ps, H, K]} → heads (dim 3) split across
# shards. The int8 scale planes [L, P+1] are replicated: one per-page
# scalar covers every head, and _quant_write_shards keeps the copies equal.
KV_POOL_PARTITION_RULES = ((r"^(k|v)$", 3), (r"^(k|v)_scale$", None))


def prefill_chunk_paged_tp(cfg: GPTConfig, params, tokens, pool, tables,
                           offsets, n_valid, *, mesh,
                           return_logits: bool = True,
                           attn_impl: str = "gather"):
    """`prefill_chunk_paged` over a tp mesh; the LM head (replicated) runs
    once, on the summed hidden states."""
    _check_impl(attn_impl)
    x, pool = _chunk_paged_forward(cfg, params, tokens, pool, tables,
                                   offsets, n_valid, attn_impl, mesh=mesh)
    if not return_logits:
        return None, pool
    return _last_valid_logits(cfg, params[0], x, n_valid), pool


def verify_chunk_paged_tp(cfg: GPTConfig, params, tokens, pool, tables,
                          offsets, n_valid, *, mesh,
                          attn_impl: str = "gather"):
    """`verify_chunk_paged` over a tp mesh (the head at every position,
    once)."""
    _check_impl(attn_impl)
    x, pool = _chunk_paged_forward(cfg, params, tokens, pool, tables,
                                   offsets, n_valid, attn_impl, mesh=mesh)
    return _head(params[0], cfg, x), pool


def decode_step_paged_tp(cfg: GPTConfig, params, tokens, pool, positions,
                         tables, *, mesh, attn_impl: str = "gather"):
    """`decode_step_paged` over a tp mesh."""
    return _decode_once_paged(cfg, params, tokens, pool, positions, tables,
                              attn_impl, mesh=mesh)


def decode_multi_paged_tp(cfg: GPTConfig, params, tokens, pool, positions,
                          tables, n_steps: int, temps, generator, *, mesh,
                          attn_impl: str = "gather"):
    """`decode_multi_paged` over a tp mesh: every step's logits are
    sampled once, from ``generator``, as at tp=1."""
    return _decode_multi(cfg, params, tokens, pool, positions, tables,
                         n_steps, temps, generator, attn_impl, mesh=mesh)


def spec_draft_propose_tp(cfg: GPTConfig, params, tokens, pool, positions,
                          tables, n_prop, temps, generator, *, k: int, mesh,
                          attn_impl: str = "gather",
                          need_probs: bool = True):
    """`spec_draft_propose` over a tp mesh: the draft's shards on the
    target's mesh, sharing the target's (replicated) page tables."""
    return _spec_propose(cfg, params, tokens, pool, positions, tables,
                         n_prop, temps, generator, k, attn_impl, need_probs,
                         mesh=mesh)


def _pool_dims(pool_shard: dict) -> dict:
    return match_partition_rules(KV_POOL_PARTITION_RULES, pool_shard)


def copy_pages_tp(pool, src, dst, *, mesh):
    """`copy_pages` over a tp mesh: page ids are shard-invariant, so each
    shard copies its own head slice (and its scale copies) of the pages,
    IN PLACE. → pool."""
    devs = _pool_devices(pool, mesh)
    for shard, s, d in zip(pool, _on_devices(src, devs),
                           _on_devices(dst, devs)):
        copy_pages(shard, s, d)
    return pool


def gather_pages_tp(pool, pages, *, mesh):
    """`gather_pages` over a tp mesh → the FULL-head planes on shard 0's
    device: head-sharded planes concatenated in shard order, replicated
    scale planes from shard 0 (the payload a tp=1 pool gathers; the
    per-shard split for the wire is `partition.split_head_planes`)."""
    devs = _pool_devices(pool, mesh)
    parts = [gather_pages(shard, p)
             for shard, p in zip(pool, _on_devices(pages, devs))]
    out = {}
    for name, dim in _pool_dims(pool[0]).items():
        out[name] = (parts[0][name] if dim is None else torch.cat(
            [part[name].to(devs[0]) for part in parts], dim=dim))
    return out


def scatter_pages_tp(pool, pages, payload, *, mesh):
    """`scatter_pages` over a tp mesh: a FULL-head payload is re-sliced
    per this mesh (shard s writes its heads; replicated planes are
    written whole on every shard), IN PLACE. → pool."""
    devs = _pool_devices(pool, mesh)
    tp = len(pool)
    dims = _pool_dims(pool[0])
    for s, (shard, p) in enumerate(zip(pool, _on_devices(pages, devs))):
        piece = {name: (plane if dims[name] is None else torch.chunk(
            plane, tp, dim=dims[name])[s]).to(devs[s])
            for name, plane in payload.items()}
        scatter_pages(shard, p, piece)
    return pool


__all__ = [
    "init_paged_kv", "serving_params", "copy_pages", "gather_pages",
    "scatter_pages", "prefill_batch_paged", "prefill_chunk_paged",
    "verify_chunk_paged", "decode_step_paged", "decode_multi_paged",
    "spec_draft_propose", "KV_POOL_PARTITION_RULES",
    "prefill_chunk_paged_tp", "verify_chunk_paged_tp",
    "decode_step_paged_tp", "decode_multi_paged_tp", "copy_pages_tp",
    "gather_pages_tp", "scatter_pages_tp", "spec_draft_propose_tp",
]
