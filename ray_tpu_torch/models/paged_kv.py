"""Block-paged KV cache and the paged serving programs (PyTorch).

Counterpart of ``ray_tpu/models/paged_kv.py`` for the float pool on one
device: `init_paged_kv`, `_chunk_paged_forward`, `prefill_chunk_paged`,
`_decode_once_paged`, `decode_step_paged`, `decode_multi_paged`,
`_sample_next` and `_last_valid_logits`.

Layout (the JAX package's): one pool ``{"k", "v"}`` of
``[L, P+1, page_size, H, K]`` shared by all slots, plus per-slot page
tables ``[B, n_pg]`` of page ids. Page 0 is the reserved null page:
unallocated table entries point at it, masked writes are routed to it,
and every read of it is position-masked.

Differences from the JAX programs, all deliberate:

- The pool is updated IN PLACE (the JAX programs donate it through
  ``donate_argnums`` and return a new one). Every program still returns
  the pool so call sites read the same.
- PyTorch runs eagerly, so nothing here casts weights per call: the
  engine casts them once at load (`serving_params`), after which every
  ``Tensor.to(cfg.dtype)`` below returns the tensor itself.
- JAX clamps out-of-range gathers and drops out-of-range scatters
  silently; torch raises (CPU) or device-asserts (CUDA). The explicit
  clamps and null-page routing of the JAX code are kept, and every
  index here is in range by construction.
- `_last_valid_logits` selects each row's last valid hidden state
  BEFORE the LM head instead of after it: the head is row-wise, so the
  numbers are the same, without a [N, C, V] fp32 logits tensor.
"""

from __future__ import annotations

import math

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.decode import (_attn_out, _categorical, _head,
                                         _mlp, _qkv, _rotary_pos)
from ray_tpu_torch.models.gpt import (GPTConfig, _layer_norm,
                                      stack_block_params)
from ray_tpu_torch.ops.paged_attention import (
    paged_attention, paged_prefill_attention, reference_paged_attention,
    reference_paged_prefill_attention)

ATTN_IMPLS = ("gather", "kernel")


def init_paged_kv(cfg: GPTConfig, n_pages: int, page_size: int,
                  kv_dtype: str | None = None, device=None):
    """Shared page pool in ``cfg.dtype``. Row 0 is the null page (never
    allocated). Only the float pool is ported; ``kv_dtype="int8"``
    raises."""
    if kv_dtype not in (None, "bf16"):
        raise ValueError(f"kv_dtype {kv_dtype!r}: int8 KV pools not yet "
                         "ported (float pools only)")
    dev = resolve_device(device)
    shape = (cfg.n_layers, n_pages + 1, page_size, cfg.n_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def serving_params(cfg: GPTConfig, params: dict, device=None) -> dict:
    """Cast parameters ONCE for the paged programs: every leaf the JAX
    programs cast to ``cfg.dtype`` on each call (block params via
    ``stack_block_params(params, cfg.dtype)``, the embedding and the LM
    head) is stored in ``cfg.dtype``; the final layer norm keeps its
    stored dtype, as there. The programs' own casts then cost nothing.
    Tensors move to ``device`` (default cuda)."""
    dev = resolve_device(device)
    out = {}
    for name, w in params.items():
        if w.dtype == torch.int8:
            raise ValueError("int8 weights not yet ported")
        keep = name.startswith("ln_f_")
        out[name] = w.to(device=dev, dtype=None if keep else cfg.dtype)
    return out


def _check_impl(attn_impl: str) -> None:
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be gather|kernel, got {attn_impl!r}")


def _layer(stacked: dict, l: int) -> dict:
    return {k: v[l] for k, v in stacked.items()}


def _chunk_paged_forward(cfg: GPTConfig, params, tokens, pool, tables,
                         offsets, n_valid, attn_impl: str):
    """Shared chunk-row transformer body: write one [N, C] chunk batch
    into the page pool at per-row arbitrary offsets (in place) and attend
    causally over each slot's whole written prefix.
    → (hidden states [N, C, D], pool)."""
    N, C = tokens.shape
    ps = pool["k"].shape[2]
    dev = tokens.device
    x = params["wte"].to(cfg.dtype)[tokens]                  # [N, C, D]
    rel = torch.arange(C, device=dev, dtype=torch.int64)
    offsets = offsets.to(torch.int64)
    n_valid = n_valid.to(torch.int64)
    pos = offsets[:, None] + rel[None, :]                    # [N, C]
    stacked = stack_block_params(params, cfg.dtype)
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
    offsets32 = offsets.to(torch.int32)
    tables32 = tables.to(torch.int32)

    for l in range(cfg.n_layers):
        layer = _layer(stacked, l)
        h = _layer_norm(x, layer["ln1_scale"], layer["ln1_bias"])
        q, k, v = _qkv(h, layer, cfg)
        q = _rotary_pos(q, cfg.rotary_dim, pos)
        k = _rotary_pos(k, cfg.rotary_dim, pos)
        # Write before attending (same order as the decode path): each
        # row then reads its own chunk's K/V back through its table, so
        # intra-chunk causality is just the tpos <= qpos mask. Pad rows
        # all land on null-page slots, possibly several on the same one:
        # which duplicate wins is undefined on CUDA, and harmless only
        # because page 0 is never read unmasked.
        k_pool_l, v_pool_l = pool["k"][l], pool["v"][l]
        k_pool_l[write_pages, write_offs] = (
            k.reshape(N * C, *k.shape[2:]).to(cfg.dtype))
        v_pool_l[write_pages, write_offs] = (
            v.reshape(N * C, *v.shape[2:]).to(cfg.dtype))
        fn = (paged_prefill_attention if attn_impl == "kernel"
              else reference_paged_prefill_attention)
        attn = fn(q.contiguous(), k_pool_l, v_pool_l, tables32, offsets32,
                  kv_lens, sm_scale=scale)
        x = x + _attn_out(attn, layer, cfg)
        x = _mlp(x, layer, cfg)
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


def _decode_once_paged(cfg: GPTConfig, params, tokens, pool, positions,
                       tables, attn_impl: str = "gather", write_mask=None):
    """All B slots advance one token against the page pool (in place).

    tokens: [B]; positions: [B]; tables: [B, n_pg]; `write_mask` ([B]
    bool, optional) routes masked rows' K/V writes to the null page.
    → (logits [B, V] fp32, pool)."""
    _check_impl(attn_impl)
    ps = pool["k"].shape[2]
    positions = positions.to(torch.int64)
    x = params["wte"].to(cfg.dtype)[tokens][:, None, :]      # [B, 1, D]
    pos = positions[:, None]
    stacked = stack_block_params(params, cfg.dtype)
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
    tables32 = tables.to(torch.int32)

    for l in range(cfg.n_layers):
        layer = _layer(stacked, l)
        h = _layer_norm(x, layer["ln1_scale"], layer["ln1_bias"])
        q, k, v = _qkv(h, layer, cfg)
        q = _rotary_pos(q, cfg.rotary_dim, pos)
        k = _rotary_pos(k, cfg.rotary_dim, pos)
        # Idle slots (all-null tables) may write the same null-page slot;
        # the order is undefined on CUDA and harmless (page 0 is masked).
        k_pool_l, v_pool_l = pool["k"][l], pool["v"][l]
        k_pool_l[write_page, write_off] = k[:, 0].to(cfg.dtype)
        v_pool_l[write_page, write_off] = v[:, 0].to(cfg.dtype)
        fn = (paged_attention if attn_impl == "kernel"
              else reference_paged_attention)
        attn = fn(q[:, 0].contiguous(), k_pool_l, v_pool_l, tables32,
                  kv_lengths, sm_scale=scale)
        x = x + _attn_out(attn, layer, cfg)[:, None, :]
        x = _mlp(x, layer, cfg)
    logits = _head(params, cfg, x)[:, 0]
    return logits, pool


def _sample_next(logits, temps, generator: torch.Generator):
    """On-device sampling step of the fused window: greedy argmax at
    temp <= 0, else a temperature-scaled categorical draw from
    ``generator`` (a torch.Generator on the logits' device).
    → (next tokens int32, scaled logits)."""
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
    greedy = torch.argmax(logits, dim=-1)
    sampled = _categorical(scaled, generator)
    nxt = torch.where(temps <= 0.0, greedy, sampled).to(torch.int32)
    return nxt, scaled


def decode_step_paged(cfg: GPTConfig, params, tokens, pool, positions,
                      tables, *, attn_impl: str = "gather"):
    """One token for every slot against the paged pool (in place).
    → (logits [B, V] fp32, pool)."""
    return _decode_once_paged(cfg, params, tokens, pool, positions, tables,
                              attn_impl)


def decode_multi_paged(cfg: GPTConfig, params, tokens, pool, positions,
                       tables, n_steps: int, temps, generator, *,
                       attn_impl: str = "gather"):
    """`n_steps` fused paged-decode steps with on-device sampling and no
    host round trip inside (the engine pre-allocates pages covering
    positions + n_steps, so tables are fixed across the window).
    → (tokens_out [n_steps, B] int32, pool)."""
    toks = tokens
    pos = positions.to(torch.int64)
    out = []
    for _ in range(n_steps):
        logits, pool = _decode_once_paged(cfg, params, toks, pool, pos,
                                          tables, attn_impl)
        toks, _scaled = _sample_next(logits, temps, generator)
        out.append(toks)
        pos = pos + 1
    return torch.stack(out), pool


__all__ = [
    "init_paged_kv", "serving_params", "prefill_chunk_paged",
    "decode_step_paged", "decode_multi_paged",
]
