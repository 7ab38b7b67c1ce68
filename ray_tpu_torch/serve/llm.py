"""Continuous-batching LLM engine (PyTorch/CUDA).

Counterpart of ``ray_tpu/serve/llm.py``'s `LLMEngine`. A fixed pool of
slots advances one fused decode window per tick. Two KV layouts and two
admission modes, with the reference's defaults (dense, one-shot):

- ``kv_mode="dense"`` (default): a ``[L, n_slots, max_len, H, K]``
  cache (``models/decode.py``); each decode step attends over a slot's
  whole row. Plain PyTorch math, as the reference's is plain XLA.
- ``kv_mode="paged"``: a shared page pool with per-slot page tables
  (``models/paged_kv.py``), read by the CUDA paged-attention kernels.
- ``prefill_chunk=0`` (default): one-shot bucketed admission. A prompt
  is padded to the smallest of ``prefill_buckets`` that holds it, and
  same-bucket arrivals prefill together in groups of 8, 4, 2 or 1 (one
  `prefill_batch`/`prefill_batch_paged` dispatch each; plain causal
  prompt attention, then whole-page writes in paged mode); the first
  token is sampled on the host.
- ``prefill_chunk > 0`` (paged only): prompts enter their slot's page
  table chunk by chunk under a per-tick prefill token budget
  (Sarathi/Orca-style stall-free batching), width-bucketed by the pow-2
  page width each chunk attends over.

The host-side scheduler, page refcounts and page accounting are the same
numpy logic as the JAX engine's; only the device programs differ.

Quantized serving (paged only) is the JAX engine's:
``weight_dtype="int8"`` quantizes the matmul planes per output channel
at load (from the masters as given, before the cast to ``cfg.dtype``),
and ``kv_dtype="int8"`` keeps an int8 page pool with per-page scale
planes, read by the int8 programs of the paged-attention kernels; either
alone or both.

``prefix_cache=True`` (paged, chunked) shares KV pages across requests
(``serve/prefix_cache.py``): admission binds the longest cached
chunk-aligned prefix into the slot's table read-only, copies a tail
page that the cold suffix would write (copy-on-write, one `copy_pages`
per tick, before any dispatch) and starts chunked prefill at the first
cold token; a request that completes donates its written prefix.

``spec_draft=...`` (paged, chunked) decodes speculatively: a draft model
with its own page pool, sharing the target's page tables, proposes
``spec_k`` tokens per slot per tick in one fused loop
(`spec_draft_propose`), the target scores all of them in one
chunked-prefill verify pass (`verify_chunk_paged`), and rejection
sampling (`spec_accept_tokens`) accepts a prefix plus one correction or
bonus token. Greedy streams equal non-speculative decode's.

The drain protocol runs in every mode: `drain` stops admission, lets
in-flight requests finish within its window and exports the rest as
continuations (`_export_unfinished`); `submit(..., generated_ids=...)`
resumes one by teacher-forcing the tokens already emitted, so a greedy
resume is byte-identical to the uninterrupted run and the stream cursor
splices exactly.

Lifecycle and observability, as the JAX engine's: `warmup_compile`
(``warmup=True`` runs it at `start`) loads the kernel library and walks
the chunk program's width ladder with inert dispatches, so no live
request pays the first touch; `load_snapshot` is the router's load row
(queue, slots, pool, the TTFT / decode-rate / prefill-budget /
acceptance EWMAs) and sets the ``llm_*`` gauges; the engine's histograms
and counters (`ray_tpu_torch.profiling`, read with `metrics_snapshot` /
`prometheus_text`), its sampled spans (``llm.decode_window``,
``llm.spec_verify``, ``llm.ttft`` with three children;
`ray_tpu_torch.tracing`) and the chaos point ``llm.decode_window``
(`ray_tpu_torch.chaos`) carry the reference's names.

A paged slot whose cursor reached ``max_len`` finishes truncated before
the tick fits its window pages, as the dense engine's does. The JAX
paged engine instead grows such a slot one page past its table when
``max_len`` is a multiple of the page size and its engine thread dies.

``tp > 1`` (paged, chunked) serves tensor-parallel, single-controller
as the JAX engine does: one process holds one parameter dict and one
page pool per shard on a mesh of ``tp`` devices (``device`` as a list
of them, a device may repeat; else the first ``tp`` CUDA devices, or
``tp`` times the CPU with ``device="cpu"``), sharded once at load by
``gpt.partition_rules`` and ``paged_kv.KV_POOL_PARTITION_RULES``
(heads of attention and pool, the MLP's hidden width), and every paged
dispatch goes through the programs' ``*_tp`` twins. Page ids, tables,
cursors and the scheduler are shard-invariant; sampling runs once, on
the engine's one generator, so the streams are the tp=1 engine's up to
the rounding of the cross-shard sums.

KV page-set transfer (``kv_transfer=True``, ``pool_role="prefill"`` or
``"decode"``, ``kv_store``; paged, chunked, ``prefill_chunk %
page_size == 0``) is the JAX engine's object tier on the port's
in-process store (`serve/kv_objects.py`): a completing request (fused
engines), a prefill-role engine at its first token, and `drain`'s export
donate their written chunk-aligned prefix, one entry per chain depth,
gathered from the pool (`gather_pages`, `gather_pages_tp`) into host
tensors in the pool's dtype; an admission whose ``kv`` descriptor (or
``{"discover": True}`` hint) resolves deeper than its local prefix-cache
hit fetches the payloads, writes them into fresh pages (`scatter_pages`,
`scatter_pages_tp`, a tp > 1 donor's head shards joined first) and
starts prefill at the first cold token. A dropped or torn depth adopts
the shorter run; nothing adopted re-prefills from token ids.

Not ported: the Serve deployment wrapper, the cluster page-set store,
the global ``llm_kv_transfer`` knob and its soft-disable (an explicit
argument that misfits raises, as in the reference), and the
compile-watch hooks (XLA compile accounting, which has no counterpart
here).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import logging
import math
import os
import queue
import threading
import time
import types
import uuid

import numpy as np
import torch

from ray_tpu_torch import chaos as _chaos
from ray_tpu_torch import profiling as _profiling
from ray_tpu_torch import tracing
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models import decode as _dense
from ray_tpu_torch.models import gpt
from ray_tpu_torch.models import paged_kv as _paged
from ray_tpu_torch.models import partition as _partition
from ray_tpu_torch.models.decode import sample_token
from ray_tpu_torch.ops import _build
from ray_tpu_torch.serve import kv_objects as _kvo
from ray_tpu_torch.serve.prefix_cache import (PrefixCache, affinity_key,
                                              extend_chunk_chain)

logger = logging.getLogger(__name__)

# Engine defaults, copied from the JAX package's runtime config and its
# engine's signature (prefill buckets).
DEFAULT_DECODE_BLOCK = 8
DEFAULT_KV_MODE = "dense"
DEFAULT_PAGE_SIZE = 64
DEFAULT_PREFILL_BUCKETS = (32, 64, 128, 256, 512)
DEFAULT_PREFILL_CHUNK = 0          # 0 = one-shot bucketed admission
DEFAULT_PREFILL_TOKEN_BUDGET = 256
DEFAULT_WIDTH_BUCKETING = True
DEFAULT_PREFIX_CACHE_PAGES = 0     # 0 = half the pool
DEFAULT_SPEC_K = 4

# The JAX engine's metric objects, with its names, tags and buckets, so a
# port replica's /metrics rows read like a JAX replica's. Per-request
# histograms, tagged by ingress route (trace baggage) and replica:
_TTFT_HIST = _profiling.Histogram(
    "serve_llm_ttft_s",
    description="LLM time-to-first-token (queue wait + prefill)",
    boundaries=_profiling.LATENCY_BUCKETS_S,
    tag_keys=("route", "replica"))
_DECODE_HIST = _profiling.Histogram(
    "serve_llm_decode_tok_s",
    description="LLM per-request decode throughput (tokens/s after TTFT)",
    boundaries=(1, 5, 10, 25, 50, 100, 250, 500, 1000, 2500),
    tag_keys=("route", "replica"))
# Engine-side decode step latency (window wall / tokens per slot), tagged
# by KV layout and attention implementation.
_DECODE_STEP_HIST = _profiling.Histogram(
    "serve_llm_decode_step_s",
    description="LLM engine per-token decode step latency (window / k)",
    boundaries=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0, 2.5),
    tag_keys=("replica", "impl"))
# Per-dispatch chunked-prefill latency: the decode stall the token budget
# bounds is one of these per budget's worth of tokens.
_PREFILL_CHUNK_HIST = _profiling.Histogram(
    "serve_llm_prefill_chunk_s",
    description="LLM chunked-prefill per-chunk dispatch latency",
    boundaries=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0, 2.5),
    tag_keys=("replica", "impl"))
# One increment per chunk dispatch, tagged by its pow-2 table width.
_PREFILL_DISPATCH_COUNTER = _profiling.Counter(
    "llm_prefill_dispatch_total",
    description="LLM chunked-prefill dispatches by page-table width",
    tag_keys=("replica", "width"))

# Live engine-load gauges, set on every load_snapshot() call.
_LOAD_GAUGES = {
    key: _profiling.Gauge(f"llm_{key}", description=desc,
                          tag_keys=("replica",))
    for key, desc in (
        ("queue_depth", "LLM requests queued (pending + deferred)"),
        ("active_slots", "LLM slots bound to a request"),
        ("prefilling_slots", "LLM slots still streaming their prompt in"),
        ("pool_pages_free", "KV page-pool free pages"),
        ("pool_pages_total", "KV page-pool size"),
        ("prefill_budget_util",
         "EWMA of per-tick prefill-budget utilization"),
        ("ttft_ewma_ms", "EWMA of time-to-first-token (ms)"),
        ("decode_tok_s_ewma", "EWMA of fused-window decode rate (tok/s)"),
        ("prefix_cache_pages",
         "KV pages currently pinned by prefix-cache entries"),
        ("prefix_cache_hit_rate",
         "Prefix-cache admission hit rate since last stats reset"),
        ("spec_accepted_per_step",
         "EWMA of tokens emitted per slot per speculative verify pass"),
        ("prefill_dispatch_width_p50",
         "Median page-table width of recent chunk dispatches"),
        ("prefill_dispatch_width_max",
         "Max page-table width of recent chunk dispatches"),
    )
}

# Speculative decoding: cumulative proposals and acceptances.
_SPEC_COUNTERS = {
    name: _profiling.Counter(
        f"llm_spec_{name}_total", description=desc, tag_keys=("replica",))
    for name, desc in (
        ("proposed", "Draft tokens proposed to speculative verification"),
        ("accepted", "Draft proposals the target model accepted"),
    )
}

# Prefix-cache lifecycle counters.
_PREFIX_COUNTERS = {
    name: _profiling.Counter(
        f"llm_prefix_cache_{name}_total", description=desc,
        tag_keys=("replica",))
    for name, desc in (
        ("hits", "Admissions that bound a cached prefix"),
        ("misses", "Admissions with no cached prefix"),
        ("evictions", "Prefix-cache entries evicted (LRU / pressure)"),
        ("cow_copies", "Copy-on-write page duplications at bind time"),
    )
}

# KV page-set lifecycle counters: donations out of this engine, adoptions
# binding donated pages instead of re-prefilling, and ladder falls to the
# re-prefill rung.
_KV_COUNTERS = {
    name: _profiling.Counter(
        f"llm_kv_{name}_total", description=desc, tag_keys=("replica",))
    for name, desc in (
        ("donations", "KV page-set objects donated to the object store"),
        ("adoptions", "Admissions that adopted donated KV pages"),
        ("adopt_failures",
         "Adoption attempts that fell to the re-prefill rung"),
    )
}


def _request_metric_tags() -> dict:
    """Route (ingress trace baggage) and replica tags for the per-request
    histograms. The port has no runtime context, so the replica is
    "local", the reference's value outside an actor."""
    ctx = tracing.get_current()
    route = (ctx.baggage.get("route", "") if ctx is not None else "") or ""
    return {"route": route, "replica": "local"}


def _observe_request_metrics(req: "GenRequest", tags: dict) -> None:
    """A finished request's TTFT and decode rate into the per-request
    histograms (a serving front end calls it once per request)."""
    if req.first_token_at is not None:
        _TTFT_HIST.observe(req.first_token_at - req.submitted_at, tags=tags)
    if (req.finished_at is not None and req.first_token_at is not None
            and len(req.out_ids) > 1):
        decode_s = req.finished_at - req.first_token_at
        if decode_s > 0:
            _DECODE_HIST.observe((len(req.out_ids) - 1) / decode_s,
                                 tags=tags)


def _pow2_width(n: int) -> int:
    """Smallest power of two >= max(1, n): the width-bucketing rule for
    page-table views (chunk dispatches and the decode table view)."""
    width = 1
    while width < n:
        width *= 2
    return width


def _ring_pctls(ring) -> tuple[float, float]:
    """(p50, p95) of a bounded sample ring, rounded for JSON metrics."""
    s = sorted(ring)
    return (round(s[len(s) // 2], 3),
            round(s[max(0, math.ceil(len(s) * 0.95) - 1)], 3))


def _softmax_f64(row: np.ndarray) -> np.ndarray:
    z = row.astype(np.float64)
    z -= z.max()
    e = np.exp(z)
    return e / e.sum()


def spec_accept_tokens(rng, temperature: float, proposals, draft_probs,
                       verify_logits, n_prop: int, *,
                       verify_argmax=None) -> tuple[list[int], int]:
    """Speculative rejection sampling for ONE slot (Leviathan-style), the
    JAX engine's host numpy as it is: accept draft proposal x_i with
    probability min(1, p_i(x_i) / q_i(x_i)); on the first rejection emit
    one sample from the residual norm(max(p_i - q_i, 0)); after n_prop
    straight acceptances emit a bonus token from the target's next
    distribution. The emitted marginal at every position is exactly p,
    for any proposal distribution q.

    Greedy (temperature 0) is argmax-chain matching: every emitted token
    is the argmax of the target's own logits at its position, so the
    stream equals non-speculative greedy decode's however bad the draft.

    proposals: [>= n_prop] draft tokens; draft_probs: [>= n_prop, V] the
    temperature-scaled distributions they were sampled from (q);
    verify_logits: [>= n_prop+1, V] target logits, row i scoring the
    token after chunk position i; verify_argmax: optional [>= n_prop+1]
    per-row argmax, all the greedy branch needs (an all-greedy tick
    copies only this to the host). rng: a numpy Generator.
    → (emitted tokens, length 1..n_prop+1; accepted proposal count)."""
    emitted: list[int] = []
    if temperature == 0.0:
        if verify_argmax is None:
            verify_argmax = [int(np.argmax(verify_logits[i]))
                             for i in range(n_prop + 1)]
        for i in range(n_prop):
            tgt = int(verify_argmax[i])
            emitted.append(tgt)
            if int(proposals[i]) != tgt:
                return emitted, i
        emitted.append(int(verify_argmax[n_prop]))
        return emitted, n_prop
    for i in range(n_prop):
        x = int(proposals[i])
        p = _softmax_f64(verify_logits[i] / temperature)
        q = draft_probs[i].astype(np.float64)
        if rng.random() * max(float(q[x]), 1e-30) < float(p[x]):
            emitted.append(x)
            continue
        resid = np.maximum(p - q, 0.0)
        z = resid.sum()
        # A vanishing residual means p ≈ q, where acceptance is ~certain
        # anyway: falling back to p keeps the marginal exact.
        pr = resid / z if z > 1e-12 else p
        emitted.append(int(rng.choice(len(pr), p=pr)))
        return emitted, i
    p = _softmax_f64(verify_logits[n_prop] / temperature)
    emitted.append(int(rng.choice(len(p), p=p)))
    return emitted, n_prop


@dataclasses.dataclass
class GenRequest:
    request_id: str
    prompt_ids: list[int]
    max_tokens: int
    temperature: float
    eos_id: int | None
    submitted_at: float
    # Original prompt length: prompt_ids grows past it on preemption
    # (recompute context = prompt + generated).
    n_prompt: int = 0
    first_token_at: float | None = None
    finished_at: float | None = None
    # TTFT breakdown: first and last prefill dispatch of this request
    # (one-shot prefill sets both around its one dispatch).
    first_chunk_at: float | None = None
    last_chunk_at: float | None = None
    # Admission aging (starvation guard), as in the JAX engine.
    admit_bypasses: int = 0
    # Prefix-cache hit at admission: tokens served from cached pages
    # (prefill started at this offset); the warm/cold TTFT split reads it.
    cached_tokens: int = 0
    # Memoized chunk-hash chain over prompt_ids (contexts only grow, so
    # a page-blocked request hashes each chunk once).
    prefix_hashes: list = dataclasses.field(default_factory=list)
    # Page-set adoption hint: a donor's descriptor ({"keys", "chunk",
    # "page_size", "fingerprint", "n_tokens"}) or {"discover": True};
    # None = cold path. Admission tries the adoption ladder against it.
    kv: dict | None = None
    # The adoption plan, resolved ONCE per request (a page-blocked
    # request is re-scanned every admission round); a stale plan costs a
    # rung at bind time, never correctness.
    kv_plan: dict | None = None
    kv_plan_tried: bool = False
    # Set when THIS request's pages were donated on handoff or export:
    # the descriptor its continuation carries to the next engine.
    kv_handoff: dict | None = None
    out_ids: list[int] = dataclasses.field(default_factory=list)
    truncated: bool = False   # finished early (capacity/unresumable preempt)
    # Exported by drain(): the stream ended here and the continuation
    # (prompt, generated) resumes on another engine.
    migrated: bool = False
    stream: "queue.Queue | None" = None
    done: "threading.Event" = dataclasses.field(
        default_factory=threading.Event)
    error: str | None = None


class LLMEngine:
    """Slot-based continuous batching over ray_tpu_torch.models.decode
    (dense) or ray_tpu_torch.models.paged_kv (paged).

    Runs on ``device`` (default cuda; a missing GPU raises unless
    ``device="cpu"``). ``kv_mode`` "dense" or "paged"; ``prefill_chunk``
    0 (one-shot, over ``prefill_buckets`` clamped below ``max_len``) or
    the chunk size (paged only). ``attn_impl`` (paged only): "kernel"
    (the CUDA paged-attention kernels), "gather" (their plain PyTorch
    versions) or "auto" (kernel on CUDA, gather on the CPU).
    ``weight_dtype`` and ``kv_dtype`` are "bf16" (float, in
    ``cfg.dtype``) or "int8" (paged only). Parameters are quantized
    (int8 weights), cast to ``cfg.dtype`` and moved to the device once,
    here. ``prefix_cache``/``prefix_cache_pages`` (0 = half the pool)
    turn on page sharing; ``spec_draft`` (a GPTConfig or a preset name)
    with ``spec_k`` and optional ``spec_draft_params`` (else random from
    ``seed + 1``) turns on speculative decoding. ``warmup`` runs
    `warmup_compile` in `start`, before the engine thread spawns.
    ``tp`` > 1 (paged, chunked) shards the engine over a mesh of tp
    devices (``device`` a list of them, or see `_placement`); ``mesh``
    is that list (None at tp=1) and ``params``, ``cache``,
    ``draft_params`` and ``draft_cache`` are then lists of shards.
    ``kv_transfer`` (paged, chunked, chunk a multiple of the page size)
    donates and adopts KV page sets through ``kv_store`` (default the
    process-global `kv_objects.get_store`); ``pool_role`` "prefill"
    hands each request off at its first token with its pages donated,
    "decode" adopts and never donates on release; either turns
    ``kv_transfer`` on, and an explicit ``kv_transfer=False`` with a
    role raises.
    """

    def __init__(self, cfg, params=None, *, n_slots: int = 8,
                 max_len: int = 2048, seed: int = 0,
                 prefill_buckets: tuple[int, ...] = DEFAULT_PREFILL_BUCKETS,
                 decode_block: int = DEFAULT_DECODE_BLOCK,
                 kv_mode: str = DEFAULT_KV_MODE,
                 page_size: int = DEFAULT_PAGE_SIZE,
                 n_pages: int | None = None, attn_impl: str = "auto",
                 prefill_chunk: int = DEFAULT_PREFILL_CHUNK,
                 prefill_token_budget: int = DEFAULT_PREFILL_TOKEN_BUDGET,
                 prefill_width_bucketing: bool = DEFAULT_WIDTH_BUCKETING,
                 device=None,
                 prefix_cache: bool = False,
                 prefix_cache_pages: int = DEFAULT_PREFIX_CACHE_PAGES,
                 spec_draft=None, spec_k: int = DEFAULT_SPEC_K,
                 spec_draft_params=None, tp: int = 1,
                 pool_role: str | None = None,
                 kv_transfer: bool | None = None,
                 kv_store=None, weight_dtype: str = "bf16",
                 kv_dtype: str = "bf16", warmup: bool = False):
        paged_chunked = kv_mode == "paged" and bool(prefill_chunk)
        if prefix_cache and not paged_chunked:
            raise ValueError(
                "prefix_cache requires kv_mode='paged' AND prefill_chunk > 0 "
                "(the cache granularity is the prefill chunk); got "
                f"kv_mode={kv_mode!r}, prefill_chunk={prefill_chunk}")
        if prefix_cache_pages < 0:
            raise ValueError(
                f"prefix_cache_pages must be >= 0, got {prefix_cache_pages}")
        if spec_draft and not paged_chunked:
            raise ValueError(
                "speculative decoding requires kv_mode='paged' AND "
                "prefill_chunk > 0 (the verify pass is a chunked-prefill "
                f"row); got kv_mode={kv_mode!r}, prefill_chunk={prefill_chunk}")
        if spec_draft_params is not None and not spec_draft:
            raise ValueError(
                "spec_draft_params supplied but speculative decoding is not "
                "enabled (set spec_draft)")
        draft_cfg = None
        if spec_draft:
            if spec_k < 1:
                raise ValueError(
                    f"spec_k must be >= 1 (tokens the draft proposes per "
                    f"slot per tick), got {spec_k}")
            draft_cfg = (spec_draft if isinstance(spec_draft, gpt.GPTConfig)
                         else gpt.GPTConfig.by_name(spec_draft))
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    "speculative draft/target vocab mismatch: draft "
                    f"vocab_size {draft_cfg.vocab_size} != target vocab_size "
                    f"{cfg.vocab_size} (the tokenizer must be tied)")
        # KV page-set transfer: the JAX engine's validation of explicit
        # arguments (the port has no global knob to soft-disable).
        if pool_role not in (None, "", "prefill", "decode"):
            raise ValueError(
                f"pool_role must be None|'prefill'|'decode', "
                f"got {pool_role!r}")
        pool_role = pool_role or None
        if pool_role is not None and kv_transfer is not None and (
                not kv_transfer):
            raise ValueError(
                f"pool_role={pool_role!r} requires kv_transfer — the "
                "prefill→decode handoff IS a page-set donation + "
                "adoption")
        kv_transfer = bool(kv_transfer) or pool_role is not None
        if kv_transfer and not (paged_chunked
                                and prefill_chunk % page_size == 0):
            # Entries are deduped per chain depth across donations; only
            # page-aligned depths make a chain composed from different
            # donations self-contained.
            raise ValueError(
                "KV page-set transfer requires kv_mode='paged' and "
                "prefill_chunk > 0 with prefill_chunk % page_size == 0 "
                "(cross-donation dedup needs page-aligned chain "
                f"depths); got kv_mode={kv_mode!r}, "
                f"prefill_chunk={prefill_chunk}, page_size={page_size}")
        self.pool_role = pool_role
        self.kv_transfer = kv_transfer
        # Tensor parallelism: the JAX engine's validation of explicit
        # arguments (the port has no global knob to soft-disable).
        tp = int(tp)
        if tp < 1:
            raise ValueError(f"llm_tp must be >= 1, got {tp}")
        if tp > 1 and not paged_chunked:
            raise ValueError(
                "tensor-parallel decode requires kv_mode='paged' AND "
                "prefill_chunk > 0 (the sharded programs are the paged "
                f"chunked set); got kv_mode={kv_mode!r}, "
                f"prefill_chunk={prefill_chunk}")
        self.mesh, self.device = self._placement(tp, device)
        if tp > 1:
            if cfg.n_heads % tp or cfg.d_ff % tp:
                raise ValueError(
                    f"llm_tp={tp} must divide the model's n_heads "
                    f"({cfg.n_heads}) and d_ff ({cfg.d_ff}) — the KV pool "
                    "shards along the head axis and the MLP along its "
                    "hidden width")
            if draft_cfg is not None and (
                    draft_cfg.n_heads % tp or draft_cfg.d_ff % tp):
                raise ValueError(
                    f"llm_tp={tp} must divide the DRAFT model's n_heads "
                    f"({draft_cfg.n_heads}) and d_ff ({draft_cfg.d_ff}) "
                    "— the draft pool shards along the same head axis")
        self.tp = tp
        if kv_mode not in ("dense", "paged"):
            raise ValueError(f"kv_mode must be dense|paged, got {kv_mode!r}")
        if weight_dtype not in ("bf16", "int8"):
            raise ValueError(
                f"weight_dtype must be bf16|int8, got {weight_dtype!r}")
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype must be bf16|int8, got {kv_dtype!r}")
        if weight_dtype == "int8" and kv_mode != "paged":
            raise ValueError(
                "weight_dtype='int8' requires kv_mode='paged' (quantized "
                "serving targets the paged engine; the dense path is "
                f"unquantized); got kv_mode={kv_mode!r}")
        if kv_dtype == "int8" and kv_mode != "paged":
            raise ValueError(
                "kv_dtype='int8' requires kv_mode='paged' (the scale planes "
                "ride the page tables; the dense cache has none); got "
                f"kv_mode={kv_mode!r}")
        if attn_impl == "auto":
            # Resolved once: the kernels on CUDA, their plain versions on
            # the CPU (where a CUDA kernel cannot run at all).
            attn_impl = "kernel" if self.device.type == "cuda" else "gather"
        if attn_impl not in _paged.ATTN_IMPLS:
            raise ValueError(
                f"attn_impl must be gather|kernel|auto, got {attn_impl!r}")
        if prefill_chunk < 0 or (prefill_chunk and kv_mode != "paged"):
            raise ValueError(
                "prefill_chunk requires kv_mode='paged' (chunked prefill "
                f"grows page tables chunk-by-chunk); got chunk="
                f"{prefill_chunk} with kv_mode={kv_mode!r}")
        if prefill_chunk > max_len:
            raise ValueError(
                f"prefill_chunk ({prefill_chunk}) exceeds the KV cache "
                f"(max_len = {max_len})")
        if prefill_chunk and prefill_token_budget != 0 and (
                prefill_token_budget < prefill_chunk):
            raise ValueError(
                f"prefill_token_budget ({prefill_token_budget}) must be 0 "
                f"(pure-decode ticks) or >= prefill_chunk ({prefill_chunk})")
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        # Buckets clamp below the cache: _bucket() rounds a prompt UP, so
        # a bucket >= max_len would write past the dense cache.
        self.buckets = tuple(sorted(b for b in prefill_buckets
                                    if b < max_len)) or (max(1, max_len - 1),)
        self.kv_mode = kv_mode
        self.attn_impl = attn_impl
        self.weight_dtype = weight_dtype
        self.kv_dtype = kv_dtype
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = gpt.init_params(cfg, gen, self.device)
        if weight_dtype == "int8":
            # Quantize the masters BEFORE the cast to cfg.dtype, as the JAX
            # engine quantizes its own (float32) params: bf16-rounded
            # weights give other int8 codes. Idempotent on int8 planes.
            params = gpt.quantize_params(params)
        self.params = _paged.serving_params(cfg, params, self.device)
        self.prefill_width_bucketing = bool(prefill_width_bucketing)
        self.prefill_chunk = prefill_chunk
        self.prefill_budget = prefill_token_budget
        # Chunked prompts are bound by the cache alone; one-shot prompts
        # also by the largest bucket.
        self._prompt_cap = (max_len - 1 if prefill_chunk
                            else min(self.buckets[-1], max_len - 1))
        if kv_mode == "paged":
            self.page_size = page_size
            self.max_pages_per_slot = self._pages_for(max_len - 1)
            if n_pages is None:
                n_pages = max(self.max_pages_per_slot + 1,
                              (n_slots * self.max_pages_per_slot) // 2)
            self.n_pages = n_pages
            self.cache = _paged.init_paged_kv(cfg, n_pages, page_size,
                                              kv_dtype=kv_dtype,
                                              device=self.device)
            self.page_table = np.zeros((n_slots, self.max_pages_per_slot),
                                       np.int32)
            self.slot_n_pages = np.zeros(n_slots, np.int64)
            # pop() hands out ascending ids; 0 stays reserved (null page).
            self.free_pages = list(range(n_pages, 0, -1))
            # Per-page refcounts: slots' tables AND prefix-cache entries
            # each hold one; a page returns to free_pages at the LAST ref.
            self.page_refs = np.zeros(n_pages + 1, np.int32)
            self._min_free_pages = n_pages
        else:
            self.cache = _dense.init_kv_cache(cfg, n_slots, max_len,
                                              device=self.device)
        # Speculative decoding: the draft keeps its OWN page pool (shaped
        # to the draft config) but shares the target's page TABLES and
        # cursors: draft pool row p mirrors target pool row p token for
        # token (chunk prefill, decode writes and COW copies are all
        # mirrored), so the target's page accounting, prefix sharing and
        # rollback govern both and the draft holds no reference.
        self.spec_k = int(spec_k) if spec_draft else 0
        self.spec_draft_name = (spec_draft if isinstance(spec_draft, str)
                                else "custom" if spec_draft else "")
        self.draft_cfg = draft_cfg
        self.draft_params = self.draft_cache = None
        if spec_draft:
            if spec_draft_params is None:
                gen = torch.Generator(device=self.device).manual_seed(
                    seed + 1)
                spec_draft_params = gpt.init_params(draft_cfg, gen,
                                                    self.device)
            if weight_dtype == "int8":
                spec_draft_params = gpt.quantize_params(spec_draft_params)
            self.draft_params = _paged.serving_params(
                draft_cfg, spec_draft_params, self.device)
            self.draft_cache = _paged.init_paged_kv(
                draft_cfg, n_pages, page_size, kv_dtype=kv_dtype,
                device=self.device)
            # Acceptance draws (temperature > 0) gate host control flow
            # (emit, rollback): a host numpy generator, as in the JAX engine.
            self._spec_rng = np.random.default_rng(seed)
        if self.mesh is not None:
            # Shard ONCE at load, after the quantization above (the rules
            # shard the int8 scale companions with their planes): params
            # and pools of the target and the draft, on one mesh (the
            # draft reads the target's tables).
            shard = _partition.shard_by_rules
            self.params = shard(self.mesh, gpt.partition_rules(),
                                self.params)
            self.cache = shard(self.mesh, _paged.KV_POOL_PARTITION_RULES,
                               self.cache)
            if spec_draft:
                self.draft_params = shard(self.mesh, gpt.partition_rules(),
                                          self.draft_params)
                self.draft_cache = shard(
                    self.mesh, _paged.KV_POOL_PARTITION_RULES,
                    self.draft_cache)
        self._rt = self._dispatch_table()
        # Per draft position i < spec_k: proposals made there and accepted.
        self._spec_pos = np.zeros((2, max(self.spec_k, 1)), np.int64)
        # Prefix cache: None = off (the engine without page sharing).
        self.prefix_cache = None
        if prefix_cache:
            budget = (min(prefix_cache_pages, n_pages) if prefix_cache_pages
                      else max(1, n_pages // 2))
            self.prefix_cache = PrefixCache(
                chunk=prefill_chunk, page_size=page_size, max_pages=budget,
                ref_page=self._ref_page, unref_page=self._unref_page)
        # KV page-set store: donation target and adoption source.
        # _kv_exporting: page -> refs held by an IN-FLIGHT donation (the
        # gather and the put), the in-flight-donated category of the page
        # accounting, released in a finally. _kv_donated: chain head
        # (16-hex depth-1 digest prefix) -> deepest donated depth,
        # newest last, at most _kv_summary_max: load_snapshot's
        # kv_summary and the insert-on-free donation memo.
        self._kv_store = None
        self._kv_fingerprint = ""
        self._kv_donor = ""
        self._kv_exporting: dict[int, int] = {}
        self._kv_donated: "collections.OrderedDict[str, int]" = (
            collections.OrderedDict())
        self._kv_summary_max = 0
        if self.kv_transfer:
            # No actor context here: the reference's off-actor donor id.
            self._kv_donor = f"local:{os.getpid()}"
            self._kv_store = (kv_store if kv_store is not None
                              else _kvo.get_store())
            self._kv_fingerprint = _kvo.engine_fingerprint(
                cfg, page_size, prefill_chunk, draft_cfg, kv_dtype=kv_dtype)
            self._kv_summary_max = max(1, _kvo.SERVE_KV_SUMMARY_MAX)
        # slot -> pinned CacheEntry while the slot is live (released on
        # free/preempt), and the tick's pending COW (src, dst) pairs,
        # flushed in one copy before the tick's first dispatch.
        self._slot_entry: dict = {}
        self._cow_pairs: list[tuple[int, int]] = []
        self._evictions_synced = 0
        self.tokens = np.zeros(n_slots, np.int32)
        self.positions = np.zeros(n_slots, np.int32)
        self.temps = np.zeros(n_slots, np.float32)
        self.decode_block = max(1, decode_block)
        self._k_ladder = tuple(
            k for k in (64, 32, 16, 8, 4, 2) if k <= self.decode_block)
        self.slot_req: list[GenRequest | None] = [None] * n_slots
        self.pending: "queue.Queue[GenRequest]" = queue.Queue()
        # Engine-thread FIFO drained BEFORE `pending`: page-blocked and
        # preempted requests keep their place at the head.
        self._deferred: "collections.deque[GenRequest]" = collections.deque()
        self._prefilling: list[int] = []
        self._chunk_pos: dict[int, int] = {}
        self._dispatch_width_ring: "collections.deque[int]" = (
            collections.deque(maxlen=4096))
        self._dispatch_width_counts: dict[int, int] = {}
        # Decode windows and draft loops sample on the device from this
        # generator; host graduation samples (temperature > 0) from the
        # CPU one.
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._host_gen = torch.Generator().manual_seed(seed)
        ring = lambda: collections.deque(maxlen=4096)
        self._step_ms: "collections.deque[float]" = ring()
        self._ttft_ms: "collections.deque[float]" = ring()
        # Warm/cold TTFT split (prefix cache): warm = admission bound a
        # cached prefix (cached_tokens > 0).
        self._ttft_warm_ms: "collections.deque[float]" = ring()
        self._ttft_cold_ms: "collections.deque[float]" = ring()
        self._burst_step_ms: "collections.deque[float]" = ring()
        self._last_window_end: float | None = None
        self._shutdown = threading.Event()
        self._fatal: str | None = None
        # Drain protocol: a draining engine rejects submits, and
        # _mid_tick (set by step() under the lock) keeps drain() from
        # reading a request popped but not yet bound to a slot as idle.
        self._draining = False
        self._mid_tick = False
        self._warmup_on_start = bool(warmup)
        self._warmed = False
        # Load EWMAs (None until a first sample; reset_stats clears them).
        self._ttft_ewma_ms: float | None = None
        self._decode_ewma_tok_s: float | None = None
        self._budget_util_ewma: float | None = None
        self._spec_accept_ewma: float | None = None
        # Span sampling sequences and the engine's histogram tags.
        self._span_seq: dict[str, int] = {}
        self._ttft_seq = 0
        self._step_tags: dict | None = None
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        # Serializes start()/stop() (two starts must not spawn two loops).
        self._lifecycle_lock = threading.Lock()
        self.stats = {"requests": 0, "tokens_generated": 0,
                      "ttft_sum": 0.0, "completed": 0,
                      "prefill_time_s": 0.0, "prefill_tokens": 0,
                      "prefill_chunks": 0, "prefill_dispatches": 0,
                      "decode_time_s": 0.0, "decode_windows": 0,
                      "decode_steps": 0,
                      "slot_step_sum": 0, "slot_cap_sum": 0,
                      "preemptions": 0,
                      # Prefix-cache lifecycle (zeros unless enabled).
                      "prefix_hits": 0, "prefix_misses": 0,
                      "prefix_evictions": 0, "cow_copies": 0,
                      "prefix_cached_tokens": 0,
                      # Speculative decoding (zeros unless enabled):
                      # proposed and accepted draft tokens, verify passes
                      # (one per tick), per-slot verify steps, and tokens
                      # emitted through the accept path.
                      "spec_proposed": 0, "spec_accepted": 0,
                      "spec_ticks": 0, "spec_slot_steps": 0,
                      "spec_emitted": 0,
                      # KV page-set transfer (zeros unless enabled):
                      # donations and pages out, adoptions (full and
                      # partial) and the tokens they served, falls to the
                      # re-prefill rung, and adopt-plan index lookups.
                      "kv_donations": 0, "kv_donated_pages": 0,
                      "kv_adoptions": 0, "kv_partial_adoptions": 0,
                      "kv_adopted_tokens": 0, "kv_adopt_failures": 0,
                      "kv_digest_lookups": 0}

    @staticmethod
    def _placement(tp: int, device):
        """(mesh, device). At tp=1 no mesh and the one device. At tp > 1
        the mesh (`partition.make_tp_mesh`): ``device`` as a list of tp
        devices (a device may repeat), else the first tp visible CUDA
        devices (raises when there are fewer), or tp times the CPU with
        ``device="cpu"``; and its shard 0, where the index arrays, the
        hidden states, the LM head and the sampling generator live."""
        devices = None
        if isinstance(device, (list, tuple)):
            if len(device) != tp:
                raise ValueError(
                    f"device lists {len(device)} device(s) for tp={tp}: "
                    "give one per shard")
            devices = [resolve_device(d) for d in device]
            if len({d.type for d in devices}) > 1:
                raise ValueError(
                    f"a mesh is all CUDA or all CPU, got {devices}")
        elif (tp > 1 and device is not None
              and torch.device(device).type == "cpu"):
            devices = [torch.device("cpu")] * tp
        if tp == 1:
            return None, devices[0] if devices else resolve_device(device)
        mesh = _partition.make_tp_mesh(tp, devices=devices)
        return mesh, mesh[0]

    def _dispatch_table(self):
        """The paged programs every call site dispatches through: at
        tp=1 the ``paged_kv`` module itself (its programs, looked up at
        each call, as before tp), at tp > 1 their ``*_tp`` twins with
        the mesh bound (the JAX engine's swapped dispatch table), so call
        sites read the same for both."""
        if self.mesh is None:
            return _paged
        names = ("prefill_chunk_paged", "verify_chunk_paged",
                 "decode_step_paged", "decode_multi_paged", "copy_pages",
                 "gather_pages", "scatter_pages", "spec_draft_propose")
        return types.SimpleNamespace(**{
            n: functools.partial(getattr(_paged, n + "_tp"), mesh=self.mesh)
            for n in names})

    def _sync(self) -> None:
        """Wait for every CUDA device of the engine (a no-op on the
        CPU)."""
        for dev in dict.fromkeys(self.mesh or [self.device]):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    # ------------------------------------------------------------- API

    def submit(self, prompt_ids: list[int], *, max_tokens: int = 64,
               temperature: float = 0.0, eos_id: int | None = None,
               stream: bool = False,
               generated_ids: list[int] | None = None,
               request_id: str | None = None, kv: dict | None = None,
               prefix_hashes: list | None = None,
               prefix_chunk: int = 0) -> GenRequest:
        """Queue one generation request.

        ``generated_ids`` resumes a continuation exported by `drain` (on
        this engine or another): the tokens already emitted are
        teacher-forced (they join the prefill context), seed ``out_ids``
        (``max_tokens`` stays the TOTAL output budget) and are never
        emitted again, so the stream cursor splices exactly and a greedy
        continuation equals the uninterrupted run. ``prefix_hashes``
        (hex or bytes) with ``prefix_chunk``, the chunk they were
        computed at, seed the request's memoized chunk-hash chain; a
        memo of another chunk size is dropped. ``kv`` (a donor's
        page-set descriptor, or ``{"discover": True}``) makes admission
        try to adopt the donated pages; an engine without transfer
        ignores it."""
        if not prompt_ids:
            raise ValueError("prompt_ids must be non-empty")
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        generated = [int(t) for t in (generated_ids or [])]
        context = [int(t) for t in prompt_ids] + generated
        too_big = (len(context) > self._prompt_cap
                   or (self.kv_mode == "paged"
                       and self._pages_for(len(context)) > self.n_pages))
        req = GenRequest(
            request_id=request_id or uuid.uuid4().hex[:12],
            prompt_ids=context, n_prompt=len(prompt_ids),
            max_tokens=max_tokens, temperature=temperature, eos_id=eos_id,
            submitted_at=time.perf_counter(), out_ids=generated,
            stream=queue.Queue() if stream else None)
        if (prefix_hashes and self.prefill_chunk
                and prefix_chunk == self.prefill_chunk):
            try:
                req.prefix_hashes = [
                    bytes.fromhex(h) if isinstance(h, str) else bytes(h)
                    for h in prefix_hashes]
            except (ValueError, TypeError):
                req.prefix_hashes = []   # the chain rebuilds from tokens
        if kv and self._kv_store is not None:
            req.kv = dict(kv)
        if generated and (len(generated) >= max_tokens or (
                eos_id is not None and generated[-1] == eos_id)):
            # Already complete (the source stopped between its last token
            # and the reader seeing done): finish, never decode past it.
            self._finish_presubmit(req, truncated=False)
            return req
        if too_big:
            if generated:
                # A resume that outgrew this engine's caps ends the stream
                # with what the client has, as an unresumable preempt does.
                self._finish_presubmit(req, truncated=True)
                return req
            if len(context) > self._prompt_cap:
                raise ValueError(
                    f"prompt too long: {len(context)} (cap "
                    f"{self._prompt_cap}: "
                    + ("cache bound, chunked prefill" if self.prefill_chunk
                       else f"bucket cap {self.buckets[-1]}, cache cap "
                            f"{self.max_len - 1}") + ")")
            raise ValueError(
                f"prompt needs {self._pages_for(len(context))} KV pages "
                f"but the pool only has {self.n_pages}")
        # Atomic with the death handler's and the drain export's one-shot
        # sweep of `pending`: a submit racing them must not be stranded.
        with self._lock:
            if self._fatal is not None:
                raise RuntimeError(self._fatal)
            if self._draining:
                raise RuntimeError(
                    "replica draining: not accepting new requests")
            self.stats["requests"] += 1
            self.pending.put(req)
        return req

    def _finish_presubmit(self, req: GenRequest, *, truncated: bool) -> None:
        """Complete a resumed continuation at submit time without queueing
        it (already done, or too big for this engine)."""
        req.truncated = truncated
        req.finished_at = time.perf_counter()
        with self._lock:
            self.stats["requests"] += 1
            self.stats["completed"] += 1
        if req.stream is not None:
            req.stream.put(None)
        req.done.set()

    def generate(self, prompt_ids: list[int], **kw) -> list[int]:
        """Blocking convenience wrapper."""
        req = self.submit(prompt_ids, **kw)
        req.done.wait()
        if req.error:
            raise RuntimeError(req.error)
        return req.out_ids

    def _width_ladder(self) -> list[int]:
        """The pow-2 table widths chunk dispatches can occur at: 1, 2, 4,
        ... up to and including `max_pages_per_slot` (which caps the
        bucket rule, so it appears even when it is not a power of two);
        with width bucketing off, that one width."""
        if not self.prefill_width_bucketing:
            return [self.max_pages_per_slot]
        widths, w = [], 1
        while w < self.max_pages_per_slot:
            widths.append(w)
            w *= 2
        widths.append(self.max_pages_per_slot)
        return widths

    def warmup_compile(self) -> int:
        """Pay every first-touch cost before a live request does: on a
        kernel engine on CUDA, load the kernel library (built first when
        missing or stale: the nvcc build), then one inert dispatch (every
        row n_valid 0, an all-zero table: every write lands on the null
        page) per table width per head variant of `prefill_chunk_paged`,
        plus the draft's prefill mirror and `verify_chunk_paged` with
        speculation: the reference's dispatch count. Waits for the device
        before it returns. Idempotent per engine; ``warmup=True`` runs it
        at `start`. → dispatches issued (0 on dense and one-shot engines
        and on a second call)."""
        if (self.kv_mode != "paged" or not self.prefill_chunk
                or self._warmed):
            return 0
        if self.attn_impl == "kernel" and self.device.type == "cuda":
            _build.library()
        toks = self._to_dev(np.zeros((self.n_slots, self.prefill_chunk),
                                     np.int32))
        zeros = self._to_dev(np.zeros(self.n_slots, np.int32))
        if self.spec_k:
            vtoks = self._to_dev(np.zeros((self.n_slots, self.spec_k + 1),
                                          np.int32))
        n = 0
        for width in self._width_ladder():
            tables = self._to_dev(np.zeros((self.n_slots, width), np.int32))
            for head in (False, True):
                _x, self.cache = self._rt.prefill_chunk_paged(
                    self.cfg, self.params, toks, self.cache, tables, zeros,
                    zeros, return_logits=head, attn_impl=self.attn_impl)
                n += 1
            if self.spec_k:
                _x, self.draft_cache = self._rt.prefill_chunk_paged(
                    self.draft_cfg, self.draft_params, toks,
                    self.draft_cache, tables, zeros, zeros,
                    return_logits=False, attn_impl=self.attn_impl)
                _x, self.cache = self._rt.verify_chunk_paged(
                    self.cfg, self.params, vtoks, self.cache, tables, zeros,
                    zeros, attn_impl=self.attn_impl)
                n += 2
        self._sync()
        self._warmed = True
        return n

    def start(self) -> None:
        with self._lifecycle_lock:
            if self._thread is None:
                if self._warmup_on_start:
                    self.warmup_compile()
                self._shutdown.clear()
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name="llm-engine")
                self._thread.start()

    def stop(self) -> None:
        self._shutdown.set()
        with self._lifecycle_lock:
            if self._thread is not None:
                self._thread.join(timeout=30)
                self._thread = None

    def drain(self, timeout_s: float) -> dict:
        """Drain protocol: stop admission, let in-flight requests finish
        for up to ``timeout_s`` seconds, then export whatever is left as
        resumable continuations. Afterwards every request has completed
        or carries ``migrated=True`` with its stream closed; the
        continuations (``request_id``, ``prompt_ids``, ``generated_ids``,
        ``max_tokens``, ``temperature``, ``eos_id``, with chunked
        prefill the hex ``prefix_hashes`` and ``prefix_chunk``, and with
        KV transfer the ``kv`` descriptor of the donated written prefix)
        resume through `submit`. → {"drained", "exported",
        "continuations"}."""
        with self._lock:
            self._draining = True
        deadline = time.monotonic() + max(0.0, timeout_s)
        while time.monotonic() < deadline:
            with self._lock:
                busy = (self._mid_tick
                        or any(r is not None for r in self.slot_req)
                        or self.pending.qsize() > 0
                        or len(self._deferred) > 0)
            if not busy:
                break
            time.sleep(0.02)
        continuations = self._export_unfinished()
        return {"drained": not continuations,
                "exported": len(continuations),
                "continuations": continuations}

    def _export_unfinished(self) -> list[dict]:
        """Evict every unfinished request as a continuation. The engine
        thread stops FIRST, so no tick races the export (a request must
        never emit a token after its continuation left). Paged: every
        evicted slot's pages return to the pool and its pinned prefix-
        cache entry is released, so the accounting still closes; with
        KV transfer each slot's written prefix is donated first, and its
        continuation carries the descriptor (the drain rung of the
        adoption ladder)."""
        if self._thread is not None:
            self.stop()
        doomed: list[GenRequest] = []
        slot_of: dict[int, GenRequest] = {}
        with self._lock:
            for slot, req in enumerate(self.slot_req):
                if req is not None:
                    doomed.append(req)
                    slot_of[slot] = req
                    self.slot_req[slot] = None
            chunk_pos = dict(self._chunk_pos)
            self._prefilling.clear()
            self._chunk_pos.clear()
            doomed.extend(self._deferred)
            self._deferred.clear()
            while True:
                try:
                    doomed.append(self.pending.get_nowait())
                except queue.Empty:
                    break
        for slot in range(self.n_slots):
            req = slot_of.get(slot)
            if (req is not None and self._kv_store is not None
                    and int(self.slot_n_pages[slot])):
                # Written positions: the decode cursor, or a mid-prefill
                # slot's chunk cursor. The sequence is anchored at
                # n_prompt (a preempt-regrown context never duplicates
                # generated tokens into the keys).
                n_written = (int(self.positions[slot])
                             or int(chunk_pos.get(slot, 0)))
                seq = (req.prompt_ids[:req.n_prompt]
                       + req.out_ids)[:n_written]
                req.kv_handoff = self._donate_kv(
                    seq, self.page_table[slot], memo=req.prefix_hashes)
            if self.kv_mode == "paged":
                entry = self._slot_entry.pop(slot, None)
                if entry is not None:
                    self.prefix_cache.release(entry)
                self._free_slot_pages(slot)
            self.positions[slot] = 0
            self.tokens[slot] = 0
        out = []
        for req in doomed:
            cont = {
                "request_id": req.request_id,
                # A preempt regrows prompt_ids to prompt + generated:
                # split at the original prompt so nothing is forced twice.
                "prompt_ids": [int(t) for t in req.prompt_ids[:req.n_prompt]],
                "generated_ids": [int(t) for t in req.out_ids],
                "max_tokens": req.max_tokens,
                "temperature": req.temperature,
                "eos_id": req.eos_id,
            }
            if self.prefill_chunk and req.prefix_hashes:
                cont["prefix_hashes"] = [h.hex() for h in req.prefix_hashes]
                cont["prefix_chunk"] = self.prefill_chunk
            if req.kv_handoff is not None:
                cont["kv"] = req.kv_handoff
            out.append(cont)
            req.migrated = True
            if req.stream is not None:
                req.stream.put(None)
            req.done.set()
        return out

    def reset_stats(self) -> None:
        """Zero the counters (benchmarks call this after warmup)."""
        with self._lock:
            for k, v in self.stats.items():
                self.stats[k] = 0 if isinstance(v, int) else 0.0
            self._step_ms.clear()
            self._dispatch_width_ring.clear()
            self._dispatch_width_counts.clear()
            self._ttft_ms.clear()
            self._ttft_warm_ms.clear()
            self._ttft_cold_ms.clear()
            self._burst_step_ms.clear()
            self._last_window_end = None
            self._ttft_ewma_ms = None
            self._decode_ewma_tok_s = None
            self._budget_util_ewma = None
            self._spec_accept_ewma = None
            if self.kv_mode == "paged":
                self._min_free_pages = len(self.free_pages)
            self._spec_pos[:] = 0

    # Spans: 1 in _SPAN_SAMPLE decode windows and verify passes, 1 in
    # _TTFT_SPAN_SAMPLE first tokens, the first always, so a busy engine
    # does not mint a root trace per window; the histograms see all.
    _SPAN_SAMPLE = 64
    _TTFT_SPAN_SAMPLE = 16

    def _sampled_span(self, name: str):
        """A span named ``name`` for 1 in _SPAN_SAMPLE of its calls (the
        first always), else a null context."""
        seq = self._span_seq.get(name, 0)
        self._span_seq[name] = seq + 1
        if seq % self._SPAN_SAMPLE == 0:
            return tracing.start_span(name, cat="serve_llm")
        return contextlib.nullcontext()

    def _emit_ttft_spans(self, req: GenRequest) -> None:
        """TTFT breakdown of a sampled first token: an ``llm.ttft`` root
        and three children (queue wait → prefill, first to last chunk →
        first token), recorded after the fact from the request's
        timestamps."""
        seq, self._ttft_seq = self._ttft_seq, self._ttft_seq + 1
        if seq % self._TTFT_SPAN_SAMPLE or req.first_chunk_at is None:
            return
        # The request's timestamps are perf_counter; the ring speaks the
        # wall clock.
        anchor = time.time() - time.perf_counter()
        root = tracing.TraceContext(
            tracing.new_trace_id(), tracing.new_span_id(), None, {})
        first = req.first_chunk_at
        last = req.last_chunk_at if req.last_chunk_at is not None else first
        _profiling.record_event(
            "llm.ttft", "serve_llm", anchor + req.submitted_at,
            req.first_token_at - req.submitted_at, tid="llm-engine",
            args=tracing.span_event_args(root, request_id=req.request_id))
        for name, a, b in (("llm.ttft.queue_wait", req.submitted_at, first),
                           ("llm.ttft.prefill", first, last),
                           ("llm.ttft.first_token", last,
                            req.first_token_at)):
            _profiling.record_event(
                name, "serve_llm", anchor + a, max(0.0, b - a),
                tid="llm-engine",
                args=tracing.span_event_args(root.child()))

    def _impl_tags(self) -> dict:
        """replica/impl tags of the engine-side histograms."""
        if self._step_tags is None:
            impl = (f"paged-{self.attn_impl}" if self.kv_mode == "paged"
                    else "dense")
            self._step_tags = {
                "replica": _request_metric_tags()["replica"], "impl": impl}
        return self._step_tags

    def _observe_window(self, t0: float, end: float, k: int,
                        n_active: int, tick_prefill: bool) -> None:
        """Non-speculative window: every slot advances exactly k tokens."""
        self._observe_decode(t0, end, float(k), k * n_active,
                             k * self.n_slots, tick_prefill, steps=k)

    def _observe_decode(self, t0: float, end: float, per_slot: float,
                        emitted: int, cap: int, tick_prefill: bool, *,
                        steps: int = 0) -> None:
        """Decode-tick accounting shared by the fused window and the
        speculative tick: ``per_slot`` tokens each active slot advanced
        (the step-time ring is tick wall / per_slot), ``emitted`` tokens
        in all, ``cap`` the tick's most emittable tokens (the occupancy
        denominator), ``steps`` fused decode steps (0 for a spec tick)."""
        dt = end - t0
        per_slot = max(1.0, per_slot)
        tags = self._impl_tags()
        with self._lock:
            self.stats["decode_time_s"] += dt
            self.stats["decode_windows"] += 1
            self.stats["decode_steps"] += steps
            self.stats["slot_step_sum"] += emitted
            self.stats["slot_cap_sum"] += cap
            self._step_ms.append(dt / per_slot * 1000.0)
            if dt > 0:
                self._decode_ewma_tok_s = self._ewma(
                    self._decode_ewma_tok_s, emitted / dt)
            if tick_prefill and self._last_window_end is not None:
                self._burst_step_ms.append(
                    (end - self._last_window_end) / per_slot * 1000.0)
            self._last_window_end = end
        _DECODE_STEP_HIST.observe(dt / per_slot, tags=tags)

    def metrics(self) -> dict:
        with self._lock:
            active = sum(r is not None for r in self.slot_req)
            m = dict(self.stats, active_slots=active,
                     queued=self.pending.qsize() + len(self._deferred),
                     n_slots=self.n_slots, device=str(self.device))
            if self.kv_mode == "paged":
                m.update(kv_pages_total=self.n_pages,
                         kv_pages_free=len(self.free_pages),
                         kv_pages_free_min=self._min_free_pages,
                         kv_page_size=self.page_size,
                         llm_attn_impl=self.attn_impl,
                         llm_weight_dtype=self.weight_dtype,
                         llm_kv_dtype=self.kv_dtype,
                         kv_pool_bytes=self._pool_bytes())
            m["llm_tp"] = self.tp
            m.update(self._topology())
            if self.prefill_chunk:
                m.update(prefill_chunk=self.prefill_chunk,
                         prefill_token_budget=self.prefill_budget,
                         prefilling_slots=len(self._prefilling),
                         prefill_width_bucketing=self.prefill_width_bucketing)
                if self._dispatch_width_ring:
                    widths = sorted(self._dispatch_width_ring)
                    m["prefill_dispatch_width_p50"] = widths[
                        len(widths) // 2]
                    m["prefill_dispatch_width_max"] = widths[-1]
                if self._dispatch_width_counts:
                    m["prefill_dispatch_widths"] = {
                        str(w): c for w, c in
                        sorted(self._dispatch_width_counts.items())}
            if self.spec_k:
                m["spec_k"] = self.spec_k
                m["spec_draft"] = self.spec_draft_name
                if m["spec_slot_steps"]:
                    # Tokens emitted per slot per verify pass: 1.0 is the
                    # non-speculative rate, k+1 the ceiling.
                    m["spec_accepted_per_step"] = round(
                        m["spec_emitted"] / m["spec_slot_steps"], 4)
                if m["spec_proposed"]:
                    m["spec_accept_rate"] = round(
                        m["spec_accepted"] / m["spec_proposed"], 4)
                made, took = self._spec_pos
                m["spec_accept_rate_by_position"] = [
                    round(int(a) / int(n), 4) if n else None
                    for n, a in zip(made, took)]
            if self.kv_transfer:
                m["kv_transfer"] = True
                m["pool_role"] = self.pool_role or "fused"
                m["kv_summary_entries"] = len(self._kv_donated)
                m["kv_summary_max"] = self._kv_summary_max
            if self.prefix_cache is not None:
                m["prefix_cache"] = True
                m["prefix_cache_entries"] = len(self.prefix_cache.entries)
                m["prefix_cache_pages"] = self.prefix_cache.n_pages_cached()
                m["prefix_cache_pages_budget"] = self.prefix_cache.max_pages
                looked = m["prefix_hits"] + m["prefix_misses"]
                if looked:
                    m["prefix_cache_hit_rate"] = round(
                        m["prefix_hits"] / looked, 4)
                if self._ttft_warm_ms:
                    (m["ttft_warm_ms_p50"],
                     m["ttft_warm_ms_p95"]) = _ring_pctls(self._ttft_warm_ms)
                if self._ttft_cold_ms:
                    (m["ttft_cold_ms_p50"],
                     m["ttft_cold_ms_p95"]) = _ring_pctls(self._ttft_cold_ms)
            if self._step_ms:
                m["decode_step_ms_p50"], m["decode_step_ms_p95"] = (
                    _ring_pctls(self._step_ms))
            if self._ttft_ms:
                m["ttft_ms_p50"], m["ttft_ms_p95"] = _ring_pctls(
                    self._ttft_ms)
            if self._burst_step_ms:
                (m["decode_step_burst_ms_p50"],
                 m["decode_step_burst_ms_p95"]) = _ring_pctls(
                    self._burst_step_ms)
        if m["completed"]:
            m["ttft_mean_s"] = m["ttft_sum"] / m["completed"]
        if m["decode_time_s"] > 0:
            m["engine_decode_tok_s"] = (
                m["slot_step_sum"] / m["decode_time_s"])
        if m["prefill_time_s"] > 0:
            m["engine_prefill_tok_s"] = (
                m["prefill_tokens"] / m["prefill_time_s"])
        if m["slot_cap_sum"] > 0:
            m["slot_occupancy"] = m["slot_step_sum"] / m["slot_cap_sum"]
        return m

    _EWMA_ALPHA = 0.2

    @classmethod
    def _ewma(cls, prev: float | None, sample: float) -> float:
        if prev is None:
            return sample
        return cls._EWMA_ALPHA * sample + (1 - cls._EWMA_ALPHA) * prev

    def load_snapshot(self) -> dict:
        """Live load for a router or autoscaler: queue depth, the slot
        split, the page pool's fill, the prefill budget's utilization and
        the TTFT / decode-rate / acceptance EWMAs, all from the engine's
        own bookkeeping (no device sync). Also sets the ``llm_*`` gauges,
        absent fields as 0, so /metrics reads the same numbers."""
        with self._lock:
            active = sum(r is not None for r in self.slot_req)
            prefilling = len(self._prefilling)
            snap: dict = {
                "queue_depth": self.pending.qsize() + len(self._deferred),
                "n_slots": self.n_slots,
                "active_slots": active,
                "prefilling_slots": prefilling,
                "decoding_slots": active - prefilling,
                "slot_utilization": round(active / self.n_slots, 4),
            }
            if self._ttft_ewma_ms is not None:
                snap["ttft_ewma_ms"] = round(self._ttft_ewma_ms, 3)
            if self._decode_ewma_tok_s is not None:
                snap["decode_tok_s_ewma"] = round(
                    self._decode_ewma_tok_s, 3)
            if self.kv_mode == "paged":
                snap["pool_pages_total"] = self.n_pages
                snap["pool_pages_free"] = len(self.free_pages)
                snap["pool_pages_free_min"] = self._min_free_pages
                snap["pool_utilization"] = round(
                    1.0 - len(self.free_pages) / self.n_pages, 4)
                snap["llm_weight_dtype"] = self.weight_dtype
                snap["llm_kv_dtype"] = self.kv_dtype
                snap["kv_pool_bytes"] = self._pool_bytes()
            if self.tp > 1:
                snap["llm_tp"] = self.tp
                snap.update(self._topology())
            if self.prefill_chunk:
                snap["prefill_chunk"] = self.prefill_chunk
                snap["prefill_token_budget"] = self.prefill_budget
                if self._budget_util_ewma is not None:
                    snap["prefill_budget_util"] = round(
                        self._budget_util_ewma, 4)
                if self._dispatch_width_ring:
                    widths = sorted(self._dispatch_width_ring)
                    snap["prefill_dispatch_width_p50"] = widths[
                        len(widths) // 2]
                    snap["prefill_dispatch_width_max"] = widths[-1]
            if self.spec_k:
                snap["spec_k"] = self.spec_k
                if self._spec_accept_ewma is not None:
                    snap["spec_accepted_per_step"] = round(
                        self._spec_accept_ewma, 4)
            if self.kv_transfer:
                # Pool role, the donation and adoption counts, and the
                # donated chain heads (oldest to newest): the row a router
                # reads for disaggregation and warm discovery.
                snap["pool_role"] = self.pool_role or "fused"
                for key in ("kv_donations", "kv_adoptions",
                            "kv_partial_adoptions", "kv_adopted_tokens",
                            "kv_adopt_failures", "kv_digest_lookups"):
                    snap[key] = self.stats[key]
                snap["kv_summary"] = list(self._kv_donated)
            if self.prefix_cache is not None:
                snap["prefix_cache_entries"] = len(self.prefix_cache.entries)
                snap["prefix_cache_pages"] = (
                    self.prefix_cache.n_pages_cached())
                snap["prefix_cache_hits"] = self.stats["prefix_hits"]
                snap["prefix_cache_misses"] = self.stats["prefix_misses"]
                looked = (self.stats["prefix_hits"]
                          + self.stats["prefix_misses"])
                if looked:
                    snap["prefix_cache_hit_rate"] = round(
                        self.stats["prefix_hits"] / looked, 4)
        tags = {"replica": self._impl_tags()["replica"]}
        for key, gauge in _LOAD_GAUGES.items():
            # Absent fields (a dense engine's pool, EWMAs cleared by
            # reset_stats) export 0, never a stale value.
            gauge.set(float(snap.get(key, 0.0)), tags=tags)
        return snap

    # --------------------------------------------------- page accounting

    def _pages_for(self, last_pos: int) -> int:
        """Pages needed to cover writes up to position `last_pos`."""
        return last_pos // self.page_size + 1

    def _pool_shards(self) -> list:
        """The target's page pool, one dict per shard."""
        return self.cache if self.mesh is not None else [self.cache]

    def _pool_bytes(self) -> int:
        """Every byte of the target's pool, of every shard (the int8
        scale planes once per shard: each shard holds its own copy)."""
        return sum(a.numel() * a.element_size()
                   for shard in self._pool_shards() for a in shard.values())

    def _pool_shard_bytes(self) -> int:
        """Bytes one shard's pool tensors hold (every shard holds the
        same): its head slice of the K/V planes of every page, null page
        included, and, when quantized, its whole copy of the scale
        planes."""
        return sum(a.numel() * a.element_size()
                   for a in self._pool_shards()[0].values())

    def _topology(self) -> dict:
        """The sharding fields of `metrics` and `load_snapshot` at
        tp > 1 (none at tp=1). Page ids, and so the pool's fill, are
        shard-invariant; the per-shard number is the bytes each shard
        pins."""
        if self.tp == 1:
            return {}
        shard_bytes = self._pool_shard_bytes()
        return {"mesh_shape": {_partition.TP_AXIS: self.tp},
                "kv_heads_per_shard": self.cfg.n_heads // self.tp,
                "pool_shard_bytes": shard_bytes,
                "pool_shard_bytes_used": round(
                    shard_bytes * (1.0 - len(self.free_pages)
                                   / self.n_pages))}

    def _alloc_page(self) -> int | None:
        """One exclusive page off the free list (refcount 1), or None
        when the pool is dry (callers preempt)."""
        if not self.free_pages:
            return None
        pg = self.free_pages.pop()
        self.page_refs[pg] = 1
        if len(self.free_pages) < self._min_free_pages:
            self._min_free_pages = len(self.free_pages)
        return pg

    def _ref_page(self, pg: int) -> None:
        self.page_refs[pg] += 1

    def _unref_page(self, pg: int) -> None:
        """Drop one reference; the page returns to the pool at zero."""
        self.page_refs[pg] -= 1
        if self.page_refs[pg] <= 0:
            self.page_refs[pg] = 0
            self.free_pages.append(int(pg))

    def _cache_reclaim(self, need: int) -> None:
        """Pressure valve: evict zero-active prefix-cache entries (LRU)
        until ``need`` pages are free or nothing evictable remains. The
        cache gives its pages back BEFORE the scheduler shrinks a window
        or preempts a live decode."""
        if self.prefix_cache is None:
            return
        while len(self.free_pages) < need:
            if self.prefix_cache.evict_one() is None:
                break
        self._sync_cache_evictions()

    def _sync_cache_evictions(self) -> None:
        """Fold the cache's cumulative evictions (donate() evicts too)
        into the stats."""
        delta = self.prefix_cache.evictions - self._evictions_synced
        if delta > 0:
            self._evictions_synced = self.prefix_cache.evictions
            self.stats["prefix_evictions"] += delta
            _PREFIX_COUNTERS["evictions"].inc(
                float(delta), tags={"replica": self._impl_tags()["replica"]})

    def _grow_slot(self, slot: int, last_pos: int) -> bool:
        """Allocate pages so `slot` covers `last_pos`. All-or-nothing."""
        need = self._pages_for(last_pos) - int(self.slot_n_pages[slot])
        if need <= 0:
            return True
        if need > len(self.free_pages):
            self._cache_reclaim(need)
        if need > len(self.free_pages):
            return False
        for _ in range(need):
            pg = self._alloc_page()
            self.page_table[slot, int(self.slot_n_pages[slot])] = pg
            self.slot_n_pages[slot] += 1
        return True

    def _free_slot_pages(self, slot: int) -> None:
        for i in range(int(self.slot_n_pages[slot])):
            self._unref_page(int(self.page_table[slot, i]))
        self.page_table[slot, :] = 0
        self.slot_n_pages[slot] = 0

    # ------------------------------------------- KV page-set transfer

    def _kv_note_donation(self, head: str, depth: int) -> None:
        """Fold a donated chain into the summary memo: head → deepest
        donated depth, newest last, at most _kv_summary_max heads. Under
        the lock: `load_snapshot` lists the memo from another thread."""
        with self._lock:
            m = self._kv_donated
            m[head] = max(depth, m.get(head, 0))
            m.move_to_end(head)
            while len(m) > self._kv_summary_max:
                m.popitem(last=False)

    def _kv_chain_head(self, seq) -> str | None:
        """Summary key of ``seq``'s chain: the 16-hex prefix of its
        depth-1 chunk digest (`prefix_cache.affinity_key`'s space)."""
        c = self.prefill_chunk
        if not c or len(seq) < c:
            return None
        return affinity_key(seq, c).hex()[:16]

    def _kv_payload(self, pool, ids: np.ndarray) -> dict:
        """Pages ``ids`` of every plane of ``pool`` (one dict, or a list
        of shards) as host tensors in the pool's dtype: one gather on the
        device, one copy to the host. At tp > 1 the gather returns
        full-head planes and `partition.split_head_planes` cuts them into
        the per-shard wire planes. The ids are the donated pages alone:
        the JAX engine pads them to a pow-2 width to bound its compiles,
        which an eager gather does not need, and the padding would only
        cross the bus."""
        gathered = self._rt.gather_pages(pool, self._to_dev(ids))
        host = {key: a.cpu() for key, a in gathered.items()}
        if self.tp > 1:
            host = _partition.split_head_planes(host, self.tp)
        return host

    def _donate_kv(self, seq, table_row, memo: list) -> dict | None:
        """Donate the chunk-aligned written prefix of ``seq`` (its K/V
        sits in ``table_row``'s pages) to the store, one entry per chain
        depth the store lacks, keyed by the prefix cache's parent-chained
        digests. The pages are reffed for the gather and the put (the
        in-flight-donated category) and released in a finally, so a chaos
        raise at ``serve.kv.donate`` leaks no reference. Best effort: a
        failure skips the rest and never fails the request. → the
        adoption descriptor for the continuation, or None."""
        if self._kv_store is None:
            return None
        c = self.prefill_chunk
        n_full = len(seq) // c
        if n_full <= 0:
            return None
        chain = extend_chunk_chain(seq, c, memo if memo is not None else [])
        keys = [h.hex() for h in chain[:n_full]]
        total_pages = _kvo.pages_for_tokens(n_full * c, self.page_size)
        pages = [int(table_row[i]) for i in range(total_pages)]
        if any(p <= 0 for p in pages):
            # A donor must own real pages for every token it claims.
            return None
        desc = {"keys": keys, "chunk": c, "page_size": self.page_size,
                "fingerprint": self._kv_fingerprint,
                "n_tokens": n_full * c}
        try:
            # Chaos fault point at EVERY donation attempt (the store
            # dedups novel digests): "raise" skips this donation.
            _chaos.hit("serve.kv.donate")
            existing = self._kv_store.resolve(keys)
        except Exception as e:  # noqa: BLE001 — the descriptor still names the keys
            logger.debug("kv donation skipped: %s", e)
            return desc
        new_depths = [d for d in range(1, n_full + 1)
                      if keys[d - 1] not in existing]
        if not new_depths:
            # Deduped whole: the chain is live in the store, so it still
            # belongs in this engine's summary.
            self._kv_note_donation(keys[0][:16], n_full)
            return desc
        for p in pages:
            self._ref_page(p)
            self._kv_exporting[p] = self._kv_exporting.get(p, 0) + 1
        tags = {"replica": self._impl_tags()["replica"]}
        try:
            ids = np.asarray(pages, np.int32)
            # Every pool plane is paged on axis 1, an int8 pool's scale
            # planes included, so one gather carries them all; the draft
            # pool mirrors the target's pages (a speculative adopter
            # requires its planes).
            host = self._kv_payload(self.cache, ids)
            dhost = (self._kv_payload(self.draft_cache, ids)
                     if self.spec_k else None)
            for d in new_depths:
                s, e = _kvo.page_span(d, c, self.page_size)
                payload = {key: a[:, s:e] for key, a in host.items()}
                if dhost is not None:
                    for key, a in dhost.items():
                        payload["d" + key] = a[:, s:e]
                meta = _kvo.make_meta(
                    keys[d - 1], d, c, self.page_size,
                    self._kv_fingerprint, self._kv_donor, e - s,
                    bool(self.spec_k), tp=self.tp)
                self._kv_store.donate(meta, payload)
                self.stats["kv_donations"] += 1
                self.stats["kv_donated_pages"] += e - s
                _KV_COUNTERS["donations"].inc(tags=tags)
            self._kv_note_donation(keys[0][:16], n_full)
        except Exception as e:  # noqa: BLE001 — incl. ChaosError: the
            # donor keeps serving; already-published depths stay usable.
            logger.debug("kv donation aborted mid-chain: %s", e)
        finally:
            for p in pages:
                n = self._kv_exporting.get(p, 0) - 1
                if n <= 0:
                    self._kv_exporting.pop(p, None)
                else:
                    self._kv_exporting[p] = n
                self._unref_page(p)
        return desc

    def _kv_adopt_plan(self, req: GenRequest,
                       n_local: int) -> dict | None:
        """The deepest contiguous donated chain prefix of ``req``'s
        context that resolves, when it covers more than the local
        prefix-cache match ``n_local`` (local sharing is zero-copy). The
        walk goes from depth 1 up and stops at the first missing or
        incompatible entry. A full descriptor pre-screens on its
        geometry; a ``{"discover": True}`` hint carries none and goes
        straight to the resolve (each entry is still checked)."""
        if self._kv_store is None or not req.kv:
            return None
        kv = req.kv
        if not kv.get("discover") and (
                kv.get("fingerprint") != self._kv_fingerprint
                or kv.get("chunk") != self.prefill_chunk
                or kv.get("page_size") != self.page_size):
            return None
        cap = (len(req.prompt_ids) - 1) // self.prefill_chunk
        if cap <= 0:
            return None
        chain = extend_chunk_chain(req.prompt_ids, self.prefill_chunk,
                                   req.prefix_hashes)
        keys = [h.hex() for h in chain[:cap]]
        try:
            self.stats["kv_digest_lookups"] += 1
            found = self._kv_store.resolve(keys)
        except Exception as e:  # noqa: BLE001 — an index blip = cold path
            logger.debug("kv adoption resolve failed: %s", e)
            return None
        metas = []
        for d in range(1, cap + 1):
            meta = found.get(keys[d - 1])
            if (meta is None
                    or meta.get("fingerprint") != self._kv_fingerprint
                    or meta.get("chunk") != self.prefill_chunk
                    or meta.get("page_size") != self.page_size
                    or (self.spec_k and not meta.get("draft"))):
                break
            metas.append(meta)
        if not metas or len(metas) * self.prefill_chunk <= n_local:
            return None
        return {"n_tokens": len(metas) * self.prefill_chunk,
                "metas": metas}

    def _bind_kv_adopt(self, slot: int, req: GenRequest,
                       plan: dict) -> int:
        """Adoption bind: fetch the planned payloads (the deepest
        contiguous run that arrives whole: a ``serve.kv.adopt`` drop or a
        torn depth ends it), join a tp > 1 donor's head shards, allocate
        fresh exclusive pages (rolled back if the pool runs dry), write
        the payloads stitched along the page axis with one
        `scatter_pages` per pool (the draft's too), and bind the pages
        into ``slot``'s table like a local warm hit. → adopted tokens (0:
        the ladder falls through)."""
        tags = {"replica": self._impl_tags()["replica"]}
        payloads: list[dict] = []
        for meta in plan["metas"]:
            try:
                p = self._kv_store.fetch(meta)
                donor_tp = int(meta.get("tp", 1) or 1)
                if donor_tp > 1:
                    # Full heads back; the scatter re-slices them per this
                    # engine's mesh, so 2→4, 4→2 and tp→1 are one path.
                    p = _partition.concat_head_planes(p, donor_tp)
                if (p["k"].shape[1] != meta["n_pages"]
                        or (self.spec_k and "dk" not in p)):
                    raise ValueError("kv payload shape mismatch")
                payloads.append(p)
            except Exception as e:  # noqa: BLE001 — adopt what arrived
                logger.debug("kv fetch of depth %s failed: %s",
                             meta.get("depth"), e)
                break
        if not payloads:
            self.stats["kv_adopt_failures"] += 1
            _KV_COUNTERS["adopt_failures"].inc(tags=tags)
            return 0
        n_adopt = len(payloads) * self.prefill_chunk
        n_pages = self._pages_for(n_adopt - 1)
        if n_pages > len(self.free_pages):
            self._cache_reclaim(n_pages)
        alloc: list[int] = []
        for _ in range(n_pages):
            pg = self._alloc_page()
            if pg is None:
                break
            alloc.append(pg)
        if len(alloc) < n_pages:
            # A partial page run cannot serve the adopted prefix.
            for pg in alloc:
                self._unref_page(pg)
            self.stats["kv_adopt_failures"] += 1
            _KV_COUNTERS["adopt_failures"].inc(tags=tags)
            return 0
        width = _pow2_width(n_pages)
        ids = np.zeros(width, np.int32)
        ids[:n_pages] = alloc
        ids = self._to_dev(ids)

        def stitch(names, prefix=""):
            # Every plane joins along the page axis in one host tensor,
            # moved to the device once, and pads there to the pow-2 width
            # with zeros (the padding ids are the null page), so the
            # padding never crosses the bus.
            data = {}
            for name in names:
                a = torch.cat([p[prefix + name] for p in payloads],
                              dim=1).to(self.device)
                if width > n_pages:
                    a = torch.cat([a, a.new_zeros(
                        (a.shape[0], width - n_pages) + a.shape[2:])],
                        dim=1)
                data[name] = a
            return data

        self.cache = self._rt.scatter_pages(
            self.cache, ids, stitch(self._pool_shards()[0]))
        if self.spec_k:
            draft = (self.draft_cache if self.mesh is None
                     else self.draft_cache[0])
            self.draft_cache = self._rt.scatter_pages(
                self.draft_cache, ids, stitch(draft, prefix="d"))
        for i, pg in enumerate(alloc):
            self.page_table[slot, i] = pg
        self.slot_n_pages[slot] = n_pages
        req.cached_tokens = n_adopt
        self.stats["kv_adoptions"] += 1
        self.stats["kv_adopted_tokens"] += n_adopt
        if len(payloads) < len(plan["metas"]):
            self.stats["kv_partial_adoptions"] += 1
        _KV_COUNTERS["adoptions"].inc(tags=tags)
        return n_adopt

    def _handoff_prefill(self, slot: int, req: GenRequest) -> None:
        """Prefill-pool handoff (``pool_role="prefill"``): at the first
        token the prompt's pages are donated and the request leaves as a
        migrated continuation; its consumer resubmits ``(prompt, [first
        token], kv=req.kv_handoff)`` to a decode-pool engine, which adopts
        the pages. The drain export's contract, so greedy streams stay
        the uninterrupted run's across the handoff."""
        req.kv_handoff = self._donate_kv(
            req.prompt_ids, self.page_table[slot], memo=req.prefix_hashes)
        req.migrated = True
        if req.stream is not None:
            req.stream.put(None)
        req.done.set()
        self._release(slot)

    def page_accounting(self) -> dict:
        """Closure check: every pool page is exactly one of free /
        referenced, and every reference is owned by a slot table, a
        prefix-cache entry or an in-flight page-set donation (free + live
        + cached + exporting == total, each page counted once). Valid
        when the engine is stopped or driven synchronously."""
        live: dict[int, int] = {}
        for slot in range(self.n_slots):
            for i in range(int(self.slot_n_pages[slot])):
                pg = int(self.page_table[slot, i])
                live[pg] = live.get(pg, 0) + 1
        pc = self.prefix_cache
        cached = pc.cached_pages() if pc is not None else set()
        # Pages reffed by a donation in progress (gather and store put):
        # empty between ticks, and the category that keeps the closure
        # true when a chaos raise or kill lands mid-donation.
        exporting = dict(self._kv_exporting)
        allocated = set(live) | cached | set(exporting)
        refs_ok = all(
            int(self.page_refs[pg]) == live.get(pg, 0)
            + (pc.page_refs_held(pg) if pc is not None else 0)
            + exporting.get(pg, 0)
            for pg in allocated)
        free = len(self.free_pages)
        return {
            "total": self.n_pages,
            "free": free,
            "live": len(live),
            "cached": len(cached),
            "cached_only": len(cached - set(live)),
            "exporting": len(exporting),
            "shared": sum(1 for pg in live if live[pg] > 1 or pg in cached),
            "closure": free + len(allocated) == self.n_pages,
            "refs_consistent": refs_ok and not (
                set(self.free_pages) & allocated),
        }

    # ------------------------------------------------------------- engine

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _emit(self, req: GenRequest, token: int) -> bool:
        """Append a token; → True if the request just finished."""
        now = time.perf_counter()
        if req.first_token_at is None:
            req.first_token_at = now
            self.stats["ttft_sum"] += now - req.submitted_at
            with self._lock:
                ms = (now - req.submitted_at) * 1000.0
                self._ttft_ms.append(ms)
                if self.prefix_cache is not None:
                    (self._ttft_warm_ms if req.cached_tokens
                     else self._ttft_cold_ms).append(ms)
                self._ttft_ewma_ms = self._ewma(self._ttft_ewma_ms, ms)
            self._emit_ttft_spans(req)
        req.out_ids.append(token)
        if req.stream is not None:
            req.stream.put(token)
        self.stats["tokens_generated"] += 1
        finished = (len(req.out_ids) >= req.max_tokens
                    or (req.eos_id is not None and token == req.eos_id))
        if finished:
            req.finished_at = now
            self.stats["completed"] += 1
            if req.stream is not None:
                req.stream.put(None)  # stream sentinel
            req.done.set()
        return finished

    def _sample(self, logits_row: np.ndarray, temperature: float) -> int:
        if temperature == 0.0:
            return int(np.argmax(logits_row))
        return int(sample_token(torch.from_numpy(logits_row),
                                temperature=temperature,
                                generator=self._host_gen))

    def _bucket(self, n: int) -> int:
        """Smallest prefill bucket holding an n-token prompt."""
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"no bucket for prompt length {n}")

    # One-shot group sizes: same-bucket arrivals prefill 8, 4, 2 or 1 at a
    # time. Admission lookahead bound and the aging limit past which a
    # repeatedly-bypassed head goes strict-FIFO (as in the JAX engine).
    _PREFILL_LADDER = (8, 4, 2)
    _ADMIT_LOOKAHEAD = 8
    _ADMIT_BYPASS_LIMIT = 16

    def _admit(self) -> None:
        """Move queued requests into free slots.

        One-shot mode (prefill_chunk=0): whole-prompt admission; a paged
        request needs pool headroom for its whole prompt plus the first
        decode write, and same-bucket arrivals prefill in ladder-sized
        groups (`_prefill_group`). Chunked mode: a request is admitted
        once ONE CHUNK of pool headroom exists; its prompt then enters
        chunk-by-chunk under step()'s token budget. A prefix-cache hit,
        acquired (pinned) here at reservation time so the reclaim below
        cannot evict it, shrinks the reservation: shared full pages come
        from the cache, so only a COW tail and the first cold chunk's
        pages need the free list; the hit is bound into the slot's table
        and the chunk cursor starts at the first cold token. With KV
        transfer, a request's adoption plan (`_kv_adopt_plan`, resolved
        once per request) that covers more than the local hit reserves
        the whole adopted run plus its first cold chunk, and the bind
        adopts (`_bind_kv_adopt`), releasing the unused local hit, or
        falls through to the local hit or a cold start. Up to
        _ADMIT_LOOKAHEAD page-blocked requests are set aside (returning
        to the deferred head in order, unpinned) while requests behind
        them that fit admit now; a bypassed head ages and past
        _ADMIT_BYPASS_LIMIT blocks all lookahead until it admits."""
        free = [s for s in range(self.n_slots) if self.slot_req[s] is None]
        reqs: list[tuple[GenRequest, object, dict | None]] = []
        blocked: list[GenRequest] = []
        head_mark = 0
        planned_pages = 0
        while len(reqs) < len(free):
            if self._deferred:
                req = self._deferred.popleft()
            else:
                try:
                    req = self.pending.get_nowait()
                except queue.Empty:
                    break
            hit = plan = None
            if self.kv_mode == "paged":
                if self.prefill_chunk:
                    n_cached = 0
                    if self.prefix_cache is not None:
                        hit = self.prefix_cache.acquire(
                            req.prompt_ids, memo=req.prefix_hashes)
                        if hit is not None:
                            n_cached = hit.n_tokens
                    if not req.kv_plan_tried:
                        req.kv_plan = self._kv_adopt_plan(req, n_cached)
                        req.kv_plan_tried = True
                    plan = req.kv_plan
                    if plan is not None:
                        # Adopted pages are fresh exclusive allocations:
                        # the whole adopted run plus the first cold chunk.
                        # The bind may still degrade within it.
                        end = min(plan["n_tokens"] + self.prefill_chunk,
                                  len(req.prompt_ids))
                        need = self._pages_for(end - 1)
                    else:
                        end = min(n_cached + self.prefill_chunk,
                                  len(req.prompt_ids))
                        need = (self._pages_for(end - 1)
                                - n_cached // self.page_size)
                else:
                    need = self._pages_for(len(req.prompt_ids))
                if planned_pages + need > len(self.free_pages):
                    self._cache_reclaim(planned_pages + need)
                if planned_pages + need > len(self.free_pages):
                    if hit is not None:
                        # Not admitted this round: unpin (the entry is
                        # re-acquired when the request is scanned again).
                        self.prefix_cache.release(hit)
                    if not blocked:
                        head_mark = len(reqs)
                        if req.admit_bypasses >= self._ADMIT_BYPASS_LIMIT:
                            blocked.append(req)
                            break   # aged head: strict FIFO until it fits
                    blocked.append(req)
                    if len(blocked) >= self._ADMIT_LOOKAHEAD:
                        break
                    continue
                planned_pages += need
            reqs.append((req, hit, plan))
        for req in reversed(blocked):
            self._deferred.appendleft(req)   # original order, at the head
        if blocked and len(reqs) > head_mark:
            blocked[0].admit_bypasses += 1
        if not self.prefill_chunk:
            by_bucket: dict[int, list[GenRequest]] = {}
            for req, *_x in reqs:
                by_bucket.setdefault(self._bucket(len(req.prompt_ids)),
                                     []).append(req)
            slot_iter = iter(free)
            for bucket, group in by_bucket.items():
                while group:
                    n = next((k for k in self._PREFILL_LADDER
                              if k <= len(group)), 1)
                    batch, group = group[:n], group[n:]
                    self._prefill_group(bucket, batch,
                                        [next(slot_iter) for _ in batch])
            return
        for (req, hit, plan), slot in zip(reqs, free):
            n_cached = 0
            if plan is not None:
                n_cached = self._bind_kv_adopt(slot, req, plan)
            if n_cached:
                # Adopted: the pinned local entry goes unused (adoption
                # only planned when it covers MORE than the local hit).
                if hit is not None:
                    self.prefix_cache.release(hit)
            elif self.prefix_cache is not None:
                # The ladder falls through: local warm hit, else cold.
                n_cached = self._bind_cached_prefix(slot, req, hit)
            with self._lock:
                self.slot_req[slot] = req
            self.tokens[slot] = 0
            self.positions[slot] = 0
            self.temps[slot] = req.temperature
            self._chunk_pos[slot] = n_cached
            self._prefilling.append(slot)

    def _bind_cached_prefix(self, slot: int, req: GenRequest, entry) -> int:
        """Warm admission: bind ``entry``, the cached chunk-aligned prefix
        of ``req.prompt_ids`` that _admit acquired, into ``slot``'s table.
        Full pages are shared READ-ONLY (refcount bumped; the binder's
        writes all land past them). A prefix ending mid-page gets a fresh
        tail page and a queued (src, dst) copy (`_apply_cow`); with no
        page free for it the bind falls back to the full pages. → tokens
        served from the cache (the chunk cursor's start)."""
        tags = {"replica": self._impl_tags()["replica"]}
        # Reset first: a preempted warm request may re-admit cold.
        req.cached_tokens = 0
        if entry is None:
            self.stats["prefix_misses"] += 1
            _PREFIX_COUNTERS["misses"].inc(tags=tags)
            return 0
        ps = self.page_size
        n_cached = entry.n_tokens
        p_full = n_cached // ps
        for i in range(p_full):
            self._ref_page(entry.pages[i])
            self.page_table[slot, i] = entry.pages[i]
        self.slot_n_pages[slot] = p_full
        if n_cached % ps:
            dst = self._alloc_page()
            if dst is None:
                n_cached = p_full * ps
            else:
                self.page_table[slot, p_full] = dst
                self.slot_n_pages[slot] = p_full + 1
                self._cow_pairs.append((int(entry.pages[p_full]), int(dst)))
                self.stats["cow_copies"] += 1
                _PREFIX_COUNTERS["cow_copies"].inc(tags=tags)
        if n_cached <= 0:
            # Cold after all: a prefix shorter than a page, no COW page.
            self.prefix_cache.release(entry)
            self.stats["prefix_misses"] += 1
            _PREFIX_COUNTERS["misses"].inc(tags=tags)
            return 0
        self._slot_entry[slot] = entry
        req.cached_tokens = n_cached
        self.stats["prefix_hits"] += 1
        self.stats["prefix_cached_tokens"] += n_cached
        _PREFIX_COUNTERS["hits"].inc(tags=tags)
        return n_cached

    def _apply_cow(self) -> None:
        """Flush the tick's queued copy-on-write pairs as one `copy_pages`
        call per pool, mirrored into the draft's pool (draft page p holds
        the draft's K/V of target page p's tokens). Runs before the tick's
        first dispatch: a warm slot's first cold chunk writes into its
        copied tail page."""
        if not self._cow_pairs:
            return
        pairs, self._cow_pairs = self._cow_pairs, []
        src, dst = (self._to_dev(np.asarray(a, np.int64))
                    for a in zip(*pairs))
        self.cache = self._rt.copy_pages(self.cache, src, dst)
        if self.spec_k:
            self.draft_cache = self._rt.copy_pages(self.draft_cache, src,
                                                   dst)

    def _prefill_group(self, bucket: int, group: list[GenRequest],
                       slots: list[int]) -> None:
        """One-shot admission: whole-prompt prefill of a same-bucket
        GROUP in one dispatch (`prefill_batch_paged`; dense: `prefill`
        for one request, `prefill_batch` for more), then each request's
        first token, sampled on the host. Paged slots first grow to cover
        the prompt and the first decode write (_admit reserved the
        headroom); on a failure those pages return to the pool and every
        request of the group fails."""
        n = len(group)
        padded = np.zeros((n, bucket), np.int32)
        lengths = np.zeros(n, np.int32)
        for i, req in enumerate(group):
            lengths[i] = len(req.prompt_ids)
            padded[i, :lengths[i]] = req.prompt_ids
        t0 = time.perf_counter()
        for req in group:
            if req.first_chunk_at is None:
                req.first_chunk_at = t0
        try:
            if self.kv_mode == "paged":
                pages = np.zeros((n, self._pages_for(bucket - 1)), np.int32)
                for i, slot in enumerate(slots):
                    if not self._grow_slot(slot, int(lengths[i])):
                        raise RuntimeError("page reservation desync")
                    take = min(int(self.slot_n_pages[slot]), pages.shape[1])
                    pages[i, :take] = self.page_table[slot, :take]
                last, self.cache = _paged.prefill_batch_paged(
                    self.cfg, self.params, self._to_dev(padded), self.cache,
                    self._to_dev(pages), self._to_dev(lengths))
            elif n == 1:
                last, self.cache = _dense.prefill(
                    self.cfg, self.params, self._to_dev(padded), self.cache,
                    slots[0], int(lengths[0]))
                last = last[None, :]
            else:
                last, self.cache = _dense.prefill_batch(
                    self.cfg, self.params, self._to_dev(padded), self.cache,
                    self._to_dev(np.asarray(slots, np.int64)),
                    self._to_dev(lengths))
            last = last.cpu().numpy()
        except Exception as e:  # noqa: BLE001 — becomes the requests' error
            if self.kv_mode == "paged":
                for slot in slots:
                    self._free_slot_pages(slot)
            for req in group:
                req.error = f"prefill failed: {e!r}"
                req.done.set()
            return
        now = time.perf_counter()
        self.stats["prefill_time_s"] += now - t0
        self.stats["prefill_tokens"] += int(lengths.sum())
        for i, (req, slot) in enumerate(zip(group, slots)):
            req.last_chunk_at = now
            tok = self._sample(last[i], req.temperature)
            with self._lock:
                self.slot_req[slot] = req
            self.tokens[slot] = tok
            self.positions[slot] = int(lengths[i])
            self.temps[slot] = req.temperature
            if self._emit(req, tok):
                self._release(slot)

    def _run_prefill_chunks(self, decode_active: bool) -> int:
        """Spend the per-tick prefill token budget: advance mid-prefill
        slots chunk-by-chunk, FCFS. With decode in flight the budget is
        strict; with nothing decoding an idle tick always advances at
        least one chunk. → tokens spent."""
        if not self._prefilling:
            return 0
        budget = self.prefill_budget
        if not decode_active:
            budget = max(budget, self.prefill_chunk)
        spent = 0
        while self._prefilling:
            # One dispatch of up to n_slots chunk ROWS, FCFS, until rows
            # or the budget run out; consecutive chunks of one prompt may
            # ride as separate rows (write-before-attend per layer keeps
            # them exact).
            batch: list[tuple[int, GenRequest, int, int]] = []
            planned = 0
            stop = False
            for slot in self._prefilling:
                if stop or len(batch) >= self.n_slots:
                    break
                req = self.slot_req[slot]
                done = self._chunk_pos[slot]
                total = len(req.prompt_ids)
                while done < total and len(batch) < self.n_slots:
                    n = min(self.prefill_chunk, total - done)
                    if spent + planned + n > budget:
                        stop = True
                        break
                    if not self._grow_slot(slot, done + n - 1):
                        stop = True   # pool dry: FCFS stops at the head
                        break
                    batch.append((slot, req, done, n))
                    planned += n
                    done += n
            if not batch:
                # Nothing decoding and several mid-prefill slots wedged
                # against each other: preempt the youngest page-holding
                # one to unwedge the head.
                if (not decode_active and spent == 0
                        and len(self._prefilling) > 1):
                    reclaim = [s for s in self._prefilling
                               if int(self.slot_n_pages[s])]
                    if reclaim:
                        self._preempt(reclaim[-1])
                        continue
                break
            self._dispatch_chunks(batch)
            spent += planned
        return spent

    def _chunk_width(self, done: int, n: int) -> int:
        """Pow-2 page-table width a chunk row [done, done+n) attends over."""
        return min(_pow2_width(self._pages_for(done + n - 1)),
                   self.max_pages_per_slot)

    def _dispatch_chunks(self, batch) -> None:
        """Width-bucketed chunk dispatch: one [n_slots, C] dispatch per
        pow-2 width bucket, in ASCENDING width order (consecutive chunks
        of one prompt have non-decreasing widths, so the write-before-
        attend chain holds across buckets)."""
        if not self.prefill_width_bucketing:
            self._dispatch_chunk_bucket(batch, self.max_pages_per_slot)
            return
        buckets: dict[int, list] = {}
        for row in batch:
            _slot, _req, done, n = row
            buckets.setdefault(self._chunk_width(done, n), []).append(row)
        failed: set[int] = set()
        for width in sorted(buckets):
            rows = [r for r in buckets[width] if r[0] not in failed]
            if rows:
                failed |= self._dispatch_chunk_bucket(rows, width)

    def _dispatch_chunk_bucket(self, batch, width: int) -> set[int]:
        """One fixed-shape [n_slots, C] prefill_chunk_paged dispatch at one
        page-table width; rows without work are inert (n_valid 0). Final
        chunks return logits and graduate their slot to decode (the first
        token emits here). A dispatch exception becomes an error on every
        request in the batch, as in the JAX engine: callers that must not
        mistake a kernel fault for a finished request check ``req.error``.
        → slots released by a failure (empty on success)."""
        toks = np.zeros((self.n_slots, self.prefill_chunk), np.int32)
        offsets = np.zeros(self.n_slots, np.int32)
        valid = np.zeros(self.n_slots, np.int32)
        tables = np.zeros((self.n_slots, width), np.int32)
        any_final = False
        t0 = time.perf_counter()
        for i, (slot, req, done, n) in enumerate(batch):
            toks[i, :n] = req.prompt_ids[done:done + n]
            offsets[i] = done
            valid[i] = n
            tables[i] = self.page_table[slot, :width]
            any_final |= done + n >= len(req.prompt_ids)
            if req.first_chunk_at is None:
                req.first_chunk_at = t0
        try:
            args = [self._to_dev(a) for a in (toks, tables, offsets, valid)]
            last, self.cache = self._rt.prefill_chunk_paged(
                self.cfg, self.params, args[0], self.cache, *args[1:],
                return_logits=any_final, attn_impl=self.attn_impl)
            if self.spec_k:
                # Draft prefill mirror: the same rows through the draft
                # into its pool (same tables and offsets), so a slot
                # graduates with the draft's cursor at the target's. The
                # draft's logits are unused (propose feeds the pending
                # token itself), so the no-head program runs.
                _none, self.draft_cache = self._rt.prefill_chunk_paged(
                    self.draft_cfg, self.draft_params, args[0],
                    self.draft_cache, *args[1:], return_logits=False,
                    attn_impl=self.attn_impl)
            if any_final:
                last = last.cpu().numpy()
            else:
                self._sync()
        except Exception as e:  # noqa: BLE001 — becomes the requests' error
            failed = set()
            for slot, req, _done, _n in batch:
                if slot in failed:
                    continue
                failed.add(slot)
                req.error = f"prefill failed: {e!r}"
                req.done.set()
                self._release(slot)
            return failed
        now = time.perf_counter()
        self.stats["prefill_time_s"] += now - t0
        self.stats["prefill_tokens"] += sum(n for *_x, n in batch)
        self.stats["prefill_chunks"] += len(batch)
        self.stats["prefill_dispatches"] += 1
        self._dispatch_width_ring.append(width)
        self._dispatch_width_counts[width] = (
            self._dispatch_width_counts.get(width, 0) + 1)
        _PREFILL_CHUNK_HIST.observe(now - t0, tags=self._impl_tags())
        _PREFILL_DISPATCH_COUNTER.inc(
            1.0, tags={"replica": self._impl_tags()["replica"],
                       "width": str(width)})
        for i, (slot, req, done, n) in enumerate(batch):
            self._chunk_pos[slot] = done + n
            if done + n < len(req.prompt_ids):
                continue
            req.last_chunk_at = now
            self._prefilling.remove(slot)
            self._chunk_pos.pop(slot, None)
            tok = self._sample(last[i], req.temperature)
            self.tokens[slot] = tok
            self.positions[slot] = len(req.prompt_ids)
            self.temps[slot] = req.temperature
            if self._emit(req, tok):
                self._release(slot)
            elif self.pool_role == "prefill":
                # The prefill pool's work ends at the first token: donate
                # the prompt's pages and hand the stream off.
                self._handoff_prefill(slot, req)
        return set()

    def _release(self, slot: int) -> None:
        """Free a slot and its pages. Positions reset so multi-step
        windows never walk an idle slot's write cursor toward the cache
        boundary.

        Insert-on-free: a request that completed cleanly donates its
        chunk-aligned written prefix (prompt AND generated tokens) to the
        prefix cache BEFORE its cursor is zeroed and its pages unreffed,
        so the cache's refs keep the donated pages alive. positions[slot]
        counts the slot's written positions on every path; the written
        sequence is prompt_ids[:n_prompt] + out_ids (a preempt already
        folded earlier tokens into prompt_ids). Preempted and failed
        slots never donate: a preempt reclaims pages, and a failed
        dispatch's pages may be garbage; migrated requests only when
        handed off (their pages were just object-donated, and are as good
        local warm state).

        With KV transfer a fused engine (no pool role) also donates a
        completed request's written prefix as page-set objects, unless
        its summary memo shows that chain donated at least as deep."""
        req = self.slot_req[slot]
        with self._lock:
            self.slot_req[slot] = None
        clean = (req is not None and req.done.is_set()
                 and req.error is None)
        if clean:
            seq = (req.prompt_ids[:req.n_prompt]
                   + req.out_ids)[:int(self.positions[slot])]
        if (clean and self.prefix_cache is not None
                and (not req.migrated or req.kv_handoff is not None)):
            self.prefix_cache.donate(seq, self.page_table[slot],
                                     memo=req.prefix_hashes)
            self._sync_cache_evictions()
        if (clean and self._kv_store is not None and self.pool_role is None
                and not req.migrated):
            head = self._kv_chain_head(seq)
            if (head is not None and self._kv_donated.get(head, 0)
                    < len(seq) // self.prefill_chunk):
                self._donate_kv(seq, self.page_table[slot],
                                memo=req.prefix_hashes)
        self.tokens[slot] = 0
        self.positions[slot] = 0
        self.temps[slot] = 0.0
        if slot in self._chunk_pos:      # mid-prefill slot going away
            self._chunk_pos.pop(slot, None)
            self._prefilling.remove(slot)
        entry = self._slot_entry.pop(slot, None)
        if entry is not None:
            self.prefix_cache.release(entry)
        if self.kv_mode == "paged":
            self._free_slot_pages(slot)

    def _preempt(self, slot: int) -> None:
        """Evict a slot by RECOMPUTE: its pages return to the pool and the
        request re-enters the queue head with context = prompt_ids[:
        n_prompt] + everything generated, so a later prefill rebuilds the
        KV and generation continues exactly where it stopped."""
        req = self.slot_req[slot]
        req.prompt_ids = (list(req.prompt_ids[:req.n_prompt])
                          + [int(t) for t in req.out_ids])
        self._release(slot)
        self.stats["preemptions"] += 1
        if (len(req.prompt_ids) > self._prompt_cap
                or self._pages_for(len(req.prompt_ids)) > self.n_pages):
            req.truncated = True
            self._finish(req)
            return
        self._deferred.appendleft(req)

    def _finish(self, req: GenRequest) -> None:
        """Slot-independent completion bookkeeping."""
        req.finished_at = time.perf_counter()
        self.stats["completed"] += 1
        if req.stream is not None:
            req.stream.put(None)
        req.done.set()

    def _fit_window_pages(self, active: list[int],
                          k: int) -> tuple[list[int], int]:
        """Shrink the window and/or preempt until the pool covers every
        active slot's writes for the window, then allocate.
        → (surviving active slots, window size; 0 = nothing to run)."""
        while active:
            for kk in [k] + [x for x in self._k_ladder if x < k] + [1]:
                extra = sum(
                    max(0, self._pages_for(int(self.positions[s]) + kk - 1)
                        - int(self.slot_n_pages[s]))
                    for s in active)
                if extra > len(self.free_pages):
                    # Cached pages go before a window shrinks, and long
                    # before anything is preempted.
                    self._cache_reclaim(extra)
                if extra <= len(self.free_pages):
                    for s in active:
                        if not self._grow_slot(
                                s, int(self.positions[s]) + kk - 1):
                            raise RuntimeError("page fit desync")
                    return active, kk
            active = self._shed_for_pages(active)
        return [], 0

    def _shed_for_pages(self, active: list[int]) -> list[int]:
        """Pressure relief, in fixed order: reclaim the youngest
        page-holding mid-prefill slot; else, if a sole survivor still
        can't fit, finish it; else preempt the decode victim with the
        most remaining budget. → surviving active slots."""
        reclaim = [s for s in self._prefilling
                   if int(self.slot_n_pages[s])]
        if reclaim:
            self._preempt(reclaim[-1])
            return active
        if len(active) == 1:
            self._finish_capacity(active[0])
            return []
        victim = max(active, key=lambda s: self.slot_req[s].max_tokens
                     - len(self.slot_req[s].out_ids))
        self._preempt(victim)
        return [s for s in active if s != victim]

    def _finish_capacity(self, slot: int) -> None:
        """Slot exhausted the cache: finish early rather than overflow."""
        req = self.slot_req[slot]
        req.error = None
        req.truncated = True
        self._finish(req)
        self._release(slot)

    def _pick_window(self, active: list[int]) -> int:
        """Fused-decode window size, bounded by the longest remaining
        budget and strictly by the KV capacity of the furthest slot."""
        remaining = max(self.slot_req[s].max_tokens
                        - len(self.slot_req[s].out_ids) for s in active)
        if any(self.slot_req[s].eos_id is not None for s in active):
            remaining = min(remaining, 8)
        cap = self.max_len - int(max(self.positions[s] for s in active))
        bound = min(remaining, cap)
        for k in self._k_ladder:
            if k <= bound:
                return k
        return 1

    def _decode_table_view(self, active: list[int]) -> np.ndarray:
        """Page-table view for a decode dispatch: sliced to the pow-2
        width of the widest ACTIVE slot; mid-prefill slots' rows are
        zeroed in a COPY so their window writes land on the null page."""
        w = max(1, int(self.slot_n_pages[active].max()))
        width = min(_pow2_width(w), self.max_pages_per_slot)
        view = self.page_table[:, :width]
        if self._prefilling:
            view = view.copy()
            view[self._prefilling] = 0
        return view

    # --------------------------------------------- speculative decoding

    def _fit_spec_pages(self, active: list[int], k_map: dict) -> list[int]:
        """Grow every active slot to cover its verify writes (cursor ..
        cursor + k_i). Under pressure, in order: reclaim zero-active
        cache entries at each rung, degrade the proposal budgets (k_i →
        1 → 0; a 0-proposal tick is a one-token verify, i.e. a decode
        step), then `_shed_for_pages`. → surviving active slots."""
        while active:
            for shrink in (None, 1, 0):
                ext = {s: (k_map[s] if shrink is None
                           else min(k_map[s], shrink)) for s in active}
                extra = sum(
                    max(0, self._pages_for(int(self.positions[s]) + ext[s])
                        - int(self.slot_n_pages[s]))
                    for s in active)
                if extra > len(self.free_pages):
                    self._cache_reclaim(extra)
                if extra <= len(self.free_pages):
                    for s in active:
                        k_map[s] = ext[s]
                        if not self._grow_slot(
                                s, int(self.positions[s]) + ext[s]):
                            raise RuntimeError("page fit desync")
                    return active
            active = self._shed_for_pages(active)
        return []

    def _rollback_spec_pages(self, slots: list[int]) -> None:
        """Drop, in one vectorized update over the surviving slots, the
        pages past each slot's rolled-back cursor: they were grown for
        this tick alone (shared prefix-cache pages always sit below the
        cursor), so one unref frees them and no partly verified K/V is
        kept."""
        if not slots:
            return
        rows = np.asarray(slots, np.int64)
        keep = (self.positions[rows] - 1) // self.page_size + 1
        have = self.slot_n_pages[rows]
        cols = np.arange(self.max_pages_per_slot)[None, :]
        drop = (cols >= keep[:, None]) & (cols < have[:, None])
        if drop.any():
            tbl = self.page_table[rows]
            dropped = tbl[drop]
            self.page_refs[dropped] -= 1
            freed = dropped[self.page_refs[dropped] <= 0]
            self.page_refs[freed] = 0
            self.free_pages.extend(int(p) for p in freed)
            tbl[drop] = 0
            self.page_table[rows] = tbl
            self.slot_n_pages[rows] = np.minimum(have, keep)

    def _spec_decode_window(self, active: list[int],
                            tick_prefill: bool) -> int:
        """One speculative tick for every decode-ready slot: the draft
        proposes up to spec_k tokens per slot in one fused loop
        (`spec_draft_propose`: k+1 draft steps), the target scores all
        k+1 positions in one verify pass (`verify_chunk_paged`),
        `spec_accept_tokens` accepts a prefix of the proposals plus a
        correction or bonus token, and the rejected tail's pages roll
        back. When no active slot samples, only the [B, k+1] argmax of
        the verify logits (and the [k, B] proposals) cross to the host.
        → slots that did decode work."""
        k = self.spec_k
        survivors = []
        for slot in active:
            if self.positions[slot] + 1 >= self.max_len:
                self._finish_capacity(slot)
            else:
                survivors.append(slot)
        active = survivors
        if not active:
            self._last_window_end = None
            return 0
        # Per-slot proposal budget: never past the request's remaining
        # output (- 1: the verify pass always emits one token beyond the
        # accepted proposals) or the KV capacity. 0 is legal: the tick is
        # a one-token verify but still runs the fixed-shape pair.
        k_map = {
            s: max(0, min(k,
                          self.slot_req[s].max_tokens
                          - len(self.slot_req[s].out_ids) - 1,
                          self.max_len - 1 - int(self.positions[s])))
            for s in active}
        active = self._fit_spec_pages(active, k_map)
        if not active:
            self._last_window_end = None
            return 0
        table_view = self._to_dev(self._decode_table_view(active))
        n_prop = np.full(self.n_slots, -1, np.int32)
        for slot in active:
            n_prop[slot] = k_map[slot]
        t0 = time.perf_counter()
        sampling = any(self.slot_req[s].temperature > 0.0 for s in active)
        tokens, positions = (self._to_dev(a)
                             for a in (self.tokens, self.positions))
        propose = self._rt.spec_draft_propose
        proposals, draft_probs, self.draft_cache = propose(
            self.draft_cfg, self.draft_params, tokens, self.draft_cache,
            positions, table_view, self._to_dev(n_prop),
            self._to_dev(self.temps), self._gen, k=k,
            attn_impl=self.attn_impl, need_probs=sampling)
        # Verify rows: [pending, d_1 .. d_k] per slot at its decode
        # cursor; inert rows (mid-prefill and free slots) carry n_valid 0.
        vtoks = torch.cat([tokens[:, None], proposals.T], dim=1)
        n_valid = np.where(n_prop >= 0, n_prop + 1, 0).astype(np.int32)
        with self._sampled_span("llm.spec_verify"):
            logits, self.cache = self._rt.verify_chunk_paged(
                self.cfg, self.params, vtoks, self.cache, table_view,
                positions, self._to_dev(n_valid), attn_impl=self.attn_impl)
            proposals = proposals.cpu().numpy()               # [k, B]
            if sampling:
                draft_probs = draft_probs.cpu().numpy()       # [k, B, V]
                logits, argmax = logits.cpu().numpy(), None   # [B, k+1, V]
            else:
                logits, argmax = None, torch.argmax(
                    logits, dim=-1).cpu().numpy()             # [B, k+1]
        proposed = accepted = emitted_total = 0
        survivors = []
        for slot in active:
            req = self.slot_req[slot]
            ki = k_map[slot]
            proposed += ki
            emitted, j = spec_accept_tokens(
                self._spec_rng, req.temperature, proposals[:, slot],
                draft_probs[:, slot] if sampling else None,
                logits[slot] if sampling else None, ki,
                verify_argmax=None if sampling else argmax[slot])
            self._spec_pos[0, :ki] += 1
            self._spec_pos[1, :j] += 1
            t = int(self.positions[slot])
            e = 0
            finished = False
            for tok in emitted:
                e += 1
                if self._emit(req, tok):
                    finished = True
                    break
            # Every emitted token but the last has its K/V written by the
            # verify pass ([pending, d_1..d_ki] at t..t+ki); the last is
            # the new pending token, as in non-speculative decode.
            self.positions[slot] = t + e
            accepted += min(j, e)
            emitted_total += e
            if finished:
                # The donation reads positions[slot]: accepted tokens only.
                self._release(slot)
            else:
                self.tokens[slot] = emitted[e - 1]
                survivors.append(slot)
        self._rollback_spec_pages(survivors)
        end = time.perf_counter()
        cap = (sum(k_map[s] + 1 for s in active)
               + (self.n_slots - len(active)) * (k + 1))
        per_slot = emitted_total / len(active)
        self._observe_decode(t0, end, per_slot, emitted_total, cap,
                             tick_prefill)
        tags = {"replica": self._impl_tags()["replica"]}
        with self._lock:
            self.stats["spec_ticks"] += 1
            self.stats["spec_slot_steps"] += len(active)
            self.stats["spec_proposed"] += proposed
            self.stats["spec_accepted"] += accepted
            self.stats["spec_emitted"] += emitted_total
            self._spec_accept_ewma = self._ewma(self._spec_accept_ewma,
                                                per_slot)
        if proposed:
            _SPEC_COUNTERS["proposed"].inc(float(proposed), tags=tags)
        if accepted:
            _SPEC_COUNTERS["accepted"].inc(float(accepted), tags=tags)
        return len(active)

    def step(self) -> int:
        """One engine tick: admit queued requests (one-shot: prefill them
        whole), flush their copy-on-write pairs, spend the chunked-prefill
        token budget, then one fused decode window (or one speculative
        tick) for every decode-ready slot. → slots that did work. The
        tick is fenced by ``_mid_tick`` for `drain`."""
        with self._lock:
            self._mid_tick = True
        try:
            return self._step()
        finally:
            with self._lock:
                self._mid_tick = False

    def _step(self) -> int:
        pt0 = self.stats["prefill_tokens"]
        self._admit()
        # The COW flush MUST precede any dispatch that could write this
        # tick: a warm slot's first cold chunk writes its copied page.
        self._apply_cow()
        if self.prefill_chunk:
            decode_ready = any(
                self.slot_req[i] is not None and i not in self._chunk_pos
                for i in range(self.n_slots))
            had_prefill_work = bool(self._prefilling)
            spent = self._run_prefill_chunks(decode_ready)
            if had_prefill_work and self.prefill_budget > 0:
                # How much of the tick's prefill allowance a tick with
                # prefill work waiting spent: sustained ~1.0 under a
                # queue means prefill throughput sets TTFT.
                with self._lock:
                    self._budget_util_ewma = self._ewma(
                        self._budget_util_ewma,
                        min(1.0, spent / self.prefill_budget))
        active = [i for i in range(self.n_slots)
                  if self.slot_req[i] is not None
                  and i not in self._chunk_pos]
        n_prefilling = len(self._prefilling)
        if not active:
            self._last_window_end = None
            return n_prefilling
        tick_prefill = self.stats["prefill_tokens"] > pt0
        # Chaos fault point: a "raise" rule kills the engine thread, a
        # "kill" rule the process, with decodes in flight.
        _chaos.hit("llm.decode_window")
        if self.spec_k:
            # Speculation replaces the fused window: one propose dispatch
            # and one verify pass per tick, 1..k+1 tokens per slot.
            return self._spec_decode_window(active, tick_prefill) + (
                n_prefilling)
        paged = self.kv_mode == "paged"
        if paged:
            # A window can leave a cursor AT max_len; the next write would
            # land past the cache (with max_len a multiple of the page
            # size, one page past the slot's table). Finish such a slot
            # without that step, as the dense engine does.
            full = [s for s in active if self.positions[s] >= self.max_len]
            for slot in full:
                self._finish_capacity(slot)
            active = [s for s in active if s not in full]
            if not active:
                self._last_window_end = None
                return n_prefilling
        k = self._pick_window(active)
        if paged:
            active, k = self._fit_window_pages(active, k)
            if not active:
                self._last_window_end = None
                return n_prefilling
            table_view = self._decode_table_view(active)
        t0 = time.perf_counter()
        if paged:
            table_view = self._to_dev(table_view)
        tokens, positions = (self._to_dev(a)
                             for a in (self.tokens, self.positions))
        if k > 1:
            temps = self._to_dev(self.temps)
            with self._sampled_span("llm.decode_window"):
                if paged:
                    toks_out, self.cache = self._rt.decode_multi_paged(
                        self.cfg, self.params, tokens, self.cache, positions,
                        table_view, k, temps, self._gen,
                        attn_impl=self.attn_impl)
                else:
                    toks_out, self.cache = _dense.decode_multi(
                        self.cfg, self.params, tokens, self.cache, positions,
                        k, temps, self._gen)
                toks_out = toks_out.cpu().numpy()  # [k, B]
            self._observe_window(t0, time.perf_counter(), k, len(active),
                                 tick_prefill)
            for slot in active:
                req = self.slot_req[slot]
                finished = False
                for i in range(k):
                    if self._emit(req, int(toks_out[i, slot])):
                        finished = True
                        break
                if finished:
                    self._release(slot)
                else:
                    self.tokens[slot] = toks_out[k - 1, slot]
                    self.positions[slot] += k
            return len(active) + n_prefilling
        with self._sampled_span("llm.decode_window"):
            if paged:
                logits, self.cache = self._rt.decode_step_paged(
                    self.cfg, self.params, tokens, self.cache, positions,
                    table_view, attn_impl=self.attn_impl)
            else:
                logits, self.cache = _dense.decode_step(
                    self.cfg, self.params, tokens, self.cache, positions)
            logits = logits.cpu().numpy()
        self._observe_window(t0, time.perf_counter(), 1, len(active),
                             tick_prefill)
        for slot in active:
            req = self.slot_req[slot]
            if self.positions[slot] + 1 >= self.max_len:
                self._finish_capacity(slot)
                continue
            tok = self._sample(logits[slot], req.temperature)
            self.tokens[slot] = tok
            self.positions[slot] += 1
            if self._emit(req, tok):
                self._release(slot)
        return len(active) + n_prefilling

    def _loop(self) -> None:
        try:
            while not self._shutdown.is_set():
                n = self.step()
                if n == 0 and self.pending.empty() and not self._deferred:
                    time.sleep(0.002)   # idle: block briefly, don't spin
        except Exception as exc:  # noqa: BLE001
            # The engine thread is the only consumer: if it dies, fail
            # every queued/active request loudly and poison submits.
            with self._lock:
                self._fatal = f"engine died: {exc!r}"
                doomed = []
                for slot, req in enumerate(self.slot_req):
                    if req is not None:
                        doomed.append(req)
                        self.slot_req[slot] = None
                self._prefilling.clear()
                self._chunk_pos.clear()
                doomed.extend(self._deferred)
                self._deferred.clear()
                while True:
                    try:
                        doomed.append(self.pending.get_nowait())
                    except queue.Empty:
                        break
            for req in doomed:
                req.error = self._fatal
                if req.stream is not None:
                    req.stream.put(None)
                req.done.set()


__all__ = ["LLMEngine", "GenRequest"]
