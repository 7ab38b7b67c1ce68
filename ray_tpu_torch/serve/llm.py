"""Continuous-batching LLM engine on the paged KV cache (PyTorch/CUDA).

Counterpart of ``ray_tpu/serve/llm.py``'s `LLMEngine`, restricted to the
serving main path: ``kv_mode="paged"`` with chunked prefill. A fixed
pool of slots advances one fused decode window per tick; prompts enter
their slot's page table chunk by chunk under a per-tick prefill token
budget (Sarathi/Orca-style stall-free batching), width-bucketed by the
pow-2 page width each chunk attends over. The host-side scheduler,
page refcounts and page accounting are the same numpy logic as the JAX
engine's; only the device programs (``models/paged_kv.py``) differ.

Not ported in this slice, each rejected with a ValueError when asked
for: dense KV, one-shot prefill, the prefix cache, speculative
decoding, tensor parallelism, int8 weights / KV, KV page-set transfer
(pool roles, kv_transfer, kv_store), drain/export, compile warmup and
the Serve deployment wrapper. The tracing, profiling, chaos and
compile-watch hooks of the JAX engine have no counterpart here.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import queue
import threading
import time
import uuid

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models import gpt
from ray_tpu_torch.models import paged_kv as _paged
from ray_tpu_torch.models.decode import sample_token

# Engine defaults, copied from the JAX package's runtime config.
DEFAULT_DECODE_BLOCK = 8
DEFAULT_PAGE_SIZE = 64
DEFAULT_PREFILL_CHUNK = 256
DEFAULT_PREFILL_TOKEN_BUDGET = 256
DEFAULT_WIDTH_BUCKETING = True


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
    # Admission aging (starvation guard), as in the JAX engine.
    admit_bypasses: int = 0
    out_ids: list[int] = dataclasses.field(default_factory=list)
    truncated: bool = False   # finished early (capacity/unresumable preempt)
    stream: "queue.Queue | None" = None
    done: "threading.Event" = dataclasses.field(
        default_factory=threading.Event)
    error: str | None = None


def _not_ported(feature: str) -> ValueError:
    return ValueError(f"{feature} is not yet ported to ray_tpu_torch "
                      "(this slice serves paged KV with chunked prefill)")


class LLMEngine:
    """Slot-based continuous batching over ray_tpu_torch.models.paged_kv.

    Runs on ``device`` (default cuda; a missing GPU raises unless
    ``device="cpu"``). ``attn_impl``: "kernel" (the CUDA paged-attention
    kernels), "gather" (their plain PyTorch versions) or "auto" (kernel
    on CUDA, gather on the CPU). Parameters are cast to ``cfg.dtype``
    and moved to the device once, here.
    """

    def __init__(self, cfg, params=None, *, n_slots: int = 8,
                 max_len: int = 2048, seed: int = 0,
                 decode_block: int = DEFAULT_DECODE_BLOCK,
                 kv_mode: str = "paged",
                 page_size: int = DEFAULT_PAGE_SIZE,
                 n_pages: int | None = None, attn_impl: str = "auto",
                 prefill_chunk: int = DEFAULT_PREFILL_CHUNK,
                 prefill_token_budget: int = DEFAULT_PREFILL_TOKEN_BUDGET,
                 prefill_width_bucketing: bool = DEFAULT_WIDTH_BUCKETING,
                 device=None,
                 prefix_cache: bool = False, spec_draft=None,
                 spec_draft_params=None, tp: int = 1,
                 pool_role: str | None = None, kv_transfer: bool = False,
                 kv_store=None, weight_dtype: str = "bf16",
                 kv_dtype: str = "bf16", warmup: bool = False):
        for asked, feature in (
                (kv_mode != "paged", f"kv_mode={kv_mode!r}"),
                (not prefill_chunk, "one-shot prefill (prefill_chunk=0)"),
                (bool(prefix_cache), "the prefix cache"),
                (bool(spec_draft) or spec_draft_params is not None,
                 "speculative decoding"),
                (tp != 1, "tensor parallelism (tp > 1)"),
                (pool_role is not None or bool(kv_transfer)
                 or kv_store is not None, "KV page-set transfer"),
                (weight_dtype != "bf16", "int8 weights"),
                (kv_dtype != "bf16", "int8 KV pools"),
                (bool(warmup), "compile warmup")):
            if asked:
                raise _not_ported(feature)
        self.device = resolve_device(device)
        if attn_impl == "auto":
            # Resolved once: the kernels on CUDA, their plain versions on
            # the CPU (where a CUDA kernel cannot run at all).
            attn_impl = "kernel" if self.device.type == "cuda" else "gather"
        if attn_impl not in _paged.ATTN_IMPLS:
            raise ValueError(
                f"attn_impl must be gather|kernel|auto, got {attn_impl!r}")
        if prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be > 0, got {prefill_chunk}")
        if prefill_chunk > max_len:
            raise ValueError(
                f"prefill_chunk ({prefill_chunk}) exceeds the KV cache "
                f"(max_len = {max_len})")
        if prefill_token_budget != 0 and (
                prefill_token_budget < prefill_chunk):
            raise ValueError(
                f"prefill_token_budget ({prefill_token_budget}) must be 0 "
                f"(pure-decode ticks) or >= prefill_chunk ({prefill_chunk})")
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.kv_mode = kv_mode
        self.attn_impl = attn_impl
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = gpt.init_params(cfg, gen, self.device)
        self.params = _paged.serving_params(cfg, params, self.device)
        self.prefill_width_bucketing = bool(prefill_width_bucketing)
        self.prefill_chunk = prefill_chunk
        self.prefill_budget = prefill_token_budget
        self._prompt_cap = max_len - 1
        self.page_size = page_size
        self.max_pages_per_slot = self._pages_for(max_len - 1)
        if n_pages is None:
            n_pages = max(self.max_pages_per_slot + 1,
                          (n_slots * self.max_pages_per_slot) // 2)
        self.n_pages = n_pages
        self.cache = _paged.init_paged_kv(cfg, n_pages, page_size,
                                          device=self.device)
        self.page_table = np.zeros((n_slots, self.max_pages_per_slot),
                                   np.int32)
        self.slot_n_pages = np.zeros(n_slots, np.int64)
        # pop() hands out ascending ids; 0 stays reserved (null page).
        self.free_pages = list(range(n_pages, 0, -1))
        self.page_refs = np.zeros(n_pages + 1, np.int32)
        self._min_free_pages = n_pages
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
        # Decode windows sample on the device from this generator; host
        # graduation samples (temperature > 0) from the CPU one.
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._host_gen = torch.Generator().manual_seed(seed)
        self._step_ms: "collections.deque[float]" = collections.deque(
            maxlen=4096)
        self._ttft_ms: "collections.deque[float]" = collections.deque(
            maxlen=4096)
        self._burst_step_ms: "collections.deque[float]" = collections.deque(
            maxlen=4096)
        self._last_window_end: float | None = None
        self._shutdown = threading.Event()
        self._fatal: str | None = None
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
                      "preemptions": 0}

    # ------------------------------------------------------------- API

    def submit(self, prompt_ids: list[int], *, max_tokens: int = 64,
               temperature: float = 0.0, eos_id: int | None = None,
               stream: bool = False,
               request_id: str | None = None) -> GenRequest:
        """Queue one generation request."""
        if not prompt_ids:
            raise ValueError("prompt_ids must be non-empty")
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        context = [int(t) for t in prompt_ids]
        if len(context) > self._prompt_cap:
            raise ValueError(
                f"prompt too long: {len(context)} (cap {self._prompt_cap}: "
                "cache bound, chunked prefill)")
        if self._pages_for(len(context)) > self.n_pages:
            raise ValueError(
                f"prompt needs {self._pages_for(len(context))} KV pages "
                f"but the pool only has {self.n_pages}")
        req = GenRequest(
            request_id=request_id or uuid.uuid4().hex[:12],
            prompt_ids=context, n_prompt=len(context),
            max_tokens=max_tokens, temperature=temperature, eos_id=eos_id,
            submitted_at=time.perf_counter(),
            stream=queue.Queue() if stream else None)
        with self._lock:
            if self._fatal is not None:
                raise RuntimeError(self._fatal)
            self.stats["requests"] += 1
            self.pending.put(req)
        return req

    def generate(self, prompt_ids: list[int], **kw) -> list[int]:
        """Blocking convenience wrapper."""
        req = self.submit(prompt_ids, **kw)
        req.done.wait()
        if req.error:
            raise RuntimeError(req.error)
        return req.out_ids

    def start(self) -> None:
        with self._lifecycle_lock:
            if self._thread is None:
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

    def reset_stats(self) -> None:
        """Zero the counters (benchmarks call this after warmup)."""
        with self._lock:
            for k, v in self.stats.items():
                self.stats[k] = 0 if isinstance(v, int) else 0.0
            self._step_ms.clear()
            self._dispatch_width_ring.clear()
            self._dispatch_width_counts.clear()
            self._ttft_ms.clear()
            self._burst_step_ms.clear()
            self._last_window_end = None
            self._min_free_pages = len(self.free_pages)

    def _observe_window(self, t0: float, end: float, k: int,
                        n_active: int, tick_prefill: bool) -> None:
        """Per-decode-window accounting: every slot advances k tokens."""
        dt = end - t0
        with self._lock:
            self.stats["decode_time_s"] += dt
            self.stats["decode_windows"] += 1
            self.stats["decode_steps"] += k
            self.stats["slot_step_sum"] += k * n_active
            self.stats["slot_cap_sum"] += k * self.n_slots
            self._step_ms.append(dt / k * 1000.0)
            if tick_prefill and self._last_window_end is not None:
                self._burst_step_ms.append(
                    (end - self._last_window_end) / k * 1000.0)
            self._last_window_end = end

    def metrics(self) -> dict:
        with self._lock:
            active = sum(r is not None for r in self.slot_req)
            m = dict(self.stats, active_slots=active,
                     queued=self.pending.qsize() + len(self._deferred),
                     n_slots=self.n_slots,
                     kv_pages_total=self.n_pages,
                     kv_pages_free=len(self.free_pages),
                     kv_pages_free_min=self._min_free_pages,
                     kv_page_size=self.page_size,
                     llm_attn_impl=self.attn_impl,
                     device=str(self.device),
                     kv_pool_bytes=sum(
                         a.numel() * a.element_size()
                         for a in self.cache.values()),
                     prefill_chunk=self.prefill_chunk,
                     prefill_token_budget=self.prefill_budget,
                     prefilling_slots=len(self._prefilling),
                     prefill_width_bucketing=self.prefill_width_bucketing)
            if self._dispatch_width_ring:
                widths = sorted(self._dispatch_width_ring)
                m["prefill_dispatch_width_p50"] = widths[len(widths) // 2]
                m["prefill_dispatch_width_max"] = widths[-1]
            if self._dispatch_width_counts:
                m["prefill_dispatch_widths"] = {
                    str(w): c for w, c in
                    sorted(self._dispatch_width_counts.items())}
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

    # --------------------------------------------------- page accounting

    def _pages_for(self, last_pos: int) -> int:
        """Pages needed to cover writes up to position `last_pos`."""
        return last_pos // self.page_size + 1

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

    def _grow_slot(self, slot: int, last_pos: int) -> bool:
        """Allocate pages so `slot` covers `last_pos`. All-or-nothing."""
        need = self._pages_for(last_pos) - int(self.slot_n_pages[slot])
        if need <= 0:
            return True
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

    def page_accounting(self) -> dict:
        """Closure check: every pool page is exactly one of free / owned
        by a slot table, and each owned page's refcount matches its
        owners. Valid when the engine is stopped or driven synchronously."""
        live: dict[int, int] = {}
        for slot in range(self.n_slots):
            for i in range(int(self.slot_n_pages[slot])):
                pg = int(self.page_table[slot, i])
                live[pg] = live.get(pg, 0) + 1
        allocated = set(live)
        refs_ok = all(int(self.page_refs[pg]) == live[pg]
                      for pg in allocated)
        free = len(self.free_pages)
        return {
            "total": self.n_pages,
            "free": free,
            "live": len(live),
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
                self._ttft_ms.append((now - req.submitted_at) * 1000.0)
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

    # Admission lookahead bound and the aging limit past which a
    # repeatedly-bypassed head goes strict-FIFO (as in the JAX engine).
    _ADMIT_LOOKAHEAD = 8
    _ADMIT_BYPASS_LIMIT = 16

    def _admit(self) -> None:
        """Move queued requests into free slots. A request is admitted
        once ONE CHUNK of pool headroom exists; its prompt then enters
        chunk-by-chunk under step()'s token budget. Up to
        _ADMIT_LOOKAHEAD page-blocked requests are set aside (returning
        to the deferred head in order) while requests behind them that
        fit admit now; a bypassed head ages and past
        _ADMIT_BYPASS_LIMIT blocks all lookahead until it admits."""
        free = [s for s in range(self.n_slots) if self.slot_req[s] is None]
        reqs: list[GenRequest] = []
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
            end = min(self.prefill_chunk, len(req.prompt_ids))
            need = self._pages_for(end - 1)
            if planned_pages + need > len(self.free_pages):
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
            reqs.append(req)
        for req in reversed(blocked):
            self._deferred.appendleft(req)   # original order, at the head
        if blocked and len(reqs) > head_mark:
            blocked[0].admit_bypasses += 1
        for req, slot in zip(reqs, free):
            with self._lock:
                self.slot_req[slot] = req
            self.tokens[slot] = 0
            self.positions[slot] = 0
            self.temps[slot] = req.temperature
            self._chunk_pos[slot] = 0
            self._prefilling.append(slot)

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
        try:
            last, self.cache = _paged.prefill_chunk_paged(
                self.cfg, self.params, self._to_dev(toks), self.cache,
                self._to_dev(tables), self._to_dev(offsets),
                self._to_dev(valid), return_logits=any_final,
                attn_impl=self.attn_impl)
            if any_final:
                last = last.cpu().numpy()
            elif self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
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
        for i, (slot, req, done, n) in enumerate(batch):
            self._chunk_pos[slot] = done + n
            if done + n < len(req.prompt_ids):
                continue
            self._prefilling.remove(slot)
            self._chunk_pos.pop(slot, None)
            tok = self._sample(last[i], req.temperature)
            self.tokens[slot] = tok
            self.positions[slot] = len(req.prompt_ids)
            self.temps[slot] = req.temperature
            if self._emit(req, tok):
                self._release(slot)
        return set()

    def _release(self, slot: int) -> None:
        """Free a slot and its pages. Positions reset so multi-step
        windows never walk an idle slot's write cursor toward the cache
        boundary."""
        with self._lock:
            self.slot_req[slot] = None
        self.tokens[slot] = 0
        self.positions[slot] = 0
        self.temps[slot] = 0.0
        if slot in self._chunk_pos:      # mid-prefill slot going away
            self._chunk_pos.pop(slot, None)
            self._prefilling.remove(slot)
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

    def step(self) -> int:
        """One engine tick: admit queued requests, spend the chunked-
        prefill token budget, then one fused decode window for every
        decode-ready slot. → slots that did work."""
        return self._step()

    def _step(self) -> int:
        pt0 = self.stats["prefill_tokens"]
        self._admit()
        decode_ready = any(
            self.slot_req[i] is not None and i not in self._chunk_pos
            for i in range(self.n_slots))
        self._run_prefill_chunks(decode_ready)
        active = [i for i in range(self.n_slots)
                  if self.slot_req[i] is not None
                  and i not in self._chunk_pos]
        n_prefilling = len(self._prefilling)
        if not active:
            self._last_window_end = None
            return n_prefilling
        tick_prefill = self.stats["prefill_tokens"] > pt0
        k = self._pick_window(active)
        active, k = self._fit_window_pages(active, k)
        if not active:
            self._last_window_end = None
            return n_prefilling
        table_view = self._decode_table_view(active)
        t0 = time.perf_counter()
        if k > 1:
            toks_out, self.cache = _paged.decode_multi_paged(
                self.cfg, self.params, self._to_dev(self.tokens),
                self.cache, self._to_dev(self.positions),
                self._to_dev(table_view), k, self._to_dev(self.temps),
                self._gen, attn_impl=self.attn_impl)
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
        logits, self.cache = _paged.decode_step_paged(
            self.cfg, self.params, self._to_dev(self.tokens), self.cache,
            self._to_dev(self.positions), self._to_dev(table_view),
            attn_impl=self.attn_impl)
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
