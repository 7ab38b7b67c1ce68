"""Paged-KV prefix cache: refcounted copy-on-write page sharing.

The port's own copy of ``ray_tpu/serve/prefix_cache.py`` (numpy and
hashlib only, like the original). The digests are the JAX package's
byte for byte (blake2b over int64 token bytes, parent-chained per
chunk), so keys made by either package name the same prefixes.

Structure
---------
Entries are chunk-aligned prefixes of completed token sequences, keyed
by a rolling hash over ``prefill_chunk``-sized chunks:

    h_0 = H(chunk_0)            h_i = H(h_{i-1} || chunk_i)

so one sequence of ``d`` full chunks donates ``d`` chain entries and a
lookup's longest hit is the deepest chain node present. Each entry is
self-contained: it records the page ids covering ALL of its tokens and
holds one refcount on each, so evicting a chain's middle (pure LRU)
never strands a deeper survivor.

Sharing contract
----------------
Distinct live slots never share a *writable* page:

- Full pages of a cached prefix are bound read-only: a binder's writes
  all land at positions >= its cached token count, which map to pages
  past the shared run.
- The tail page of a prefix that does not end on a page boundary WOULD
  be written (the cold suffix lands mid-page), so it is copied on write
  at bind time (``models/paged_kv.copy_pages``, every plane of the
  pool, the int8 pool's scale planes included), batched per engine
  tick. Stale donor tokens past the cached length in the copy are
  position-masked until the binder's own prefill overwrites them, the
  argument that makes the null page harmless.
- Pages return to the engine's free list only when the LAST reference
  (slots' tables + cache entries) drops.

The cache is host-side bookkeeping owned by the engine thread: it never
touches device memory and delegates page refcounts to the engine through
the ``ref_page``/``unref_page`` callbacks, so the page-accounting closure
(free + live + cached == total) stays checkable in one place
(``LLMEngine.page_accounting``).

Eviction is LRU over zero-active entries (entries some live slot is
bound to are pinned): the engine evicts cached pages BEFORE it preempts
a live decode or shrinks a window, and a ``max_pages`` budget bounds how
much of the pool donations may pin.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Callable

import numpy as np


def extend_chunk_chain(tokens, chunk: int, chain: list) -> list:
    """The parent-chained digest loop (every key of the cache comes from
    here). Extends ``chain`` IN PLACE to cover every full ``chunk``-sized
    prefix of ``tokens``: ``chain[d-1]`` keys the prefix of ``d`` chunks
    and commits to every token before it. Existing digests are prefix-
    stable (growing the token list only appends), which makes per-request
    memoization sound: an engine's contexts only grow (preempt-by-
    recompute appends generated tokens)."""
    n_full = len(tokens) // chunk
    if len(chain) > n_full:
        # A shrunk context invalidates the whole memo.
        del chain[:]
    parent = chain[-1] if chain else b""
    for d in range(len(chain), n_full):
        h = hashlib.blake2b(parent, digest_size=16)
        h.update(np.asarray(
            tokens[d * chunk:(d + 1) * chunk], np.int64).tobytes())
        parent = h.digest()
        chain.append(parent)
    return chain


def chunk_hashes(tokens, chunk: int) -> list[bytes]:
    """Fresh (un-memoized) digest chain over ``tokens``."""
    return extend_chunk_chain(tokens, chunk, [])


def affinity_key(tokens, chunk: int) -> bytes:
    """Routing affinity key: the chain's HEAD digest over the first
    ``chunk`` tokens, byte-identical to the depth-1 key of donations and
    lookups. Prompts shorter than one chunk hash whatever they have: such
    keys never match a cache entry (entries are chunk-aligned), but equal
    short prompts still co-locate."""
    if chunk > 0 and len(tokens) >= chunk:
        return chunk_hashes(tokens[:chunk], chunk)[0]
    h = hashlib.blake2b(b"", digest_size=16)
    h.update(np.asarray(tokens, np.int64).tobytes())
    return h.digest()


@dataclasses.dataclass
class CacheEntry:
    key: bytes
    n_tokens: int           # chunk-aligned prefix length this entry covers
    pages: tuple[int, ...]  # page ids covering tokens [0, n_tokens)
    active: int = 0         # live slots currently bound to this entry
    last_used: int = 0      # LRU clock tick


class PrefixCache:
    """Host-side map: chunk-aligned prefix hash -> refcounted page run.

    Single-threaded by contract (the engine thread owns it, like the page
    tables). All page refcounting goes through the engine's callbacks;
    the cache only decides WHICH pages are worth pinning.
    """

    def __init__(self, *, chunk: int, page_size: int, max_pages: int,
                 ref_page: Callable[[int], None],
                 unref_page: Callable[[int], None]):
        if chunk <= 0:
            raise ValueError("prefix cache requires chunked prefill "
                             f"(chunk > 0), got {chunk}")
        if max_pages <= 0:
            raise ValueError(f"max_pages must be > 0, got {max_pages}")
        self.chunk = chunk
        self.page_size = page_size
        self.max_pages = max_pages
        self._ref_page = ref_page
        self._unref_page = unref_page
        # Touch-ordered: acquire and donate-touch move an entry to the
        # end, so the front is the LRU and evict_one pops from there.
        self.entries: "collections.OrderedDict[bytes, CacheEntry]" = (
            collections.OrderedDict())
        # page id -> number of entries referencing it (distinct cached
        # pages = len of this map; the budget bounds it).
        self._page_owners: dict[int, int] = {}
        self._clock = 0
        # Cumulative evictions (LRU, pressure and donation budget): the
        # engine diffs this into its stats.
        self.evictions = 0

    # ------------------------------------------------------------ lookup

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def extend_chain(self, tokens, chain: list) -> list:
        """``extend_chunk_chain`` at this cache's granularity (the engine
        memoizes each request's chain on the request)."""
        return extend_chunk_chain(tokens, self.chunk, chain)

    def _lookup(self, tokens, memo: list | None = None) -> CacheEntry | None:
        """Deepest cached chain node covering at most ``len(tokens)-1``
        tokens: at least one cold token must remain, whose prefill gives
        the logits the first sampled token comes from."""
        max_d = (len(tokens) - 1) // self.chunk
        if max_d <= 0:
            return None
        hs = self.extend_chain(tokens, [] if memo is None else memo)
        for d in range(max_d, 0, -1):
            entry = self.entries.get(hs[d - 1])
            if entry is not None:
                return entry
        return None

    def match_len(self, tokens, memo: list | None = None) -> int:
        """Peek: cached tokens a lookup would serve (no pin, no touch)."""
        entry = self._lookup(tokens, memo)
        return entry.n_tokens if entry is not None else 0

    def acquire(self, tokens, memo: list | None = None) -> CacheEntry | None:
        """Longest cached prefix for ``tokens``, pinned (active+1, LRU
        touched) until the holder calls release(). The engine acquires at
        RESERVATION time, so a pressure reclaim between sizing an
        admission's page reservation and binding cannot evict the entry
        the reservation was sized for. The caller refs the shared pages
        it binds; the pin keeps the ENTRY (and through it the tail page a
        COW copy reads from) out of eviction's reach."""
        entry = self._lookup(tokens, memo)
        if entry is None:
            return None
        entry.active += 1
        entry.last_used = self._tick()
        self.entries.move_to_end(entry.key)
        return entry

    def release(self, entry: CacheEntry) -> None:
        entry.active = max(0, entry.active - 1)

    # ---------------------------------------------------------- donation

    def donate(self, tokens, table_row, memo: list | None = None) -> int:
        """Insert-on-free: index every chunk-aligned prefix of a completed
        request's written sequence, pages straight out of its (about to
        be freed) page table. Existing depths get an LRU touch; new depths
        ref their pages so the slot's own unref cannot free them.
        Donation never exceeds the page budget: zero-active LRU entries
        are evicted to make room, and when the budget still cannot fit a
        depth, deeper depths are skipped too. ``memo`` (the donor's chain
        over its prompt) is a prefix of the written sequence's chain, so
        only the generated tail's chunks are hashed. → entries created."""
        n_full = (len(tokens) // self.chunk) * self.chunk
        if n_full <= 0:
            return 0
        hs = self.extend_chain(tokens[:n_full],
                               [] if memo is None else memo)
        created = 0
        for d in range(1, len(hs) + 1):
            key = hs[d - 1]
            existing = self.entries.get(key)
            if existing is not None:
                existing.last_used = self._tick()
                self.entries.move_to_end(key)
                continue
            n_tokens = d * self.chunk
            n_pages = (n_tokens - 1) // self.page_size + 1
            if n_pages > self.max_pages:
                # This depth cannot fit even an empty cache; evicting
                # would only thrash the shallower entries just donated.
                break
            pages = tuple(int(p) for p in table_row[:n_pages])
            if any(p <= 0 for p in pages):
                # A donor must own real pages for every token it claims.
                break
            new_pages = [p for p in pages if p not in self._page_owners]
            while (len(self._page_owners) + len(new_pages) > self.max_pages
                   and self.evict_one() is not None):
                new_pages = [p for p in pages
                             if p not in self._page_owners]
            if len(self._page_owners) + len(new_pages) > self.max_pages:
                break       # budget full: deeper prefixes only cost more
            entry = CacheEntry(key=key, n_tokens=n_tokens, pages=pages,
                               last_used=self._tick())
            for p in pages:
                self._page_owners[p] = self._page_owners.get(p, 0) + 1
                self._ref_page(p)
            self.entries[key] = entry
            created += 1
        return created

    # ---------------------------------------------------------- eviction

    def evict_one(self) -> CacheEntry | None:
        """Drop the least-recently-used ZERO-ACTIVE entry, unreffing its
        pages (they return to the free list once no slot shares them).
        Pinned entries are never evicted. → the evicted entry, or None if
        nothing is evictable."""
        victim: CacheEntry | None = None
        for entry in self.entries.values():
            if entry.active == 0:
                victim = entry
                break
        if victim is None:
            return None
        self.evictions += 1
        del self.entries[victim.key]
        for p in victim.pages:
            owners = self._page_owners.get(p, 0) - 1
            if owners <= 0:
                self._page_owners.pop(p, None)
            else:
                self._page_owners[p] = owners
            self._unref_page(p)
        return victim

    # ------------------------------------------------------------- stats

    def n_pages_cached(self) -> int:
        """Distinct pages currently pinned by cache entries."""
        return len(self._page_owners)

    def cached_pages(self) -> set[int]:
        return set(self._page_owners)

    def page_refs_held(self, page: int) -> int:
        """Refcounts the cache holds on ``page`` (one per entry whose run
        contains it), which the accounting closure reconciles against the
        engine's page_refs."""
        return self._page_owners.get(int(page), 0)


__all__ = ["PrefixCache", "CacheEntry", "extend_chunk_chain", "chunk_hashes",
           "affinity_key"]
