"""KV page-set objects: finished KV pages as store citizens (PyTorch).

Counterpart of ``ray_tpu/serve/kv_objects.py``, its in-process half. A
finishing prefill (or a draining engine's export) DONATES its written
pages as page-set objects, and an admitting engine ADOPTS them, binding
fresh pages filled with the donor's bytes into its table like a local
prefix-cache warm hit, instead of re-prefilling from token ids.

Keying
------
Donations are keyed by the parent-chained chunk digests of the prefix
cache (`prefix_cache.extend_chunk_chain`): one donated sequence of ``d``
full chunks gives ``d`` entries, and entry ``d`` holds only the pages
NEW to depth ``d`` (`page_span`), so adopting depths ``1..j`` fills
exactly the pages covering ``j·chunk`` tokens and a missing deeper
entry degrades to a PARTIAL adoption, never a failed one. The engine
requires ``chunk % page_size == 0`` for transfer: entries are deduped
per depth across donations, and only page-aligned spans make a chain
composed of depths from different donations self-contained.

Adoption ladder
---------------
adopt (every depth resolves and fetches) → partial adopt + cold-suffix
prefill (a prefix of the depths does) → teacher-forced re-prefill
(nothing does). Every rung gives the uninterrupted greedy stream: the
adopted pages hold the K/V the donor computed for those tokens.

Payloads
--------
One entry's payload is ``{plane: tensor}``: the pool's planes of the
entry's pages, ``[L, n_pages, page_size, H, K]`` for ``k``/``v`` and
``[L, n_pages]`` for an int8 pool's ``k_scale``/``v_scale``, plus the
draft pool's mirror planes (``"d" + plane``) with speculative decoding.
They are contiguous torch CPU tensors (or slices of one) in the pool's
own dtype: bf16 or fp32 planes, int8 planes and their bf16 scale planes.
The JAX engine's payloads are numpy arrays; numpy has no bf16, so the
port keeps torch's. The payload lies on the host because the store is
the wire between engines; the pools, the gather and the scatter stay on
each engine's device. A tp > 1 donor's planes ride per shard
(``k@0`` .. ``k@{tp-1}``, `partition.split_head_planes`) and an adopter
at any degree joins them (`partition.concat_head_planes`).

Fingerprint
-----------
`engine_fingerprint` is the reference's string with the dtype's plain
name and a backend tag at the end (``...:float32:ps16:c16:torch``), so
a JAX engine's page set (whose fingerprint has no tag) is never adopted
by a port engine, nor the reverse.

Backends
--------
`LocalKVStore`, the in-process dict the reference's off-cluster engines
share as a process-global singleton (`get_store`). The reference's
cluster store (``ObjectKVStore`` over its object store and GCS index,
and ``sweep_cluster``) is not ported: the port has no runtime.

Chaos sites: ``serve.kv.donate`` at the engine's donation entry (raise:
that donation is skipped and the engine keeps serving),
``serve.kv.adopt`` at every store fetch (drop: the ladder falls a rung).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

from ray_tpu_torch import chaos as _chaos

INDEX_NS = "serve_kv_pages"
# The reference's runtime-config defaults (``serve_kv_object_budget``,
# ``serve_kv_summary_max``): entries a store keeps before withdrawing the
# oldest, and chain heads an engine's donation summary keeps.
SERVE_KV_OBJECT_BUDGET = 64
SERVE_KV_SUMMARY_MAX = 128
# Appended to every fingerprint: page sets of the JAX package never match.
BACKEND = "torch"


def pages_for_tokens(n_tokens: int, page_size: int) -> int:
    """Pages covering tokens [0, n_tokens)."""
    return 0 if n_tokens <= 0 else (n_tokens - 1) // page_size + 1


def page_span(depth: int, chunk: int, page_size: int) -> tuple[int, int]:
    """Page indices NEW to chain depth ``depth`` (1-based): the half-open
    span [P((d-1)·c), P(d·c)) over the slot's page table. When a chunk
    boundary lands mid-page, the boundary page belongs to the shallower
    depth, so spans never overlap and their union over depths 1..j is
    exactly [0, P(j·c))."""
    return (pages_for_tokens((depth - 1) * chunk, page_size),
            pages_for_tokens(depth * chunk, page_size))


def _dtype_name(dtype) -> str:
    """``torch.bfloat16`` → "bfloat16" (the spelling of JAX's
    ``jnp.bfloat16.__name__``)."""
    name = getattr(dtype, "__name__", None)
    if name:
        return name
    return str(dtype).rpartition(".")[2]


def engine_fingerprint(cfg, page_size: int, chunk: int,
                       draft_cfg=None, kv_dtype: str = "bf16") -> str:
    """Compatibility fingerprint: payloads are raw K/V planes, so donor
    and adopter must agree on model geometry, dtype, page size and chunk
    (the key schedule); the draft's geometry with speculative decoding
    (the draft pool mirrors the target's pages); an int8 pool's
    ``kv_dtype`` (its payloads carry scale planes); and the backend."""
    fp = (f"{cfg.n_layers}x{cfg.n_heads}x{cfg.head_dim}"
          f":{_dtype_name(cfg.dtype)}:ps{page_size}:c{chunk}")
    if draft_cfg is not None:
        fp += (f":d{draft_cfg.n_layers}x{draft_cfg.n_heads}"
               f"x{draft_cfg.head_dim}")
    if kv_dtype and kv_dtype != "bf16":
        fp += f":q{kv_dtype}"
    return f"{fp}:{BACKEND}"


def make_meta(key_hex: str, depth: int, chunk: int, page_size: int,
              fingerprint: str, donor: str, n_pages: int,
              draft: bool, tp: int = 1) -> dict:
    """One entry's index row. ``tp`` is the DONOR's degree: tp=1 payloads
    are unsharded planes, tp > 1 payloads one plane per head shard with
    the replicated ``_scale`` planes unsuffixed; the fingerprint stays
    tp-invariant (full-head geometry)."""
    return {
        "key": key_hex,
        "depth": depth,
        "n_tokens": depth * chunk,
        "chunk": chunk,
        "page_size": page_size,
        "n_pages": n_pages,
        "fingerprint": fingerprint,
        "donor": donor,
        "draft": draft,
        "tp": int(tp),
        "ts": time.time(),
    }


class LocalKVStore:
    """In-process page-set store: donate / resolve / fetch / withdraw /
    sweep / stats, as the reference's. Holds each payload as given."""

    def __init__(self, budget: int = SERVE_KV_OBJECT_BUDGET):
        self.budget = max(1, int(budget))
        self._lock = threading.Lock()
        # key_hex -> {"meta": dict, "payload": {"k": tensor, ...}}
        self._entries: "OrderedDict[str, dict]" = OrderedDict()
        self.donations = 0
        self.withdrawals = 0

    def donate(self, meta: dict, payload: dict) -> dict:
        """Store ``payload`` under ``meta["key"]`` unless the key is held
        (a deduped donation keeps the first); past the budget the oldest
        entries are withdrawn. → the stored meta."""
        with self._lock:
            if meta["key"] not in self._entries:
                self._entries[meta["key"]] = {
                    "meta": dict(meta), "payload": payload}
                self.donations += 1
                while len(self._entries) > self.budget:
                    self._entries.popitem(last=False)
                    self.withdrawals += 1
            return dict(self._entries[meta["key"]]["meta"])

    def resolve(self, keys: list[str]) -> dict[str, dict]:
        with self._lock:
            return {k: dict(self._entries[k]["meta"])
                    for k in keys if k in self._entries}

    def fetch(self, meta: dict, timeout: float = 30.0) -> dict:
        _chaos.hit("serve.kv.adopt")
        with self._lock:
            ent = self._entries.get(meta["key"])
            if ent is None:
                raise KeyError(f"kv page-set {meta['key']} is gone")
            return ent["payload"]

    def withdraw(self, key: str) -> bool:
        with self._lock:
            if self._entries.pop(key, None) is not None:
                self.withdrawals += 1
                return True
            return False

    def sweep(self, live_donors: set[str] | None = None,
              ttl_s: float | None = None, now: float | None = None) -> int:
        """Drop entries whose donor is no longer live and/or whose TTL
        expired. → entries freed."""
        now = time.time() if now is None else now
        freed = 0
        with self._lock:
            for key in list(self._entries):
                meta = self._entries[key]["meta"]
                dead = (live_donors is not None
                        and meta.get("donor") not in live_donors)
                expired = (ttl_s is not None
                           and now - meta.get("ts", 0.0) > ttl_s)
                if dead or expired:
                    del self._entries[key]
                    freed += 1
            # Under the lock, as withdraw()/donate() bump it.
            self.withdrawals += freed
        return freed

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries),
                    "donations": self.donations,
                    "withdrawals": self.withdrawals,
                    "budget": self.budget}


_local_store: LocalKVStore | None = None
_local_lock = threading.Lock()


def get_store() -> LocalKVStore:
    """The process-global LocalKVStore (built at the first call), shared
    by every engine that enables transfer without its own store, so two
    engines of one process donate and adopt through it."""
    global _local_store
    with _local_lock:
        if _local_store is None:
            _local_store = LocalKVStore()
        return _local_store


def reset_local_store() -> None:
    """Drop the process-global local store (tests, and between runs that
    must not share entries)."""
    global _local_store
    with _local_lock:
        _local_store = None


__all__ = [
    "BACKEND", "INDEX_NS", "LocalKVStore", "SERVE_KV_OBJECT_BUDGET",
    "SERVE_KV_SUMMARY_MAX", "engine_fingerprint", "get_store", "make_meta",
    "page_span", "pages_for_tokens", "reset_local_store",
]
