"""KV page-set objects: finished KV pages as store citizens (PyTorch).

Counterpart of ``ray_tpu/serve/kv_objects.py``. A
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
- ``ObjectKVStore``: the cluster path, on the port's runtime
  (`ray_tpu_torch.api`). Payloads travel through the client's
  ``put(..., cache_local=False)``: the node's shared-memory arena holds
  the only copy (each CPU tensor one out-of-band buffer of its raw
  bytes, `core/serialization.py`), and a GCS-KV index (namespace
  ``serve_kv_pages``) maps digest → object id + meta, so any replica
  finds a donation by key alone. The donor process owns the ObjectRefs
  (at most ``serve_kv_object_budget``; the oldest withdrawn first), so
  a donor that exits cleanly releases its objects, and `sweep_cluster`,
  run by the serve controller every ``serve_kv_sweep_interval_s``,
  frees entries whose donor is dead or whose TTL expired, so a
  SIGKILLed donor's pages cannot leak the store. Payload planes must be
  CPU tensors before the put: a CUDA tensor nested in the payload dict
  would keep torch's own pickling and come back on its device, in
  another process (the engine's `_kv_payload` moves them).
- ``LocalKVStore``: the in-process dict with the same surface, shared
  as a process-global singleton by every engine built off a cluster, so
  the donate/adopt ladder runs without booting one (selecting the
  backend gates on an attached client, ``api._client``, and never calls
  ``_ensure_client``).

Chaos sites: ``serve.kv.donate`` at the engine's donation entry (raise:
that donation is skipped and the engine keeps serving),
``serve.kv.adopt`` at every store fetch (drop: the ladder falls a rung).
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import OrderedDict
from typing import Any

from ray_tpu_torch import chaos as _chaos

logger = logging.getLogger(__name__)

INDEX_NS = "serve_kv_pages"
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

    def __init__(self, budget: int = 64):
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


class ObjectKVStore:
    """Cluster page-set store: payloads in the per-node object store
    (plasma equivalent), discovery via a GCS-KV digest index. The donor
    instance OWNS its donations' ObjectRefs — dropping one (budget
    withdrawal, process exit) releases the object through the ordinary
    distributed refcount; `sweep_cluster` force-frees what a SIGKILLed
    donor could never release."""

    def __init__(self, client, budget: int = 64, donor: str = ""):
        self._client = client
        self.budget = max(1, int(budget))
        self.donor = donor
        self._lock = threading.Lock()
        self._owned: "OrderedDict[str, Any]" = OrderedDict()  # key -> ref
        self.donations = 0
        self.withdrawals = 0

    def donate(self, meta: dict, payload: dict) -> dict:
        key = meta["key"]
        raw = self._client.kv_get(INDEX_NS, key.encode())
        if raw:
            # Another donor already published this digest — byte-identical
            # content by construction, so reuse its entry (no second copy).
            try:
                return json.loads(raw)
            except Exception:  # graftlint: disable=EXC-SWALLOW (corrupt index row: fall through and overwrite it with a fresh donation)
                pass
        # The shm extent is the only copy (cache_local=False): donated KV
        # must not also pin a pickled twin in the donor's process RAM.
        ref = self._client.put(payload, cache_local=False)
        meta = dict(meta, ref=ref.hex())
        self._client.kv_put(INDEX_NS, key.encode(),
                            json.dumps(meta).encode())
        with self._lock:
            self._owned[key] = ref
            self.donations += 1
            drop = []
            while len(self._owned) > self.budget:
                drop.append(self._owned.popitem(last=False))
        for old_key, old_ref in drop:
            self._withdraw_entry(old_key, old_ref)
        return meta

    def _withdraw_entry(self, key: str, ref) -> None:
        # Callers (donate's budget eviction, withdraw) invoke this AFTER
        # releasing _lock — the kv_get/kv_del below are RPCs that must not
        # run under it. The counter bump still needs the lock: += races a
        # concurrent donate's bump otherwise.
        with self._lock:
            self.withdrawals += 1
        try:
            # Compare-and-delete: only remove the index row if it still
            # points at OUR object. After a TTL sweep reaped this
            # donor's stale row, another donor may have re-published
            # the same digest — an unconditional kv_del here would
            # delete that donor's LIVE row and strand its object
            # undiscoverable for its whole lifetime.
            raw = self._client.kv_get(INDEX_NS, key.encode())
            row = json.loads(raw) if raw else None
            if row is not None and row.get("ref") == ref.hex():
                self._client.kv_del(INDEX_NS, key.encode())
        except Exception as e:  # noqa: BLE001 — sweep is the backstop
            logger.debug("kv index del %s failed (sweep will reap): %s",
                         key[:12], e)
        try:
            self._client.free([ref])
        except Exception as e:  # noqa: BLE001 — sweep is the backstop
            logger.debug("kv object free %s failed (sweep will reap): %s",
                         key[:12], e)

    def resolve(self, keys: list[str]) -> dict[str, dict]:
        out: dict[str, dict] = {}
        for k in keys:
            try:
                raw = self._client.kv_get(INDEX_NS, k.encode())
            except Exception as e:  # noqa: BLE001 — GCS blip = no hit
                logger.debug("kv index read %s failed: %s", k[:12], e)
                continue
            if not raw:
                continue
            try:
                out[k] = json.loads(raw)
            except Exception:  # graftlint: disable=EXC-SWALLOW (corrupt index row reads as a miss; the adoption ladder has a fallback rung)
                continue
        return out

    def fetch(self, meta: dict, timeout: float = 30.0) -> dict:
        _chaos.hit("serve.kv.adopt")
        from ray_tpu_torch import api as _api

        ref = _api.ObjectRef.from_hex(meta["ref"])
        return _api.get(ref, timeout=timeout)

    def withdraw(self, key: str) -> bool:
        with self._lock:
            ref = self._owned.pop(key, None)
        if ref is None:
            return False
        self._withdraw_entry(key, ref)
        return True

    def sweep(self, live_donors: set[str] | None = None,
              ttl_s: float | None = None, now: float | None = None) -> int:
        return sweep_cluster(self._client, live_donors, ttl_s, now=now)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._owned),
                    "donations": self.donations,
                    "withdrawals": self.withdrawals,
                    "budget": self.budget}


def sweep_cluster(client, live_donors: set[str] | None = None,
                  ttl_s: float | None = None,
                  now: float | None = None) -> int:
    """Orphan-page sweep over the cluster index: free every donated
    page-set whose donor is no longer live (a SIGKILLed replica never
    releases its owned refs — without this its pages leak the node
    store) and every entry past its TTL. The serve controller runs this
    on full reconcile passes (`serve_kv_sweep_interval_s`); it is
    idempotent and safe against concurrent adopters — an adopter whose
    fetch loses the race falls down the adoption ladder. → freed."""
    from ray_tpu_torch import api as _api

    now = time.time() if now is None else now
    freed = 0
    try:
        keys = client.kv_keys(INDEX_NS)
    except Exception as e:  # noqa: BLE001 — next pass retries
        logger.debug("kv sweep index listing failed: %s", e)
        return 0
    for key in keys:
        kb = key if isinstance(key, bytes) else key.encode()
        try:
            raw = client.kv_get(INDEX_NS, kb)
            meta = json.loads(raw) if raw else None
        except Exception:  # graftlint: disable=EXC-SWALLOW (unreadable row: skipped this pass, the TTL sweep reaps it eventually)
            continue
        if meta is None:
            continue
        dead = (live_donors is not None
                and meta.get("donor") not in live_donors)
        expired = ttl_s is not None and now - meta.get("ts", 0.0) > ttl_s
        if not (dead or expired):
            continue
        try:
            client.kv_del(INDEX_NS, kb)
            if meta.get("ref"):
                client.free([_api.ObjectRef.from_hex(meta["ref"])])
            freed += 1
        except Exception as e:  # noqa: BLE001 — next pass retries
            logger.debug("kv sweep of %s failed: %s",
                         str(meta.get("key", ""))[:12], e)
    if freed:
        logger.info("kv orphan sweep freed %d page-set entries", freed)
    return freed


_local_store: LocalKVStore | None = None
_local_lock = threading.Lock()


def get_store(budget: int | None = None, donor: str = ""):
    """The store an engine that turns on KV transfer uses: the cluster
    store when a client is already attached, else the process-global
    LocalKVStore (built at the first call), shared by every engine of
    the process, so two engines donate and adopt through it. The budget
    defaults to ``runtime_config().serve_kv_object_budget``. Never calls
    `_ensure_client`: building an engine off a cluster must not boot
    one."""
    from ray_tpu_torch import api as _api
    from ray_tpu_torch.core.config import runtime_config

    if budget is None:
        budget = runtime_config().serve_kv_object_budget
    if _api._client is not None:
        return ObjectKVStore(_api._client, budget=budget, donor=donor)
    global _local_store
    with _local_lock:
        if _local_store is None:
            _local_store = LocalKVStore(budget=budget)
        return _local_store


def reset_local_store() -> None:
    """Drop the process-global local store (tests, and between runs that
    must not share entries)."""
    global _local_store
    with _local_lock:
        _local_store = None


__all__ = [
    "BACKEND", "INDEX_NS", "LocalKVStore", "ObjectKVStore",
    "engine_fingerprint", "get_store", "make_meta", "page_span",
    "pages_for_tokens", "reset_local_store", "sweep_cluster",
]
