"""Distributed reference counting — automatic object lifetime management.

Parity target: the reference's ownership model (`src/ray/
core_worker/reference_count.h:61,511-556`) — local ref counts, borrowed refs
registered when a ref escapes via serialization, refs-in-refs containment,
and release-on-zero driving object GC.

TPU-first re-design: rather than the reference's owner-resident counts with
per-worker WaitForRefRemoved long-polls, each *process* keeps exact local
counts and reports only process-level 0↔1 transitions to the GCS, batched.
The GCS (already the object directory in this architecture) frees an object
when its holder set empties, broadcasting `free_objects` to the nodes that
store it. In-flight handoffs are protected by sender-side escrow: the
submitting client holds a count on every ref that rides a task spec until the
task completes, and an executing worker flushes its acquires *before*
replying, so a release can never overtake the matching acquire.

Containment (refs nested inside a stored object's value) registers a
pseudo-holder ``b"obj:" + outer_id`` with the GCS; freeing the outer object
cascades to release the inner refs (reference: "refs-in-refs",
reference_count.h:534).
"""

from __future__ import annotations

import collections
import logging
import os
import threading
from typing import Callable, Iterable

logger = logging.getLogger(__name__)


class ReferenceCounter:
    """Per-process exact counts; batched process-level holds to the GCS.

    Thread-safe: incref/decref are called from arbitrary threads (including
    the GC via ObjectRef.__del__). The flush loop runs on the owning client's
    asyncio loop.
    """

    def __init__(self, client):
        self._client = client
        self.holder_id = b"h:" + os.urandom(8)
        self._lock = threading.Lock()
        self._counts: dict[bytes, int] = {}
        # Batch state: acquires the GCS hasn't been told about yet; releases
        # pending; containment edges pending. An acquire+release both landing
        # before a flush cancel out — but the object may already be stored, so
        # the release is still sent (GCS frees unknown/empty-holder objects).
        self._pending_acq: set[bytes] = set()
        self._pending_rel: set[bytes] = set()        # borrower releases
        self._pending_rel_owned: set[bytes] = set()  # creator releases
        self._pending_contains: list[tuple[bytes, list[bytes]]] = []
        # Acquires whose flush outcome is ambiguous (RPC failed after the
        # server may have applied it): a later decref must send a release
        # even though the acquire looks locally unflushed.
        self._uncertain: set[bytes] = set()
        # Ids this process *created* (put / task returns). Only an owner may
        # send a release for an acquire the GCS never saw: a borrower's
        # transient acquire+release before its first flush must emit nothing,
        # or its release could overtake the owner's initial acquire and free
        # a live object.
        self._owned: set[bytes] = set()
        # mmap views whose release hit BufferError (a live zero-copy value
        # still exports the buffer); retried each flush tick. Handoff is a
        # lock-free deque (same GC-safety contract as _del_queue below):
        # defer_local runs in GC context and must not take locks, and the
        # retry set itself is touched only on the flusher thread.
        self._deferred_local: set[bytes] = set()
        self._deferred_local_q: collections.deque[bytes] = collections.deque()
        # Decrefs queued from ObjectRef.__del__: finalizers can run inside
        # the cyclic GC on a thread that already holds _lock or the client's
        # lineage lock — taking a non-reentrant lock there can self-deadlock.
        # deque.append is lock-free (GIL-atomic); drained by the flusher and
        # by flush_now.
        self._del_queue: collections.deque[bytes] = collections.deque()
        # Containment edges acknowledged by the GCS; replayed on holder
        # re-registration after a GCS failover, pruned when the outer object
        # is freed (objects_freed notify).
        self._registered_contains: dict[bytes, list[bytes]] = {}
        self._closed = False
        self._flush_task = None
        # One ref_update in flight at a time (made on the loop, at first
        # use): `publish` returning means the GCS has seen every acquire
        # taken before it, including one that an earlier flush carries.
        self._flush_lock = None

    def mark_owned(self, oid: bytes) -> None:
        if not self._closed:
            with self._lock:
                self._owned.add(oid)

    def is_owned(self, oid: bytes) -> bool:
        """Created by this process (put / submitted task return)?"""
        with self._lock:
            return oid in self._owned

    def has_live_with_task_prefix(self, prefix: bytes) -> bool:
        """Any locally-held ref whose object id starts with `prefix` (the
        20-byte task id)? Used to keep a dynamic generator's lineage pinned
        while its ITEM refs are alive even after the outer list is freed."""
        with self._lock:
            return any(oid.startswith(prefix) for oid in self._counts)

    def pending_acquire_ids(self) -> list[bytes]:
        """Acquires the GCS has not (confirmably) seen yet — reported to task
        submitters when a pre-reply flush cannot land (GCS outage) so their
        escrow release can wait for this holder's registration."""
        with self._lock:
            return sorted(self._pending_acq | self._uncertain)

    # ------------------------------------------------------------ counting

    def incref(self, oid: bytes) -> None:
        if self._closed:
            return
        with self._lock:
            c = self._counts.get(oid, 0) + 1
            self._counts[oid] = c
            if c == 1:
                if oid in self._pending_rel or oid in self._pending_rel_owned:
                    # Re-acquired before the release flushed: still held as
                    # far as the GCS knows — just cancel the release.
                    self._pending_rel.discard(oid)
                    self._pending_rel_owned.discard(oid)
                else:
                    self._pending_acq.add(oid)

    def decref(self, oid: bytes) -> None:
        if self._closed:
            return
        with self._lock:
            c = self._counts.get(oid, 0) - 1
            if c > 0:
                self._counts[oid] = c
                return
            self._counts.pop(oid, None)
            if c < 0:
                return  # unbalanced (shutdown races); ignore
            if oid in self._pending_acq:
                # The GCS (probably) never saw the acquire. Owners still
                # send an owned-release — the object may already sit in a
                # node store, and the GCS frees unknown objects only on
                # *owner* releases. Borrowers stay silent unless the flush
                # outcome was ambiguous: then a plain release is safe (the
                # GCS ignores plain releases of unknown objects).
                self._pending_acq.discard(oid)
                if oid in self._owned:
                    self._pending_rel_owned.add(oid)
                    self._owned.discard(oid)
                elif oid in self._uncertain:
                    self._pending_rel.add(oid)
            else:
                if oid in self._owned:
                    self._pending_rel_owned.add(oid)
                    self._owned.discard(oid)
                else:
                    self._pending_rel.add(oid)
            self._uncertain.discard(oid)
        try:
            self._client._on_local_release(oid)
        except Exception as e:
            # Called from GC contexts that must never raise — but a failed
            # release skips cache eviction, which reads as a memory leak.
            logger.debug("local release hook for %s failed: %s",
                         oid.hex()[:12], e)

    def decref_deferred(self, oid: bytes) -> None:
        """GC-safe decref: lock-free enqueue, applied on the next drain."""
        if not self._closed:
            self._del_queue.append(oid)

    def drain_deferred(self) -> None:
        while True:
            try:
                oid = self._del_queue.popleft()
            except IndexError:
                return
            self.decref(oid)

    def count(self, oid: bytes) -> int:
        with self._lock:
            return self._counts.get(oid, 0)

    def held_ids(self) -> list[bytes]:
        """All ids this process currently holds (for holder re-registration
        after a GCS failover)."""
        with self._lock:
            return [oid for oid, c in self._counts.items() if c > 0]

    def registration_payload(self) -> dict:
        """Full state for (re-)registration after a GCS failover: the GCS's
        ref tables are runtime-only, rebuilt from every holder re-announcing
        its holds, its owned ids, and the containment edges it registered."""
        self.drain_deferred()
        with self._lock:
            held = [oid for oid, c in self._counts.items() if c > 0]
            return {
                "holder_id": self.holder_id,
                "held": held,
                "owned": [o for o in held if o in self._owned],
                "contains": [(outer, list(inners)) for outer, inners
                             in self._registered_contains.items()],
            }

    def forget_contains(self, outer: bytes) -> None:
        # registration_payload() iterates this dict under _lock; an
        # unlocked pop here can resize it mid-iteration.
        with self._lock:
            self._registered_contains.pop(outer, None)

    def add_contains(self, outer: bytes, inners: Iterable[bytes]) -> None:
        """Record that the stored object `outer`'s serialized value embeds
        refs to `inners`. Escrow: hold the inners locally until the GCS has
        registered the containment pseudo-holder."""
        inners = list(inners)
        if not inners or self._closed:
            return
        for oid in inners:
            self.incref(oid)
        with self._lock:
            self._pending_contains.append((outer, inners))

    # ------------------------------------------------------------ flushing

    def start(self, interval_s: float) -> None:
        import asyncio

        async def loop():
            while not self._closed:
                await asyncio.sleep(interval_s)
                try:
                    await self._flush_async()
                except Exception as e:
                    logger.debug("ref flush failed: %s", e)

        self._flush_task = asyncio.ensure_future(loop())

    def _take_batch(self):
        with self._lock:
            if not (self._pending_acq or self._pending_rel
                    or self._pending_rel_owned or self._pending_contains):
                return None
            batch = (
                list(self._pending_acq),
                list(self._pending_rel),
                list(self._pending_rel_owned),
                self._pending_contains,
                [o for o in self._pending_acq if o in self._owned],
            )
            self._pending_acq = set()
            self._pending_rel = set()
            self._pending_rel_owned = set()
            self._pending_contains = []
            return batch

    async def publish(self, oids: Iterable[bytes]) -> None:
        """Return once the GCS has seen this process's holds on ``oids``
        (flushing now if any is pending or a flush is in flight). A
        submitter calls it before a task spec carrying ``oids`` leaves the
        process: the borrower's release must find the submitter among the
        object's holders, or the GCS frees an object still in use (a fresh
        task return passed on within one flush interval)."""
        if self.needs_publish(oids):
            await self._flush_async()

    def needs_publish(self, oids: Iterable[bytes]) -> bool:
        """Whether `publish` would flush: an acquire of one of ``oids`` is
        pending, or a flush (which may carry one) is in flight. Safe from
        any thread."""
        with self._lock:
            if any(o in self._pending_acq or o in self._uncertain
                   for o in oids):
                return True
        return self._flush_lock is not None and self._flush_lock.locked()

    async def _flush_async(self) -> None:
        import asyncio

        if self._flush_lock is None:
            self._flush_lock = asyncio.Lock()
        async with self._flush_lock:
            await self._flush_locked()

    async def _flush_locked(self) -> None:
        self.drain_deferred()
        self._retry_deferred_local()
        batch = self._take_batch()
        if batch is None:
            return
        acq, rel, rel_owned, contains, owned = batch
        try:
            await self._client.gcs.call("ref_update", {
                "holder_id": self.holder_id,
                "acquires": acq,
                "releases": rel,
                # Creator releases may free objects the GCS never saw an
                # acquire for (put-then-drop before the first flush).
                "releases_owned": rel_owned,
                "contains": contains,
                # Creator-owned ids: the GCS records this holder as the
                # object's owner so borrowers' failed pulls can route
                # recovery requests to it (object_recovery_manager parity).
                "owned": owned,
            }, timeout=30.0)
        except Exception:
            # Re-queue on failure. The update may have been applied server-
            # side (response lost): mark re-queued acquires ambiguous so a
            # later decref still emits a release instead of going silent.
            with self._lock:
                self._pending_acq.update(acq)
                self._uncertain.update(acq)
                self._owned.update(owned)
                self._pending_rel.update(
                    r for r in rel if self._counts.get(r, 0) == 0)
                self._pending_rel_owned.update(
                    r for r in rel_owned if self._counts.get(r, 0) == 0)
                self._pending_contains = contains + self._pending_contains
            raise
        # Containment registered — remember it for failover re-registration
        # and drop the escrow holds on the inners.
        for outer, inners in contains:
            # Lock only the dict mutation — decref takes _lock itself.
            with self._lock:
                self._registered_contains.setdefault(
                    outer, []).extend(inners)
            for oid in inners:
                self.decref(oid)

    def flush_now(self, timeout: float = 30.0, strict: bool = False) -> None:
        """Synchronously drain pending updates (any thread). Workers call
        this before replying to a task so their acquires can never be
        overtaken by the submitter's escrow release. With strict=True a
        failure propagates to the caller instead of being logged."""
        import asyncio

        if self._closed:
            return
        self.drain_deferred()
        with self._lock:
            dirty = bool(self._pending_acq or self._pending_rel
                         or self._pending_rel_owned or self._pending_contains)
        if not dirty:
            return
        fut = asyncio.run_coroutine_threadsafe(
            self._flush_async(), self._client._loop)
        try:
            fut.result(timeout)
        except Exception as e:
            if strict:
                raise
            logger.debug("flush_now failed: %s", e)

    def _retry_deferred_local(self) -> None:
        # Flusher thread only: drain the GC-side queue into the private
        # retry set, then retry. No lock needed — the queue handoff is the
        # synchronization point.
        while True:
            try:
                self._deferred_local.add(self._deferred_local_q.popleft())
            except IndexError:
                break
        for oid in list(self._deferred_local):
            if self._client._try_release_mmap(oid):
                self._deferred_local.discard(oid)

    def defer_local(self, oid: bytes) -> None:
        """GC-safe: lock-free enqueue (same contract as decref_deferred)."""
        self._deferred_local_q.append(oid)

    def close(self) -> None:
        self._closed = True
        if self._flush_task is not None:
            self._flush_task.cancel()
