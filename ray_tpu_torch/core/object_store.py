"""Per-node shared-memory object store (plasma equivalent).

Parity target: the reference's plasma store (`src/ray/
object_manager/plasma/store.h:55`) — an mmap'd arena shared across all
processes on a node with zero-copy reads, eviction, spilling, and
backpressured creation. Architecture:

- ONE mmap'd slab per node under /dev/shm, managed by the native C++
  best-fit/coalescing allocator (`ray_tpu/_native/arena.cc` — the equivalent
  of plasma's `plasma_allocator.cc` + `dlmalloc.cc`). Objects are (offset,
  size) extents. Clients attach the slab once by name and slice at offsets —
  attach-by-name replaces plasma's unix-socket fd passing (`fling.cc`).
- The store's *metadata* (what exists, sealed state, pins) lives in the node
  daemon process; clients create/write/seal extents directly and only
  metadata crosses the RPC boundary — data never does (except inline small
  objects, ref: ray_config_def.h:210 max_direct_call_object_size=100KB).
- Spill-to-disk under memory pressure + restore on demand
  (ref: local_object_manager.h:41, external_storage.py). Restore may place
  the object at a new offset; objects pinned by readers are never spilled.
"""

from __future__ import annotations

import asyncio
import logging
import mmap
import os
import time
from dataclasses import dataclass, field
from typing import Any

from ray_tpu_torch._native import ArenaAllocator
from ray_tpu_torch.core.config import Config
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core import serialization

logger = logging.getLogger(__name__)

SHM_DIR = "/dev/shm"


def shm_path(name: str) -> str:
    return os.path.join(SHM_DIR, name)


_arena_cache: dict[str, memoryview] = {}


def sweep_stale_arenas() -> int:
    """Unlink slabs whose owner daemon died without shutdown (arena names end
    in the owner's pid). Called on store startup; plasma gets this for free by
    owning fds, we attach by name instead."""
    n = 0
    try:
        names = os.listdir(SHM_DIR)
    except OSError:
        return 0
    for fn in names:
        if not fn.startswith("raytpu-torch-arena-"):
            continue
        pid = fn.rsplit("-", 1)[-1]
        if pid.isdigit() and not os.path.exists(f"/proc/{pid}"):
            try:
                os.unlink(os.path.join(SHM_DIR, fn))
                n += 1
            except OSError:
                pass
    return n


def attach_arena(name: str) -> memoryview:
    """Client-side: mmap a node's slab once; cached for process lifetime."""
    view = _arena_cache.get(name)
    if view is None:
        path = shm_path(name)
        size = os.path.getsize(path)
        fd = os.open(path, os.O_RDWR)
        try:
            mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        view = memoryview(mm)
        _arena_cache[name] = view
    return view


def attach_extent(name: str, offset: int, size: int) -> memoryview:
    """Client-side zero-copy view of one object's extent."""
    return attach_arena(name)[offset : offset + size]


# Entry locations
INLINE, SHM, SPILLED = "inline", "shm", "spilled"


_gen_counter = iter(range(1, 1 << 62)).__next__


@dataclass
class Entry:
    location: str
    size: int
    sealed: bool = False
    data: bytes | None = None          # INLINE
    offset: int | None = None          # SHM: extent offset in the slab
    spill_path: str | None = None      # SPILLED
    pins: int = 0                      # live zero-copy readers
    doomed: bool = False               # freed while pinned; release at pins==0
    last_used: float = field(default_factory=time.monotonic)
    # Generation token: distinguishes this entry from an earlier freed+
    # re-created entry of the same ObjectID, so a reader's unpin targets the
    # exact extent it read (not "oldest zombie first", which could release a
    # different connection's extent).
    gen: int = field(default_factory=_gen_counter)


class LocalObjectStore:
    """Authoritative per-node store: slab allocator + spill/evict engine.

    Runs inside the node daemon's asyncio loop; all methods are
    single-threaded coroutine-safe.
    """

    def __init__(self, node_hex: str, config: Config, spill_dir: str):
        self.node_hex = node_hex
        self.config = config
        self.spill_dir = spill_dir
        os.makedirs(spill_dir, exist_ok=True)
        self.entries: dict[ObjectID, Entry] = {}
        self._seal_events: dict[ObjectID, asyncio.Event] = {}
        self._restoring: dict[ObjectID, asyncio.Task] = {}
        # Extents freed-while-pinned whose ObjectID was since re-created:
        # kept until their readers disconnect (see create()).
        self._zombies: list[tuple[ObjectID, Entry]] = []
        self.capacity = config.object_store_memory
        sweep_stale_arenas()
        self.arena_name = f"raytpu-torch-arena-{node_hex[:16]}-{os.getpid()}"
        self.arena = ArenaAllocator(shm_path(self.arena_name), self.capacity)
        self._view = attach_arena(self.arena_name)

    @property
    def shm_bytes(self) -> int:
        return self.arena.used

    # ---- creation ----

    def put_inline(self, obj_id: ObjectID, data: bytes) -> None:
        if obj_id in self.entries:
            return
        self.entries[obj_id] = Entry(
            location=INLINE, size=len(data), sealed=True, data=data
        )
        self._wake(obj_id)

    async def create(self, obj_id: ObjectID, size: int) -> tuple[str, int]:
        """Reserve an extent for a client to fill; returns (slab name, offset)."""
        if obj_id in self.entries:
            e = self.entries[obj_id]
            if e.doomed:
                # Freed while readers still hold views; park the old extent
                # until its pins drop (unpin scans zombies) and re-create.
                self._zombies.append((obj_id, self.entries.pop(obj_id)))
            elif e.location == SHM and not e.sealed:
                return self.arena_name, e.offset  # idempotent re-create
            else:
                raise KeyError(f"{obj_id} already exists")
        offset = await self._alloc(size)
        self.entries[obj_id] = Entry(location=SHM, size=size, offset=offset)
        return self.arena_name, offset

    def seal(self, obj_id: ObjectID) -> None:
        e = self.entries[obj_id]
        e.sealed = True
        e.last_used = time.monotonic()
        self._wake(obj_id)

    def _wake(self, obj_id: ObjectID) -> None:
        ev = self._seal_events.pop(obj_id, None)
        if ev is not None:
            ev.set()

    # ---- reads ----

    def contains(self, obj_id: ObjectID) -> bool:
        e = self.entries.get(obj_id)
        return e is not None and e.sealed and not e.doomed

    async def wait_sealed(self, obj_id: ObjectID, timeout: float | None) -> bool:
        if self.contains(obj_id):
            return True
        ev = self._seal_events.setdefault(obj_id, asyncio.Event())
        try:
            await asyncio.wait_for(ev.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def describe(self, obj_id: ObjectID, pin: bool = False):
        """→ ("inline", bytes) | ("shm", (slab, offset, size)). Restores
        spills. `pin=True` marks a live zero-copy reader: the extent must not
        be spilled/moved under the reader's mmap (plasma client-ref model)."""
        e = self.entries[obj_id]
        if e.doomed:
            raise KeyError(f"{obj_id} was freed")
        e.last_used = time.monotonic()
        if e.location == INLINE:
            return INLINE, e.data
        if e.location == SPILLED:
            # Single-flight restore: concurrent readers of a spilled object
            # share one restore task (double-restore would leak an extent and
            # unlink the spill file twice). The restore itself holds a pin so
            # a concurrent free() defers instead of unlinking mid-read.
            e.pins += 1
            try:
                t = self._restoring.get(obj_id)
                if t is None:
                    t = asyncio.ensure_future(self._restore(obj_id, e))
                    self._restoring[obj_id] = t
                    t.add_done_callback(
                        lambda _t: self._restoring.pop(obj_id, None))
                await asyncio.shield(t)
            finally:
                self.pin(obj_id, -1)  # releases now if freed during restore
            if e.doomed:
                raise KeyError(f"{obj_id} was freed")
        if pin:
            e.pins += 1
        return SHM, (self.arena_name, e.offset, e.size)

    def pin(self, obj_id: ObjectID, delta: int = 1) -> None:
        e = self.entries.get(obj_id)
        if e is not None:
            e.pins = max(0, e.pins + delta)
            if e.pins == 0 and e.doomed:
                self._release(obj_id, e)

    def unpin(self, obj_id: ObjectID, gen: int | None = None) -> None:
        """Release one reader pin. With `gen`, the pin targets exactly the
        entry generation the reader attached to (live or zombie); without it
        (legacy callers), zombies drain first."""
        if gen is not None:
            e = self.entries.get(obj_id)
            if e is not None and e.gen == gen:
                self.pin(obj_id, -1)
                return
            for i, (zid, ze) in enumerate(self._zombies):
                if zid == obj_id and ze.gen == gen:
                    ze.pins -= 1
                    if ze.pins <= 0:
                        self._free_extent(ze)
                        self._zombies.pop(i)
                    return
            return
        for i, (zid, ze) in enumerate(self._zombies):
            if zid == obj_id and ze.pins > 0:
                ze.pins -= 1
                if ze.pins == 0:
                    self._free_extent(ze)
                    self._zombies.pop(i)
                return
        self.pin(obj_id, -1)

    def entry_gen(self, obj_id: ObjectID) -> int | None:
        e = self.entries.get(obj_id)
        return None if e is None else e.gen

    def write_bytes(self, obj_id: ObjectID, offset: int, data: bytes) -> None:
        """Daemon-side fill of an unsealed extent (node-to-node pull path)."""
        e = self.entries[obj_id]
        base = e.offset + offset
        self._view[base : base + len(data)] = data

    def read_bytes(self, obj_id: ObjectID, offset: int, length: int) -> bytes:
        """For node-to-node transfer serving (chunked)."""
        e = self.entries[obj_id]
        if e.location == INLINE:
            return e.data[offset : offset + length]
        if e.location == SPILLED:
            with open(e.spill_path, "rb") as f:
                f.seek(offset)
                return f.read(length)
        base = e.offset + offset
        return bytes(self._view[base : base + length])

    # ---- delete / evict / spill ----

    def free(self, obj_id: ObjectID) -> None:
        """Logically delete. If readers still hold zero-copy views (pins>0)
        the extent is kept until the last unpin so their memory can't be
        reused under them (plasma's client-reference semantics)."""
        e = self.entries.get(obj_id)
        if e is None:
            return
        if e.pins > 0:
            e.doomed = True
            return
        self._release(obj_id, e)

    def _release(self, obj_id: ObjectID, e: Entry) -> None:
        self.entries.pop(obj_id, None)
        self._free_extent(e)

    def _free_extent(self, e: Entry) -> None:
        if e.location == SHM:
            self.arena.free(e.offset)
        elif e.location == SPILLED and e.spill_path:
            self._unlink_quiet(e.spill_path)

    async def _alloc(self, size: int) -> int:
        """Backpressured allocation: spill LRU sealed unpinned objects until
        the extent fits (ref: create_request_queue.cc semantics)."""
        limit = int(self.capacity * self.config.object_spill_threshold)
        if self.arena.used + size <= limit:
            offset = self.arena.alloc(size)
            if offset is not None:
                return offset
        victims = sorted(
            (e.last_used, oid)
            for oid, e in self.entries.items()
            if e.location == SHM and e.sealed and e.pins == 0
        )
        for _, oid in victims:
            if self.arena.used + size <= limit:
                offset = self.arena.alloc(size)
                if offset is not None:
                    return offset
            await self._spill(oid)
        offset = self.arena.alloc(size)
        if offset is None:
            raise MemoryError(
                f"object store full: used={self.arena.used} "
                f"largest_free={self.arena.largest_free()} want={size}"
            )
        return offset

    async def _spill(self, obj_id: ObjectID) -> None:
        # Revalidate: state may have changed since victim selection (free,
        # new reader pin, an earlier victim's spill yielding the loop).
        e = self.entries.get(obj_id)
        if (e is None or e.location != SHM or not e.sealed or e.pins > 0
                or e.doomed):
            return
        path = os.path.join(self.spill_dir, obj_id.hex())
        data = bytes(self._view[e.offset : e.offset + e.size])
        # Spill guard pin: a concurrent free() defers (doomed) instead of
        # double-freeing the extent, and eviction skips this entry.
        e.pins += 1
        try:
            await asyncio.to_thread(self._write_file, path, data)
        finally:
            e.pins -= 1
        if e.doomed:
            if e.pins == 0:
                self._release(obj_id, e)
            self._unlink_quiet(path)
            return
        if e.pins > 0:
            # A reader pinned the extent mid-write; it must stay in shm.
            self._unlink_quiet(path)
            return
        self.arena.free(e.offset)
        e.location = SPILLED
        e.spill_path = path
        e.offset = None
        logger.debug("spilled %s (%d bytes)", obj_id.hex()[:12], e.size)

    @staticmethod
    def _unlink_quiet(path: str) -> None:
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass

    @staticmethod
    def _write_file(path: str, data: bytes) -> None:
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    async def _restore(self, obj_id: ObjectID, e: Entry) -> None:
        offset = await self._alloc(e.size)
        try:
            data = await asyncio.to_thread(
                lambda: open(e.spill_path, "rb").read())
        except BaseException:
            self.arena.free(offset)
            raise
        self._view[offset : offset + e.size] = data
        os.unlink(e.spill_path)
        e.location = SHM
        e.offset = offset
        e.spill_path = None

    # ---- introspection ----

    def stats(self) -> dict:
        return {
            "objects": len(self.entries),
            "shm_bytes": self.arena.used,
            "capacity": self.capacity,
            "native_allocator": self.arena.native,
            "spilled": sum(
                1 for e in self.entries.values() if e.location == SPILLED
            ),
        }

    def shutdown(self) -> None:
        for oid in list(self.entries):
            self.free(oid)
        view = _arena_cache.pop(self.arena_name, None)
        if view is not None:
            view.release()
        self.arena.close(unlink=True)
