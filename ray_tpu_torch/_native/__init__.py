"""Native (C++) components, loaded via ctypes.

The reference keeps its data plane in C++ (plasma allocator:
`src/ray/object_manager/plasma/plasma_allocator.cc`); here the
equivalent is `arena.cc` — a best-fit coalescing allocator over one mmap'd
/dev/shm slab per node. The store daemon allocates extents through this
library; clients mmap the slab once and read extents zero-copy.

The .so is compiled on demand with g++ (no pybind11 in the image; plain C ABI
+ ctypes) and cached under `build/ray_tpu_torch/native/` at the repository
root (beside the CUDA kernel library), keyed on source mtime. A pure-Python
fallback allocator with identical semantics exists for environments without a
toolchain (`PyArenaAlloc`).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

logger = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                      "ray_tpu_torch", "native")
_SO = os.path.join(_BUILD, "libraytpu.so")
_SRC = os.path.join(_DIR, "arena.cc")

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def _compile() -> bool:
    os.makedirs(_BUILD, exist_ok=True)
    # Per-pid tmp: concurrent cold-start daemons must not interleave writes
    # to the same output before the atomic publish.
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-std=c++17", "-fPIC", "-shared", "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except Exception as e:  # toolchain missing / compile error
        logger.warning("native build failed, using Python fallback: %s", e)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def load():
    """Load (building if stale) the native library; None if unavailable."""
    global _lib, _build_failed
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        fresh = os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)
        if not fresh and not _compile():
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError as e:  # corrupt/foreign .so → degrade to fallback
            logger.warning("native load failed, using Python fallback: %s", e)
            _build_failed = True
            return None
        lib.rt_arena_create.restype = ctypes.c_void_p
        lib.rt_arena_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.rt_arena_attach.restype = ctypes.c_void_p
        lib.rt_arena_attach.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.rt_arena_capacity.restype = ctypes.c_uint64
        lib.rt_arena_capacity.argtypes = [ctypes.c_void_p]
        lib.rt_arena_used.restype = ctypes.c_uint64
        lib.rt_arena_used.argtypes = [ctypes.c_void_p]
        lib.rt_arena_num_allocs.restype = ctypes.c_uint64
        lib.rt_arena_num_allocs.argtypes = [ctypes.c_void_p]
        lib.rt_arena_largest_free.restype = ctypes.c_uint64
        lib.rt_arena_largest_free.argtypes = [ctypes.c_void_p]
        lib.rt_arena_alloc.restype = ctypes.c_int
        lib.rt_arena_alloc.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64)]
        lib.rt_arena_free.restype = ctypes.c_int64
        lib.rt_arena_free.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.rt_arena_close.restype = None
        lib.rt_arena_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _lib = lib
        return _lib


class PyArenaAlloc:
    """Pure-Python twin of arena.cc's allocator (fallback; same semantics)."""

    ALIGN = 64

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.used = 0
        self.free_by_off: dict[int, int] = {0: capacity}
        self.live: dict[int, int] = {}

    def alloc(self, size: int) -> int | None:
        size = max(size, 1)
        size = (size + self.ALIGN - 1) & ~(self.ALIGN - 1)
        best = None
        for off, bsize in self.free_by_off.items():
            if bsize >= size and (best is None or bsize < best[1]):
                best = (off, bsize)
        if best is None:
            return None
        off, bsize = best
        del self.free_by_off[off]
        if bsize > size:
            self.free_by_off[off + size] = bsize - size
        self.live[off] = size
        self.used += size
        return off

    def free(self, offset: int) -> int:
        size = self.live.pop(offset)
        self.used -= size
        nxt = self.free_by_off.pop(offset + size, None)
        if nxt is not None:
            size += nxt
        for poff in sorted(self.free_by_off):
            if poff + self.free_by_off[poff] == offset:
                offset, size = poff, size + self.free_by_off.pop(poff)
                break
        self.free_by_off[offset] = size
        return size

    def largest_free(self) -> int:
        return max(self.free_by_off.values(), default=0)


class ArenaAllocator:
    """Owner-side allocator over a /dev/shm slab file (native if available).

    Only the node daemon uses this; clients attach the file read-only with
    `mmap` and slice at offsets handed out over RPC.
    """

    def __init__(self, path: str, capacity: int):
        self.path = path
        self.capacity = capacity
        self._lib = load()
        if self._lib is not None:
            h = self._lib.rt_arena_create(path.encode(), capacity)
            if not h:
                raise OSError(f"rt_arena_create failed for {path}")
            self._h = ctypes.c_void_p(h)
            self._py = None
        else:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
            try:
                os.ftruncate(fd, capacity)
            finally:
                os.close(fd)
            self._h = None
            self._py = PyArenaAlloc(capacity)

    @property
    def native(self) -> bool:
        return self._h is not None

    def alloc(self, size: int) -> int | None:
        if self._h is not None:
            out = ctypes.c_uint64()
            rc = self._lib.rt_arena_alloc(self._h, size, ctypes.byref(out))
            return out.value if rc == 0 else None
        return self._py.alloc(size)

    def free(self, offset: int) -> int:
        if self._h is not None:
            released = self._lib.rt_arena_free(self._h, offset)
            if released < 0:
                raise KeyError(f"offset {offset} not live")
            return released
        return self._py.free(offset)

    @property
    def used(self) -> int:
        if self._h is not None:
            return self._lib.rt_arena_used(self._h)
        return self._py.used

    def largest_free(self) -> int:
        if self._h is not None:
            return self._lib.rt_arena_largest_free(self._h)
        return self._py.largest_free()

    def close(self, unlink: bool = True) -> None:
        if self._h is not None:
            self._lib.rt_arena_close(self._h, int(unlink))
            self._h = None
        elif unlink:
            try:
                os.unlink(self.path)
            except FileNotFoundError:
                pass
