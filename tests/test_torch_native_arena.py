"""The port's runtime, case for case as the JAX package's
``tests/test_native_arena.py``.

Native C++ arena allocator: build, ctypes binding, cross-process attach.

Mirrors the reference's allocator-level tests
(`src/ray/object_manager/test/`); the C++-side unit tests
live in `ray_tpu_torch/_native/arena_test.cc` and are also run here via make.
"""

import os
import subprocess

import pytest

from ray_tpu_torch import _native

NATIVE_DIR = os.path.dirname(os.path.abspath(_native.__file__))


def test_cpp_unit_tests():
    """The assert-based C++ test binary passes."""
    r = subprocess.run(
        ["make", "-s", "test"], cwd=NATIVE_DIR, capture_output=True, text=True,
        timeout=180,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "all assertions passed" in r.stdout


def test_native_library_loads():
    assert _native.load() is not None, "native build must succeed in this image"


def test_alloc_free_reuse(tmp_path):
    a = _native.ArenaAllocator(str(tmp_path / "slab"), 1 << 20)
    assert a.native
    o1 = a.alloc(100)
    o2 = a.alloc(200)
    assert o1 != o2 and o1 % 64 == 0 and o2 % 64 == 0
    assert a.used == 128 + 256  # 64B-aligned
    assert a.free(o1) == 128
    o3 = a.alloc(100)
    assert o3 == o1  # best-fit reuses the hole
    a.free(o2)
    a.free(o3)
    assert a.used == 0
    assert a.largest_free() == 1 << 20
    a.close()
    assert not os.path.exists(tmp_path / "slab")


def test_exhaustion_returns_none(tmp_path):
    a = _native.ArenaAllocator(str(tmp_path / "slab"), 4096)
    big = a.alloc(4096)
    assert big is not None
    assert a.alloc(64) is None
    a.free(big)
    assert a.alloc(64) is not None
    a.close()


def test_python_fallback_same_semantics():
    py = _native.PyArenaAlloc(1 << 16)
    o1, o2, o3 = py.alloc(100), py.alloc(300), py.alloc(50)
    py.free(o2)
    assert py.alloc(300) == o2
    py.free(o1)
    py.free(o3)
    py.free(o2)
    assert py.used == 0 and py.largest_free() == 1 << 16


def test_cross_process_visibility(tmp_path):
    """Owner writes through the slab mmap; a child process attaches by path
    and reads the same bytes (plasma fd-passing equivalent)."""
    import mmap
    slab = str(tmp_path / "slab")
    a = _native.ArenaAllocator(slab, 1 << 16)
    off = a.alloc(128)
    with open(slab, "r+b") as f:
        mm = mmap.mmap(f.fileno(), 1 << 16)
        mm[off:off + 5] = b"zerocp"[:5]
        mm.close()
    code = (
        "import mmap,sys\n"
        f"f=open({slab!r},'r+b'); mm=mmap.mmap(f.fileno(), {1 << 16})\n"
        f"assert bytes(mm[{off}:{off}+5])==b'zeroc', bytes(mm[{off}:{off}+5])\n"
        "print('child-ok')\n"
    )
    r = subprocess.run(["python", "-c", code], capture_output=True, text=True)
    assert r.returncode == 0 and "child-ok" in r.stdout, r.stderr
    a.close()
