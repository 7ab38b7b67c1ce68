"""Object serialization: cloudpickle envelope + out-of-band zero-copy buffers.

Parity with the reference's msgpack+pickle5 scheme (`python/
ray/_private/serialization.py:191-207`): the pickle stream holds structure,
large contiguous buffers (numpy arrays, torch CPU tensors, bytes) travel
out-of-band so they can be written into / read from shared memory without a
copy. ObjectRefs are serialized by identity so refs survive capture in
closures and nested objects (ref: serialization.py:110-131).

Torch tensors. A strided CPU tensor (any dtype, bf16 included: its bytes
are viewed as uint8) is reduced to one out-of-band buffer of its raw bytes
plus its dtype and shape, where torch's own pickling would copy the bytes
into the stream. It is rebuilt as a tensor that owns a COPY of those bytes:
torch cannot mark a tensor read-only, and a tensor viewing the shared arena
would let one reader's in-place write change the object under every other
reader. A CUDA tensor at top level (a task's return, a put) is moved to the
host first, as a jax.Array is in the JAX runtime, and comes back as a CPU
tensor; a CUDA tensor nested in a container keeps torch's own pickling and
comes back on its device, as a nested jax.Array comes back a jax.Array.
This module never imports torch: a tensor can only exist in this process
if torch is already in sys.modules.

Wire format of a serialized object:
    [u32 n_buffers][u64 len_i ... ]  header
    [pickle bytes]                    protocol-5 stream with PickleBuffer refs
    [buffer_0][buffer_1]...           8-byte-aligned raw buffers
"""

from __future__ import annotations

import io
import logging
import pickle
import struct
import sys
import threading
from typing import Any, Callable

import cloudpickle

logger = logging.getLogger(__name__)

_ALIGN = 8

# ---------------------------------------------------------------- ref capture
#
# Distributed ref counting (ref: reference_count.h:511-556 borrowed refs)
# needs to know which ObjectRefs escape the process inside a serialized
# value — task args, put() payloads, task returns. ObjectRef.__reduce__
# reports into the innermost active capture scope.

_capture = threading.local()


class capture_refs:
    """Context manager collecting ObjectRef ids serialized within."""

    def __enter__(self) -> set:
        stack = getattr(_capture, "stack", None)
        if stack is None:
            stack = _capture.stack = []
        s: set = set()
        stack.append(s)
        return s

    def __exit__(self, *exc):
        _capture.stack.pop()
        return False


def note_ref(oid: bytes) -> None:
    """Called from ObjectRef.__reduce__ during pickling."""
    stack = getattr(_capture, "stack", None)
    if stack:
        stack[-1].add(oid)


def _pad(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _loaded_torch():
    """torch if this process has imported it fully, else None.

    Never IMPORTS torch: a tensor can only exist in this process if torch
    is already in sys.modules, and a cold torch import here would sit
    directly in the task store-returns hot path of torch-free workers. A
    module still initializing (another thread of a threaded actor is
    importing torch) is treated as absent: it has made no tensor yet, and
    its attributes are not all there."""
    torch = sys.modules.get("torch")
    if torch is None or getattr(getattr(torch, "__spec__", None),
                                "_initializing", False):
        return None
    return torch


def _to_host(obj: Any) -> Any:
    """A CUDA tensor → its CPU copy before pickling."""
    torch = _loaded_torch()
    if (torch is not None and isinstance(obj, torch.Tensor)
            and obj.device.type == "cuda"):
        return obj.detach().cpu()
    return obj


def _host_tensor_reduce(obj: Any):
    """The out-of-band reduction of a plain strided CPU tensor, or None
    for anything else (which keeps its own pickling)."""
    torch = _loaded_torch()
    if (torch is None or type(obj) is not torch.Tensor
            or obj.device.type != "cpu" or obj.layout != torch.strided
            or obj.is_quantized or obj.requires_grad):
        return None
    flat = obj.resolve_conj().resolve_neg().contiguous().reshape(-1)
    raw = flat.view(torch.uint8).numpy()
    return (_rebuild_host_tensor,
            (pickle.PickleBuffer(raw), str(obj.dtype).split(".")[-1],
             tuple(obj.shape)))


def _rebuild_host_tensor(buf, dtype: str, shape: tuple):
    """A tensor owning a copy of `buf`'s bytes (see the module notes)."""
    import numpy as np
    import torch

    src = np.frombuffer(buf, np.uint8)
    out = torch.empty(src.size, dtype=torch.uint8)
    if src.size:
        np.copyto(out.numpy(), src)
    return out.view(getattr(torch, dtype)).reshape(shape)


class _Pickler(cloudpickle.Pickler):
    def reducer_override(self, obj):
        red = _host_tensor_reduce(obj)
        return red if red is not None else super().reducer_override(obj)


_BY_VALUE_REGISTERED: set[str] = set()


def _ensure_by_value(obj: Any) -> None:
    """Driver-local modules (scripts, tests) aren't importable in workers —
    register them with cloudpickle so their functions/classes serialize by
    value (parity with shipping driver code; the reference solves this with
    runtime_env working_dir upload, runtime_env/packaging.py)."""
    import sysconfig

    mod_name = getattr(obj, "__module__", None)
    if (
        not mod_name
        or mod_name in _BY_VALUE_REGISTERED
        or mod_name == "__main__"
        or mod_name.split(".")[0] == "ray_tpu_torch"
    ):
        return
    mod = sys.modules.get(mod_name)
    f = getattr(mod, "__file__", None) if mod else None
    if not f:
        return
    paths = sysconfig.get_paths()
    if f.startswith(paths["stdlib"]) or f.startswith(paths["purelib"]):
        return
    try:
        cloudpickle.register_pickle_by_value(mod)
        _BY_VALUE_REGISTERED.add(mod_name)
    except Exception as e:
        # Falls back to by-reference pickling: the worker will need the
        # module importable, which surfaces later as a confusing
        # ModuleNotFoundError — record why registration failed here.
        logger.debug("register_pickle_by_value(%s) failed: %s", mod_name, e)


def serialize(value: Any) -> tuple[bytes, list[memoryview]]:
    """Returns (header+pickle bytes, out-of-band buffers)."""
    buffers: list[pickle.PickleBuffer] = []
    value = _to_host(value)
    if callable(value) or isinstance(value, type):
        _ensure_by_value(value)
    f = io.BytesIO()
    _Pickler(f, protocol=5, buffer_callback=buffers.append).dump(value)
    payload = f.getvalue()
    views = [b.raw() for b in buffers]
    header = struct.pack("<I", len(views)) + b"".join(
        struct.pack("<Q", len(v)) for v in views
    )
    return header + payload, views


def serialized_size(head: bytes, views: list[memoryview]) -> int:
    return _pad(len(head)) + sum(_pad(len(v)) for v in views)


def write_to(buf: memoryview, head: bytes, views: list[memoryview]) -> int:
    """Write the full serialized form into `buf`; returns bytes written."""
    off = 0
    buf[off : off + len(head)] = head
    off = _pad(len(head))
    for v in views:
        buf[off : off + len(v)] = v
        off = _pad(off + len(v))
    return off


def pack(value: Any) -> bytes:
    head, views = serialize(value)
    out = bytearray(serialized_size(head, views))
    write_to(memoryview(out), head, views)
    return bytes(out)


class BufferExporter:
    """One out-of-band buffer of an unpacked value, handed to the
    unpickler through the buffer protocol (PEP 688) so that its readers
    can be counted: ``exports`` is the number of buffers taken from it
    and not yet released (an array built on it holds one for its life).
    A slice of a memoryview cannot tell this: views derived from it are
    not exports of it."""

    __slots__ = ("_view", "_lock", "exports")

    def __init__(self, view: memoryview):
        self._view = view
        self._lock = threading.Lock()
        self.exports = 0

    def __buffer__(self, flags: int) -> memoryview:
        with self._lock:
            self.exports += 1
        return memoryview(self._view)

    def __release_buffer__(self, view: memoryview) -> None:
        view.release()
        with self._lock:
            self.exports -= 1


def unpack(buf: memoryview | bytes | bytearray,
           exporters: list | None = None) -> Any:
    """Deserialize from a contiguous buffer. Buffers are zero-copy views into
    `buf` — keep the backing memory alive as long as the object.
    ``exporters``, when given, receives one `BufferExporter` per
    out-of-band buffer, through which the value reads it: the memory may
    be reused once every exporter's ``exports`` is 0."""
    buf = memoryview(buf)
    (n_buf,) = struct.unpack_from("<I", buf, 0)
    sizes = [
        struct.unpack_from("<Q", buf, 4 + 8 * i)[0] for i in range(n_buf)
    ]
    header_len = 4 + 8 * n_buf
    # Find pickle length: it runs from header_len to the first aligned buffer.
    # We stored pickle immediately after header; buffers start at
    # _pad(header_len + pickle_len) — recover by parsing from the end:
    total_buf = 0
    for s in sizes:
        total_buf = _pad(total_buf + s)
    pickle_end = len(buf) - total_buf
    payload = buf[header_len:pickle_end]
    off = _pad(pickle_end)
    out_of_band = []
    for s in sizes:
        out_of_band.append(buf[off : off + s])
        off = _pad(off + s)
    if exporters is not None:
        out_of_band = [BufferExporter(v) for v in out_of_band]
        exporters.extend(out_of_band)
    return pickle.loads(payload, buffers=out_of_band)


def dumps_call(obj: Any) -> bytes:
    """Pickle for control-plane messages (no out-of-band)."""
    return cloudpickle.dumps(obj)


def loads_call(b: bytes) -> Any:
    return pickle.loads(b)
