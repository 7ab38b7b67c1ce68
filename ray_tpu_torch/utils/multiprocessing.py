"""multiprocessing.Pool-compatible shim over tasks.

Counterpart of ``ray_tpu/utils/multiprocessing.py`` on the port's runtime;
importing it imports no torch.

Parity: `python/ray/util/multiprocessing/pool.py` — lets
`from multiprocessing import Pool` users switch to the cluster by changing
one import. Each work item is a task; chunking matches the stdlib contract.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable

import ray_tpu_torch as rt


@rt.remote
def _run_chunk(fn_blob: bytes, chunk: list, star: bool) -> list:
    from ray_tpu_torch.core import serialization

    fn = serialization.unpack(fn_blob)
    if star:
        return [fn(*args) for args in chunk]
    return [fn(x) for x in chunk]


class AsyncResult:
    def __init__(self, refs: list, single: bool):
        self._refs = refs
        self._single = single

    def get(self, timeout: float | None = None):
        chunks = rt.get(self._refs, timeout=timeout)
        out = list(itertools.chain.from_iterable(chunks))
        return out[0] if self._single else out

    def wait(self, timeout: float | None = None) -> None:
        rt.wait(self._refs, num_returns=len(self._refs), timeout=timeout)

    def ready(self) -> bool:
        done, _ = rt.wait(self._refs, num_returns=len(self._refs),
                          timeout=0)
        return len(done) == len(self._refs)

    def successful(self) -> bool:
        """Whether every chunk finished without raising; False while any
        is still running. Once `ready`, the values are fetched without a
        deadline: a chunk's object can be in the store before its task's
        completion reaches this process, and a zero-timeout get would
        take that window for a failure."""
        if not self.ready():
            return False
        try:
            self.get()
            return True
        except Exception:
            return False


class Pool:
    """Process pool on cluster tasks. `processes` bounds in-flight chunks."""

    def __init__(self, processes: int | None = None):
        if not rt.is_initialized():
            rt.init()
        self._processes = processes or int(
            rt.cluster_resources().get("CPU", 4))
        self._closed = False

    # ---- helpers ----

    @staticmethod
    def _pack(fn: Callable) -> bytes:
        from ray_tpu_torch.core import serialization

        return serialization.pack(fn)

    def _chunks(self, iterable: Iterable, chunksize: int | None) -> list[list]:
        items = list(iterable)
        if chunksize is None:
            chunksize = max(1, len(items) // (self._processes * 4) or 1)
        return [items[i : i + chunksize]
                for i in range(0, len(items), chunksize)]

    def _check(self):
        if self._closed:
            raise ValueError("Pool is closed")

    # ---- apply ----

    def apply(self, fn: Callable, args: tuple = (), kwds: dict | None = None):
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn: Callable, args: tuple = (),
                    kwds: dict | None = None) -> AsyncResult:
        self._check()

        def call(payload):
            f, a, k = payload
            return f(*a, **(k or {}))

        ref = _run_chunk.remote(self._pack(call), [(fn, args, kwds)], False)
        return AsyncResult([ref], single=True)

    # ---- map ----

    def map(self, fn: Callable, iterable: Iterable,
            chunksize: int | None = None) -> list:
        return self.map_async(fn, iterable, chunksize).get()

    def map_async(self, fn: Callable, iterable: Iterable,
                  chunksize: int | None = None) -> AsyncResult:
        self._check()
        blob = self._pack(fn)
        refs = [_run_chunk.remote(blob, c, False)
                for c in self._chunks(iterable, chunksize)]
        return AsyncResult(refs, single=False)

    def starmap(self, fn: Callable, iterable: Iterable,
                chunksize: int | None = None) -> list:
        self._check()
        blob = self._pack(fn)
        refs = [_run_chunk.remote(blob, c, True)
                for c in self._chunks(iterable, chunksize)]
        return AsyncResult(refs, single=False).get()

    def imap(self, fn: Callable, iterable: Iterable,
             chunksize: int | None = None):
        self._check()
        blob = self._pack(fn)
        refs = [_run_chunk.remote(blob, c, False)
                for c in self._chunks(iterable, chunksize)]
        for ref in refs:
            yield from rt.get(ref)

    def imap_unordered(self, fn: Callable, iterable: Iterable,
                       chunksize: int | None = None):
        self._check()
        blob = self._pack(fn)
        refs = [_run_chunk.remote(blob, c, False)
                for c in self._chunks(iterable, chunksize)]
        pending = list(refs)
        while pending:
            done, pending = rt.wait(pending, num_returns=1)
            for ref in done:
                yield from rt.get(ref)

    # ---- lifecycle ----

    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        self._closed = True

    def join(self) -> None:
        if not self._closed:
            raise ValueError("Pool is still open")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()
        return False
