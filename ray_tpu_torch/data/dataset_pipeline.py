"""DatasetPipeline: windowed streaming execution.

Counterpart of ``ray_tpu/data/dataset_pipeline.py`` (parity:
``python/ray/data/dataset_pipeline.py``): split a dataset into windows of
blocks executed one window at a time (bounding cluster memory), with the
next window materializing in the background while the current one is
consumed (the pipelining that keeps a device feed saturated without
materializing the whole dataset).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Iterator



class DatasetPipeline:
    def __init__(self, windows: "list", stages: list | None = None,
                 repeats: int = 1):
        # `windows` are base Datasets (no stages); transforms accumulate
        # here and apply per window at iteration time.
        self._windows = windows
        self._stages = stages or []
        self._repeats = repeats

    # ---- construction ----

    @classmethod
    def from_dataset(cls, ds, *, blocks_per_window: int = 1) -> "DatasetPipeline":
        from ray_tpu_torch.data.dataset import Dataset

        base = ds.materialize() if ds._stages else ds
        refs = base._block_refs
        windows = [
            Dataset(refs[i : i + blocks_per_window])
            for i in range(0, len(refs), blocks_per_window)
        ]
        return cls(windows)

    # ---- transforms (deferred to each window) ----

    def _with(self, fn: Callable) -> "DatasetPipeline":
        return DatasetPipeline(self._windows, self._stages + [fn],
                               self._repeats)

    def map_batches(self, fn, **kw) -> "DatasetPipeline":
        return self._with(lambda ds: ds.map_batches(fn, **kw))

    def map(self, fn) -> "DatasetPipeline":
        return self._with(lambda ds: ds.map(fn))

    def filter(self, fn) -> "DatasetPipeline":
        return self._with(lambda ds: ds.filter(fn))

    def random_shuffle_each_window(self, *, seed=None) -> "DatasetPipeline":
        return self._with(lambda ds: ds.random_shuffle(seed=seed))

    def repeat(self, times: int) -> "DatasetPipeline":
        """Loop the whole pipeline `times` times (epochs)."""
        return DatasetPipeline(self._windows, self._stages,
                               self._repeats * times)

    # ---- execution ----

    def _window_plan(self, ds):
        for fn in self._stages:
            ds = fn(ds)
        return ds

    def iter_windows(self) -> Iterator:
        """Yield materialized window Datasets; window i+1 executes in the
        background while window i is consumed."""
        total = len(self._windows) * self._repeats

        def window_at(i: int):
            return self._window_plan(self._windows[i % len(self._windows)])

        nxt: dict[int, Any] = {}
        lock = threading.Lock()

        def prefetch(i: int):
            try:
                mat = window_at(i).materialize()
            except Exception as e:  # surfaced when the consumer reaches i
                mat = e
            with lock:
                nxt[i] = mat

        t = threading.Thread(target=prefetch, args=(0,), daemon=True)
        t.start()
        for i in range(total):
            t.join()
            with lock:
                mat = nxt.pop(i)
            if i + 1 < total:
                t = threading.Thread(target=prefetch, args=(i + 1,),
                                     daemon=True)
                t.start()
            if isinstance(mat, Exception):
                raise mat
            yield mat

    def iter_batches(self, **kw) -> Iterator:
        for window in self.iter_windows():
            yield from window.iter_batches(**kw)

    def iter_rows(self) -> Iterator:
        for window in self.iter_windows():
            yield from window.iter_rows()

    def iter_cuda_batches(self, *, batch_size: int = 256, dtype=None,
                          device=None, drop_last: bool = True,
                          prefetch: int = 2, sharding=None):
        """`Dataset.iter_cuda_batches` over the windows in turn (each
        window's batches as that window's own ``iter_batches`` cuts
        them), through one feeder: its staging ring and its `stats`
        span the windows."""
        from ray_tpu_torch.data.dataset import CudaBatchIterator

        return CudaBatchIterator(
            self.iter_batches(batch_size=batch_size, batch_format="numpy",
                              drop_last=drop_last),
            dtype=dtype, device=device, prefetch=prefetch,
            sharding=sharding)

    def take_all(self) -> list:
        out = []
        for window in self.iter_windows():
            out.extend(window.take_all())
        return out

    def count(self) -> int:
        return sum(w.count() for w in self.iter_windows())

    def num_windows(self) -> int:
        return len(self._windows) * self._repeats

    def __repr__(self):
        return (f"DatasetPipeline(windows={len(self._windows)}, "
                f"repeats={self._repeats}, stages={len(self._stages)})")
