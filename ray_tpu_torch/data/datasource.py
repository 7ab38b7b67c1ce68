"""Datasource plugin API: custom parallel readers/writers.

Counterpart of ``ray_tpu/data/datasource.py`` (parity:
``python/ray/data/datasource/datasource.py``, Datasource.prepare_read →
ReadTask list): a datasource turns its source
into independent READ TASKS, each producing one block on a worker; the
driver only ever holds refs. Symmetric `do_write` for sinks.

```python
class MySource(Datasource):
    def prepare_read(self, parallelism, **kw):
        return [ReadTask(lambda shard=s: rows_for(shard))
                for s in self.shards(parallelism)]

ds = ray_tpu_torch.data.read_datasource(MySource(), parallelism=8)
```
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import ray_tpu_torch as rt
from ray_tpu_torch.data import block as B
from ray_tpu_torch.data.dataset import Dataset


class ReadTask:
    """One independent unit of reading; runs remotely, returns rows."""

    def __init__(self, read_fn: Callable[[], Iterable[Any]],
                 metadata: dict | None = None):
        self.read_fn = read_fn
        self.metadata = metadata or {}

    def __call__(self) -> list:
        return list(self.read_fn())


class Datasource:
    """Interface for pluggable sources/sinks."""

    def prepare_read(self, parallelism: int, **read_args) -> list[ReadTask]:
        raise NotImplementedError

    def do_write(self, rows: list, **write_args) -> Any:
        """Write one block's rows; runs remotely, once per block."""
        raise NotImplementedError


@rt.remote
def _run_read_task(task: ReadTask):
    return B.build_block(task())


@rt.remote
def _run_write_task(ds_blob: bytes, blk, write_args: dict):
    from ray_tpu_torch.core import serialization

    ds: Datasource = serialization.unpack(ds_blob)
    return ds.do_write(B.to_rows(blk), **write_args)


def read_datasource(source: Datasource, *, parallelism: int = 4,
                    **read_args) -> Dataset:
    tasks = source.prepare_read(parallelism, **read_args)
    if not tasks:
        return Dataset([rt.put(B.build_block([]))], [])
    return Dataset([_run_read_task.remote(t) for t in tasks], [])


def write_datasource(ds: Dataset, sink: Datasource, **write_args) -> list:
    """Write every block through the sink; returns per-block results."""
    from ray_tpu_torch.core import serialization

    blob = serialization.pack(sink)
    refs = ds._materialized_refs()
    return rt.get(
        [_run_write_task.remote(blob, r, write_args) for r in refs],
        timeout=600)
