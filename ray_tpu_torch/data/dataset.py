"""Dataset: distributed blocks + lazy plan with stage fusion.

Counterpart of ``ray_tpu/data/dataset.py`` on the port's runtime and
block format (``data/block.py``; parity: ``python/ray/data/
dataset.py:141`` Dataset, ``_internal/plan.py`` lazy ExecutionPlan +
fusion, ``_internal/shuffle_and_partition.py`` shuffle,
``data/dataset.py:1019`` split, ``:2622`` iter_batches), with the
device feeder `iter_cuda_batches` in the place of the reference's
``iter_tpu_batches``: pinned host buffers and non-blocking copies to the
card on a side stream.

Blocks live in the object store as ObjectRefs; every transform is a
remote task over blocks. Consecutive row/batch-level stages are fused
into one task per block (the reference's stage fusion) before execution.
No block task imports torch, pyarrow or pandas: only the torch feeders
(`iter_cuda_batches`, `iter_torch_batches`) import torch, and only the
pandas and arrow formats and files import theirs.
"""

from __future__ import annotations

import builtins
import itertools
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator

import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch.data import block as B


# ---------------------------------------------------------------- stages

@dataclass
class MapStage:
    """block → block, fusable."""

    name: str
    fn: Callable[[Any], Any]
    # Whether this transform can GROW a block (flat_map, map_batches with
    # user batch fns). Gates dynamic block splitting: non-expanding chains
    # (map/filter/add_column) stay fully lazy — no driver-side barrier.
    can_expand: bool = False


@dataclass
class AllToAllStage:
    """list[refs] → list[refs], barrier."""

    name: str
    fn: Callable[[list], list]


@dataclass
class ActorMapStage:
    """block → block on a reusable actor pool (stateful transforms).

    Not fused with task MapStages — the pool is a barrier (ref:
    data/_internal/compute.py ActorPoolStrategy semantics).
    """

    name: str
    ctor_packed: bytes          # unpack() -> make_apply() -> block→block fn
    compute: Any                # ActorPoolStrategy


def _fused_map(fns: list[Callable[[Any], Any]]):
    def apply(blk):
        for f in fns:
            blk = f(blk)
        return blk

    return apply


@rt.remote
def _map_block_task(fn_packed, blk):
    from ray_tpu_torch.core import serialization

    fn = serialization.unpack(fn_packed)
    return fn(blk)


@rt.remote(num_returns="dynamic")
def _map_block_dynamic(fn_packed, target, blk):
    """Fused map with dynamic block splitting: outputs above
    `target` bytes are yielded as row-sliced sub-blocks, so a skewed or
    expanding transform (flat_map) cannot hand downstream workers an
    unboundedly large object (ref: data/context.py:29
    target_max_block_size + dynamic generator returns)."""
    from ray_tpu_torch.core import serialization

    fn = serialization.unpack(fn_packed)
    out = fn(blk)
    size = B.size_bytes(out)
    n = B.num_rows(out)
    if target and size > target and n > 1:
        parts = min(n, -(-size // target))
        step = -(-n // parts)
        for s in range(0, n, step):
            yield B.slice_block(out, s, min(s + step, n))
    else:
        yield out


@rt.remote
def _block_rows_task(blk):
    return B.num_rows(blk)


@rt.remote
def _slice_block_task(blk, start, end):
    return B.slice_block(blk, start, end)


@rt.remote
def _sample_block_task(fraction, seed, index, blk):
    rng = np.random.default_rng(None if seed is None else seed + index)
    n = B.num_rows(blk)
    keep = np.nonzero(rng.random(n) < fraction)[0]
    return B.take(blk, keep)


@rt.remote
def _zip_block_task(blk, spans, *other_blks):
    """Zip `blk` with the row-aligned slice of the other dataset, assembled
    from `other_blks` pieces (spans[i] = (start, end) within other_blks[i])."""
    pieces = [B.slice_block(o, s, e)
              for o, (s, e) in zip(other_blks, spans)]
    other = B.concat_blocks(pieces) if pieces else B.build_block([])
    a = B.to_batch(blk, "numpy")
    b = B.to_batch(other, "numpy")
    if not (isinstance(a, dict) and isinstance(b, dict)):
        raise TypeError("zip() requires tabular (dict-batch) datasets")
    merged = dict(a)
    for k, v in b.items():
        merged[k + "_1" if k in merged else k] = v
    return B.from_batch(merged)


@rt.remote
def _block_size_task(blk):
    return B.size_bytes(blk)


_LAST_STAGE_STATS: dict = {}


def last_stage_stats() -> dict:
    """Per-stage stats of the most recent all-to-all executions (shuffle
    rounds, task counts, wall time) — the reference's DatasetStats analog."""
    return dict(_LAST_STAGE_STATS)


class Dataset:
    def __init__(self, block_refs: list, stages: list | None = None):
        self._block_refs = list(block_refs)
        self._stages: list = stages or []
        self._stats: list[dict] = []   # per-stage execution records

    # ------------------------------------------------------------ plan

    def _with_stage(self, stage) -> "Dataset":
        return Dataset(self._block_refs, self._stages + [stage])

    def materialize(self) -> "Dataset":
        """Execute all pending stages (fusing adjacent map stages)."""
        import time as _time

        from ray_tpu_torch.core import serialization

        stats: list[dict] = list(self._stats)
        refs = self._block_refs
        i = 0
        while i < len(self._stages):
            t0 = _time.perf_counter()
            stage = self._stages[i]
            if isinstance(stage, MapStage):
                fns = []
                names = []
                can_expand = False
                while i < len(self._stages) and isinstance(
                    self._stages[i], MapStage
                ):
                    fns.append(self._stages[i].fn)
                    names.append(self._stages[i].name)
                    can_expand = can_expand or self._stages[i].can_expand
                    i += 1
                packed = serialization.pack(_fused_map(fns))
                from ray_tpu_torch.data.context import DataContext

                ctx = DataContext.get_current()
                # The byte bound applies to ALL map chains (a plain map
                # can inflate bytes row-for-row, e.g. decode/decompress);
                # split_expanding_only trades the bound for full laziness
                # on 1:1 chains (no refs→items resolution step).
                target = (ctx.target_max_block_size
                          if ctx.enable_dynamic_block_splitting
                          and (can_expand or not ctx.split_expanding_only)
                          else 0)
                if target:
                    # Dynamic block splitting: each task may yield several
                    # sub-blocks; resolving the outer generator refs is a
                    # stage barrier (the refs→item-refs indirection), the
                    # price of bounding downstream block sizes.
                    outer = [_map_block_dynamic.remote(packed, target, r)
                             for r in refs]
                    refs = [item for o in outer
                            for item in rt.get(o, timeout=None)]
                else:
                    refs = [_map_block_task.remote(packed, r) for r in refs]
                # Fused map stages without splitting are lazy tasks: charge
                # their wall time when the blocks are consumed.
                name = "+".join(names)
            elif isinstance(stage, ActorMapStage):
                from ray_tpu_torch.data.compute import run_actor_map

                refs = run_actor_map(stage.ctor_packed, refs, stage.compute)
                name = f"{stage.name}[actor_pool]"
                i += 1
            else:
                refs = stage.fn(refs)
                name = stage.name
                i += 1
            stats.append({"stage": name, "blocks": len(refs),
                          "wall_s": round(_time.perf_counter() - t0, 4)})
        out = Dataset(refs, [])
        out._stats = stats
        return out

    def stats(self) -> str:
        """Human-readable per-stage execution summary (the reference's
        DatasetStats surface, `data/_internal/stats.py`): one line per
        executed stage with block count + wall time; shuffle stages add
        their push-shuffle round details from last_stage_stats()."""
        if self._stages:
            return self.materialize().stats()
        if not self._stats:
            return "(no executed stages)"
        lines = [
            f"Stage {i}: {s['stage']}: {s['blocks']} blocks, "
            f"{s['wall_s']}s" for i, s in enumerate(self._stats)
        ]
        extra = last_stage_stats()
        if extra:
            lines.append(f"last all-to-all: {extra}")
        return "\n".join(lines)

    def _materialized_refs(self) -> list:
        return self.materialize()._block_refs if self._stages else self._block_refs

    # ------------------------------------------------------------ transforms

    def map_batches(
        self,
        fn: Callable[[Any], Any],
        *,
        batch_format: str = "numpy",
        batch_size: int | None = None,
        compute: Any = None,
    ) -> "Dataset":
        """Transform batches. `fn` is a function, or — with
        `compute=ActorPoolStrategy(...)` — a callable CLASS constructed once
        per pool actor, so expensive state (model weights, a jitted apply)
        loads per actor, not per block (ref: dataset.py:325 +
        _internal/compute.py:88)."""

        def make_apply():
            user = fn() if isinstance(fn, type) else fn

            def apply(blk):
                n = B.num_rows(blk)
                if n == 0:
                    return blk
                size = batch_size or n
                outs = []
                for s in range(0, n, size):
                    batch = B.to_batch(
                        B.slice_block(blk, s, min(s + size, n)), batch_format)
                    outs.append(B.from_batch(user(batch)))
                return B.concat_blocks(outs)

            return apply

        if compute is not None:
            from ray_tpu_torch.core import serialization
            from ray_tpu_torch.data.compute import ActorPoolStrategy

            if not isinstance(compute, ActorPoolStrategy):
                raise TypeError(
                    f"compute must be an ActorPoolStrategy, got {compute!r}")
            return self._with_stage(ActorMapStage(
                "map_batches", serialization.pack(make_apply), compute))
        if isinstance(fn, type):
            raise ValueError(
                "a callable class requires compute=ActorPoolStrategy(...)")
        return self._with_stage(
            MapStage("map_batches", make_apply(), can_expand=True))

    def map(self, fn: Callable[[Any], Any]) -> "Dataset":
        def apply(blk):
            return B.build_block([fn(r) for r in B.to_rows(blk)])

        return self._with_stage(MapStage("map", apply))

    def flat_map(self, fn: Callable[[Any], Iterable]) -> "Dataset":
        def apply(blk):
            out = []
            for r in B.to_rows(blk):
                out.extend(fn(r))
            return B.build_block(out)

        return self._with_stage(
            MapStage("flat_map", apply, can_expand=True))

    def filter(self, fn: Callable[[Any], bool]) -> "Dataset":
        def apply(blk):
            return B.build_block([r for r in B.to_rows(blk) if fn(r)])

        return self._with_stage(MapStage("filter", apply))

    def add_column(self, name: str, fn: Callable[[Any], Any]) -> "Dataset":
        """Append a column computed from each block's numpy batch
        (ref: dataset.py add_column). Tabular datasets only."""

        def apply(blk):
            batch = B.to_batch(blk, "numpy")
            if not isinstance(batch, dict):
                raise TypeError("add_column() requires a tabular dataset")
            out = dict(batch)
            out[name] = np.asarray(fn(batch))
            return B.from_batch(out)

        return self._with_stage(MapStage(f"add_column({name})", apply))

    def select_columns(self, cols: list) -> "Dataset":
        """Keep only `cols` (ref: dataset.py select_columns)."""
        cols = list(cols)

        def apply(blk):
            batch = B.to_batch(blk, "numpy")
            if not isinstance(batch, dict):
                raise TypeError("select_columns() requires a tabular dataset")
            missing = [c for c in cols if c not in batch]
            if missing:
                raise KeyError(f"unknown columns {missing}")
            return B.from_batch({c: batch[c] for c in cols})

        return self._with_stage(MapStage(f"select_columns({cols})", apply))

    def drop_columns(self, cols: list) -> "Dataset":
        """Remove `cols` (ref: dataset.py drop_columns)."""
        drop = set(cols)

        def apply(blk):
            batch = B.to_batch(blk, "numpy")
            if not isinstance(batch, dict):
                raise TypeError("drop_columns() requires a tabular dataset")
            return B.from_batch(
                {k: v for k, v in batch.items() if k not in drop})

        return self._with_stage(MapStage(f"drop_columns({cols})", apply))

    def rename_columns(self, mapping: dict) -> "Dataset":
        """Rename columns by {old: new} (ref: dataset.py rename_columns)."""
        mapping = dict(mapping)

        def apply(blk):
            batch = B.to_batch(blk, "numpy")
            if not isinstance(batch, dict):
                raise TypeError("rename_columns() requires a tabular dataset")
            out = {mapping.get(k, k): v for k, v in batch.items()}
            if len(out) != len(batch):
                raise ValueError(
                    f"rename_columns mapping {mapping} collides with an "
                    f"existing column (columns: {sorted(batch)})")
            return B.from_batch(out)

        return self._with_stage(MapStage("rename_columns", apply))

    def random_sample(self, fraction: float, *,
                      seed: int | None = None) -> "Dataset":
        """Keep each row independently with probability `fraction`
        (ref: dataset.py random_sample). Per-block RNG streams derive from
        (seed + block index), so a fixed seed is deterministic."""
        if not 0.0 <= fraction <= 1.0:
            raise ValueError("fraction must be in [0, 1]")

        def do(refs):
            return [_sample_block_task.remote(fraction, seed, i, r)
                    for i, r in enumerate(refs)]

        return self._with_stage(AllToAllStage("random_sample", do))

    def limit(self, n: int) -> "Dataset":
        """First `n` rows, preserving order; later blocks are dropped
        without being consumed (ref: dataset.py limit)."""

        def do(refs):
            counts = rt.get(
                [_block_rows_task.remote(r) for r in refs], timeout=600)
            out, acc = [], 0
            for r, c in zip(refs, counts):
                if acc >= n:
                    break
                take = min(c, n - acc)
                out.append(r if take == c
                           else _slice_block_task.remote(r, 0, take))
                acc += take
            return out

        return self._with_stage(AllToAllStage("limit", do))

    def zip(self, other: "Dataset") -> "Dataset":
        """Column-wise zip of two datasets with equal row counts
        (ref: dataset.py zip). Rows pair up positionally; colliding column
        names from `other` get a "_1" suffix. Each output block pulls only
        the row-overlapping blocks of `other`."""

        def do(refs):
            other_refs = other._materialized_refs()
            mine = rt.get(
                [_block_rows_task.remote(r) for r in refs], timeout=600)
            theirs = rt.get(
                [_block_rows_task.remote(r) for r in other_refs],
                timeout=600)
            if sum(mine) != sum(theirs):
                raise ValueError(
                    f"zip() row counts differ: {sum(mine)} vs {sum(theirs)}")
            # Prefix offsets of `other` blocks, for range alignment.
            starts = list(itertools.accumulate([0] + theirs[:-1]))
            out = []
            lo = 0
            for r, c in zip(refs, mine):
                hi = lo + c
                spans, pieces = [], []
                for (o, os, oc) in zip(other_refs, starts, theirs):
                    oe = os + oc
                    if oe <= lo or os >= hi:
                        continue
                    s = max(lo, os) - os
                    e = min(hi, oe) - os
                    spans.append((s, e))
                    pieces.append(o)
                out.append(_zip_block_task.remote(r, spans, *pieces))
                lo = hi
            return out

        return self._with_stage(AllToAllStage("zip", do))

    # ------------------------------------------------------------ all-to-all

    def repartition(self, num_blocks: int | None = None, *,
                    target_block_size_bytes: int | None = None) -> "Dataset":
        """Rebalance into `num_blocks`, or — size-aware — into blocks of
        ~`target_block_size_bytes` each (the reference's block-size-aware
        splitting, `data/context.py target_max_block_size`): total bytes
        are measured remotely and the block count derived, so huge blocks
        split and slivers merge without the caller knowing sizes."""
        if (num_blocks is None) == (target_block_size_bytes is None):
            raise ValueError(
                "pass exactly one of num_blocks / target_block_size_bytes")

        def do(refs):
            n = num_blocks
            if n is None:
                sizes = rt.get(
                    [_block_size_task.remote(r) for r in refs], timeout=600)
                total = sum(sizes)
                n = max(1, round(total / max(target_block_size_bytes, 1)))
            return _repartition(refs, n)

        return self._with_stage(AllToAllStage("repartition", do))

    def random_shuffle(self, *, seed: int | None = None) -> "Dataset":
        """Pipelined push-based shuffle
        (ref: _internal/push_based_shuffle.py:22); per-stage stats land in
        `ray_tpu_torch.data.dataset.last_stage_stats()`."""

        def do(refs):
            return _shuffle(refs, seed, stats_sink=_LAST_STAGE_STATS)

        return self._with_stage(AllToAllStage("random_shuffle", do))

    def sort(self, key: str | None = None, *, descending: bool = False) -> "Dataset":
        def do(refs):
            return _sort(refs, key, descending)

        return self._with_stage(AllToAllStage("sort", do))

    def split(self, n: int, *, locality_hints=None) -> list["Dataset"]:
        """Split into n datasets with equal row counts (±1)
        (ref: dataset.py:1019)."""
        refs = self._materialized_refs()
        counts = rt.get(
            [_count_task.remote(r) for r in refs], timeout=300
        )
        total = sum(counts)
        base, extra = divmod(total, n)
        targets = [base + (1 if i < extra else 0) for i in range(n)]
        # Walk blocks, slicing to fill each target exactly.
        out: list[list] = [[] for _ in range(n)]
        cur = 0
        need = targets[0]
        for ref, cnt in zip(refs, counts):
            offset = 0
            while offset < cnt:
                if need == 0:
                    cur += 1
                    need = targets[cur]
                take = min(cnt - offset, need)
                out[cur].append(
                    _slice_task.remote(ref, offset, offset + take)
                )
                offset += take
                need -= take
        while cur + 1 < n:
            cur += 1
        return [Dataset(refs_i, []) for refs_i in out]

    def split_at_indices(self, indices: list) -> list["Dataset"]:
        """Split at global row indices (ref: dataset.py split_at_indices):
        [3, 7] → rows [0,3), [3,7), [7, N)."""
        idx = list(indices)
        if any(b < a for a, b in zip(idx, idx[1:])) or (idx and idx[0] < 0):
            raise ValueError(f"indices must be non-decreasing ≥ 0: {idx}")
        refs = self._materialized_refs()
        counts = rt.get(
            [_count_task.remote(r) for r in refs], timeout=300)
        total = sum(counts)
        bounds = [0] + [min(i, total) for i in idx] + [total]
        out: list[list] = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            part: list = []
            pos = 0
            for ref, cnt in zip(refs, counts):
                s, e = max(lo - pos, 0), min(hi - pos, cnt)
                if s < e:
                    part.append(ref if (s, e) == (0, cnt)
                                else _slice_task.remote(ref, s, e))
                pos += cnt
            out.append(part)
        return [Dataset(p, []) for p in out]

    def train_test_split(self, test_size: float, *, shuffle: bool = False,
                         seed: int | None = None) -> tuple:
        """→ (train, test) datasets (ref: dataset.py train_test_split).
        test_size is a fraction in (0, 1)."""
        if not 0.0 < test_size < 1.0:
            raise ValueError("test_size must be in (0, 1)")
        ds = self.random_shuffle(seed=seed) if shuffle else self
        # Materialize once: count() and split_at_indices() would otherwise
        # each re-run the pending pipeline (incl. the shuffle all-to-all),
        # and a seedless shuffle would split a DIFFERENT permutation than
        # the one counted.
        ds = ds.materialize()
        total = ds.count()
        cut = total - int(total * test_size)
        train, test = ds.split_at_indices([cut])
        return train, test

    def union(self, other: "Dataset") -> "Dataset":
        return Dataset(
            self._materialized_refs() + other._materialized_refs(), []
        )

    # ------------------------------------------------------------ consumption

    def count(self) -> int:
        refs = self._materialized_refs()
        return sum(rt.get([_count_task.remote(r) for r in refs],
                               timeout=300))

    def take(self, n: int = 20) -> list:
        out = []
        for ref in self._materialized_refs():
            blk = rt.get(ref, timeout=300)
            out.extend(B.to_rows(blk))
            if len(out) >= n:
                break
        return out[:n]

    def take_all(self) -> list:
        out = []
        for ref in self._materialized_refs():
            out.extend(B.to_rows(rt.get(ref, timeout=300)))
        return out

    def sum(self, on: str | None = None):
        vals = self._column_values(on)
        return vals.sum()

    def mean(self, on: str | None = None):
        vals = self._column_values(on)
        return vals.mean()

    def min(self, on: str | None = None):
        return self._column_values(on).min()

    def max(self, on: str | None = None):
        return self._column_values(on).max()

    def std(self, on: str | None = None, ddof: int = 1):
        """Sample standard deviation (ref: dataset.py std)."""
        v = self._column_values(on)
        return float(np.std(v, ddof=ddof))

    def unique(self, on: str | None = None) -> list:
        """Distinct values of a column (ref: dataset.py unique)."""
        return sorted(np.unique(self._column_values(on)).tolist())

    def show(self, n: int = 20) -> None:
        """Print the first n rows (ref: dataset.py show)."""
        for row in self.take(n):
            print(row)

    def _column_values(self, on: str | None) -> np.ndarray:
        parts = []
        for ref in self._materialized_refs():
            blk = rt.get(ref, timeout=300)
            parts.append(B.key_values(blk, on))
        return np.concatenate(parts) if parts else np.array([])

    def num_blocks(self) -> int:
        return len(self._materialized_refs())

    def schema(self):
        """The first block's columns as ``{name: numpy dtype}`` (a tensor
        column's dtype carries its row shape, ``np.dtype((int32,
        (1024,)))``), or a simple block's first value's type (the
        reference returns the arrow schema)."""
        for ref in self._materialized_refs():
            blk = rt.get(ref, timeout=300)
            if isinstance(blk, B.TableBlock):
                return {k: np.dtype((v.dtype, v.shape[1:])) if v.ndim > 1
                        else v.dtype for k, v in blk.columns.items()}
            if len(blk):
                return type(blk[0])
        return None

    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    # ------------------------------------------------------------ iteration

    # ------------------------------------------------------------ io / export

    def write_parquet(self, path: str) -> list:
        """One parquet file per block under `path`
        (ref: data/dataset.py write_parquet)."""
        from ray_tpu_torch.data import write_api

        B.require("pyarrow.parquet", "write_parquet")
        return write_api.write_blocks(
            self._materialized_refs(), path, "parquet",
            write_api._write_parquet_task)

    def write_csv(self, path: str) -> list:
        from ray_tpu_torch.data import write_api

        return write_api.write_blocks(
            self._materialized_refs(), path, "csv",
            write_api._write_csv_task)

    def write_json(self, path: str) -> list:
        from ray_tpu_torch.data import write_api

        return write_api.write_blocks(
            self._materialized_refs(), path, "json",
            write_api._write_json_task)

    def to_pandas(self):
        pd = B.require("pandas", "Dataset.to_pandas")
        rows = self.take_all()
        return pd.DataFrame(rows)

    def window(self, *, blocks_per_window: int = 1):
        """Windowed streaming pipeline (ref: dataset_pipeline.py)."""
        from ray_tpu_torch.data.dataset_pipeline import DatasetPipeline

        return DatasetPipeline.from_dataset(
            self, blocks_per_window=blocks_per_window)

    def repeat(self, times: int):
        return self.window(blocks_per_window=max(1, self.num_blocks())
                           ).repeat(times)

    def iter_rows(self) -> Iterator:
        for ref in self._materialized_refs():
            yield from B.to_rows(rt.get(ref, timeout=300))

    def iter_batches(
        self,
        *,
        batch_size: int = 256,
        batch_format: str = "numpy",
        drop_last: bool = False,
    ) -> Iterator:
        carry = None
        for ref in self._materialized_refs():
            blk = rt.get(ref, timeout=300)
            if carry is not None:
                blk = B.concat_blocks([carry, blk])
                carry = None
            n = B.num_rows(blk)
            s = 0
            while n - s >= batch_size:
                yield B.to_batch(B.slice_block(blk, s, s + batch_size),
                                 batch_format)
                s += batch_size
            if s < n:
                carry = B.slice_block(blk, s, n)
        if carry is not None and not drop_last:
            yield B.to_batch(carry, batch_format)

    def iter_torch_batches(self, *, batch_size: int = 256,
                           drop_last: bool = False,
                           device: str = "cpu") -> Iterator:
        """Torch-tensor batches (ref: dataset.py:2833 to_torch /
        iter_torch_batches) — CPU-torch interop for preprocessing or
        torch-based models riding this data plane."""
        import torch

        def to_tensor(name, v):
            arr = np.asarray(v)
            if arr.dtype == object:
                raise TypeError(
                    f"column {name!r} has non-numeric rows (dtype=object); "
                    "torch tensors need numeric columns — map/encode it "
                    "first")
            # Copy read-only views: ascontiguousarray alone passes a
            # CONTIGUOUS read-only (mmap/arrow-backed) array through
            # untouched, and wrapping it zero-copy yields tensors whose
            # in-place ops are undefined behavior (torch warns).
            arr = np.ascontiguousarray(arr)
            if not arr.flags.writeable:
                arr = arr.copy()
            return torch.as_tensor(arr, device=device)

        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy",
                                       drop_last=drop_last):
            if isinstance(batch, dict):
                yield {k: to_tensor(k, v) for k, v in batch.items()}
            else:
                yield to_tensor("<array>", batch)

    def iter_cuda_batches(
        self,
        *,
        batch_size: int = 256,
        dtype=None,
        device=None,
        drop_last: bool = True,
        prefetch: int = 2,
        sharding=None,
    ) -> "CudaBatchIterator":
        """Batches as torch tensors on the card, the next ``prefetch``
        staged and copied while the current one computes: the port's
        ``iter_tpu_batches`` (``ray_tpu/data/dataset.py:744``). See
        `CudaBatchIterator` for the staging, the devices and
        ``sharding``."""
        return CudaBatchIterator(
            self.iter_batches(batch_size=batch_size, batch_format="numpy",
                              drop_last=drop_last),
            dtype=dtype, device=device, prefetch=prefetch,
            sharding=sharding)

    def __repr__(self):
        pending = "+".join(s.name for s in self._stages) or "materialized"
        return f"Dataset(blocks={len(self._block_refs)}, plan={pending})"


class CudaBatchIterator:
    """The device feeder of `Dataset.iter_cuda_batches` and
    `DatasetPipeline.iter_cuda_batches`: iterates ``batches`` (numpy
    batches, dict or array) as torch tensors on ``device``.

    - ``device``: None is cuda (raises without a GPU, as every entry
      point of the port), ``"cpu"`` the CPU.
    - ``dtype``: a torch or numpy dtype every column is cast to, or None
      to keep the column's.
    - ``sharding``: None, or the port's batch sharding of a process mesh
      (``parallel/mesh.py::batch_sharding(mesh)``): each batch is the
      global batch and this rank copies only its rows
      (``Sharding.bounds`` on dimension 0), to the sharding's device.
      Any other value raises.
    - On the card each column is staged into pinned host buffers, a ring
      of ``prefetch + 1`` per column (a slot's buffer grows to the
      largest batch it has held, so a ragged last batch takes a view of
      it and pins nothing new), and copied with
      ``copy_(non_blocking=True)`` on a side stream. A slot is refilled
      only once the copy that read it has finished (a start and an end
      event per slot); the consumer's current stream waits on a batch's
      copies before it is yielded, and each yielded tensor is
      ``record_stream``'d on that stream. A slot's copy time is folded
      into a running sum, and its events dropped, when the slot is
      reused or `stats` reads it, so the feeder holds at most
      ``prefetch + 1`` event pairs a column however long it runs. A
      failure to pin or to copy raises: there is no pageable fallback.
    - On the CPU: the dtype cast and ``torch.from_numpy``, no streams and
      no pinning.

    `stats` counts what it moved: batches, copies and pinned copies,
    bytes copied, the consumer's wait in ``__next__`` (host seconds) and,
    on the card, the copies' device time."""

    def __init__(self, batches, *, dtype=None, device=None, prefetch=2,
                 sharding=None):
        import torch

        from ray_tpu_torch._device import resolve_device
        from ray_tpu_torch.parallel.mesh import Sharding

        if sharding is not None:
            if not isinstance(sharding, Sharding):
                raise TypeError(
                    "sharding must be the port's batch sharding "
                    "(parallel/mesh.py batch_sharding(mesh)), got "
                    f"{sharding!r}")
            dims = [split.dim for split in sharding.splits]
            if dims not in ([], [0]):
                raise ValueError("a batch sharding splits dimension 0, "
                                 f"this one splits {dims}")
            if device is not None and (torch.device(device).type
                                       != sharding.device.type):
                raise ValueError(f"device {device} is not the sharding's "
                                 f"{sharding.device}")
            device = sharding.device
        if prefetch < 0:
            raise ValueError(f"prefetch must be >= 0, got {prefetch}")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.dtype = _torch_dtype(dtype)
        self.sharding = sharding
        self.prefetch = prefetch
        self._batches = iter(batches)
        self._staged: list = []       # (out, [tensors], [done events])
        self._rings: dict = {}        # (name, dtype) → [_Slot]
        self._turn: dict = {}         # (name, dtype) → next slot
        self._copy_ms = 0.0           # device ms of the copies folded in
        self._stream = (torch.cuda.Stream(dev) if dev.type == "cuda"
                        else None)
        self._stats = {"batches": 0, "copies": 0, "pinned_copies": 0,
                       "bytes_copied": 0, "wait_s": 0.0}

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        try:
            while len(self._staged) <= self.prefetch:
                batch = next(self._batches, None)
                if batch is None:
                    break
                self._staged.append(self._stage(batch))
            if not self._staged:
                raise StopIteration
            out, tensors, done = self._staged.pop(0)
            if self._stream is not None:
                import torch

                consumer = torch.cuda.current_stream(self.device)
                for ev in done:
                    consumer.wait_event(ev)
                for t in tensors:
                    t.record_stream(consumer)
            self._stats["batches"] += 1
            return out
        finally:
            self._stats["wait_s"] += time.perf_counter() - t0

    def stats(self) -> dict:
        """The counters; on the card also the copies' device ms and the
        rate of the bytes copied over it (it waits for every copy)."""
        out = dict(self._stats)
        if self._stream is not None:
            for ring in self._rings.values():
                for slot in ring:
                    self._fold(slot)
            ms = self._copy_ms
            out["copy_device_ms"] = ms
            out["h2d_gb_s"] = (out["bytes_copied"] / (ms * 1e-3) / 1e9
                               if ms else None)
        return out

    def _stage(self, batch):
        names = batch if isinstance(batch, dict) else {None: batch}
        out, tensors, done = {}, [], []
        for name, v in names.items():
            arr = np.asarray(v)
            if arr.dtype == object:
                raise TypeError(
                    f"column {name!r} has non-numeric rows (dtype=object); "
                    "tensors need numeric columns — map/encode it first")
            if self.sharding is not None and self.sharding.splits:
                start, stop = self.sharding.bounds(arr.shape)[0]
                arr = arr[start:stop]
            if self._stream is None:
                out[name] = _cpu_tensor(arr, self.dtype)
            else:
                out[name], ev = self._copy(name, arr)
                tensors.append(out[name])
                done.append(ev)
        return (out if isinstance(batch, dict) else out[None]), tensors, done

    def _copy(self, name, arr):
        """Stage ``arr`` into its ring's next pinned slot and copy it to
        the card on the side stream → (device tensor, the copy's event)."""
        import torch

        dtype = self.dtype or _torch_dtype(arr.dtype)
        key = (name, dtype)
        ring = self._rings.get(key)
        if ring is None:
            ring = self._rings[key] = [_Slot()
                                       for _ in range(self.prefetch + 1)]
            self._turn[key] = 0
        slot = ring[self._turn[key]]
        self._turn[key] = (self._turn[key] + 1) % len(ring)
        self._fold(slot)                # waits for the copy that last read it
        if slot.host is None or slot.host.numel() < arr.size:
            slot.host = torch.empty(arr.size, dtype=dtype, pin_memory=True)
        if not slot.host.is_pinned():
            raise RuntimeError("a staging buffer is not pinned")
        host = slot.host[:arr.size].view(arr.shape)
        _fill(host, arr)
        slot.start = torch.cuda.Event(enable_timing=True)
        slot.done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self._stream):
            dev_t = torch.empty(arr.shape, dtype=dtype, device=self.device)
            slot.start.record(self._stream)
            dev_t.copy_(host, non_blocking=True)
            slot.done.record(self._stream)
        self._stats["copies"] += 1
        self._stats["pinned_copies"] += 1
        self._stats["bytes_copied"] += dev_t.numel() * dev_t.element_size()
        return dev_t, slot.done

    def _fold(self, slot):
        """Wait for the copy that last read ``slot``, add its device ms
        to the running sum and drop its events."""
        if slot.done is None:
            return
        slot.done.synchronize()
        self._copy_ms += slot.start.elapsed_time(slot.done)
        slot.start = slot.done = None


class _Slot:
    """One pinned staging buffer (flat, as large as the largest batch
    it has held) and the start and end events of the copy that last read
    it, until they are folded."""

    __slots__ = ("host", "start", "done")

    def __init__(self):
        self.host = self.start = self.done = None


def _torch_dtype(dtype):
    """A torch dtype, a numpy dtype (or its name) or None → torch dtype
    or None."""
    import torch

    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def _numpy_dtype(dtype):
    """The numpy twin of a torch dtype, None where numpy has none."""
    import torch

    try:
        return torch.empty(0, dtype=dtype).numpy().dtype
    except TypeError:                 # bfloat16
        return None


def _fill(host, arr: np.ndarray) -> None:
    """Copy (and cast) ``arr`` into the pinned tensor ``host``."""
    import torch

    np_dtype = _numpy_dtype(host.dtype)
    if np_dtype is not None:
        np.copyto(host.numpy(), arr, casting="unsafe")
    else:
        host.copy_(torch.from_numpy(np.array(arr)))


def _cpu_tensor(arr: np.ndarray, dtype):
    """A CPU tensor owning a copy of ``arr``, cast to ``dtype``."""
    import torch

    np_dtype = None if dtype is None else _numpy_dtype(dtype)
    t = torch.from_numpy(np.array(arr, dtype=np_dtype))
    return t if dtype is None else t.to(dtype)


class GroupedData:
    """Parity: dataset.py:1478 groupby → aggregations."""

    def __init__(self, ds: Dataset, key: str):
        self.ds = ds
        self.key = key

    def _groups(self) -> dict:
        groups: dict = {}
        for row in self.ds.iter_rows():
            groups.setdefault(row[self.key], []).append(row)
        return groups

    def count(self) -> Dataset:
        rows = [
            {self.key: k, "count": len(v)} for k, v in self._groups().items()
        ]
        return from_items_local(rows)

    def sum(self, on: str) -> Dataset:
        rows = [
            {self.key: k, f"sum({on})": builtins.sum(r[on] for r in v)}
            for k, v in self._groups().items()
        ]
        return from_items_local(rows)

    def mean(self, on: str) -> Dataset:
        rows = [
            {self.key: k,
             f"mean({on})": builtins.sum(r[on] for r in v) / len(v)}
            for k, v in self._groups().items()
        ]
        return from_items_local(rows)

    def map_groups(self, fn) -> Dataset:
        rows = []
        for _, v in self._groups().items():
            out = fn(v)
            rows.extend(out if isinstance(out, list) else [out])
        return from_items_local(rows)


# ---------------------------------------------------------------- helper tasks

@rt.remote
def _count_task(blk):
    from ray_tpu_torch.data import block as B

    return B.num_rows(blk)


@rt.remote
def _slice_task(blk, start, end):
    from ray_tpu_torch.data import block as B

    return B.slice_block(blk, start, end)


@rt.remote
def _partition_task(blk, n, seed):
    """Map phase of shuffle: split a block into n random partitions (the
    reference's draws; each partition keeps its rows' order)."""
    from ray_tpu_torch.data import block as B

    rng = np.random.default_rng(seed)
    assign = rng.integers(0, n, B.num_rows(blk))
    return tuple(B.take(blk, np.nonzero(assign == a)[0]) for a in range(n))


@rt.remote
def _merge_task(*blks):
    from ray_tpu_torch.data import block as B

    out = B.concat_blocks(list(blks))
    return out


@rt.remote
def _shuffle_rows_task(blk, seed):
    """The reference's ``rng.shuffle(rows)``: the same seed's permutation
    of the same row count (Generator.shuffle and permutation draw alike)."""
    from ray_tpu_torch.data import block as B

    rng = np.random.default_rng(seed)
    return B.take(blk, rng.permutation(B.num_rows(blk)))


@rt.remote
def _sort_block_task(blk, key, descending):
    from ray_tpu_torch.data import block as B

    return B.sort_block(blk, key, descending)


@rt.remote
def _range_partition_task(blk, key, bounds):
    """Partition a sorted block by range bounds (for distributed sort)."""
    from ray_tpu_torch.data import block as B

    vals = B.key_values(blk, key)
    idx = np.searchsorted(vals, bounds, side="right")
    parts = []
    prev = 0
    for i in list(idx) + [B.num_rows(blk)]:
        parts.append(B.slice_block(blk, int(prev), int(i)))
        prev = i
    return tuple(parts)


def _repartition(refs: list, num_blocks: int) -> list:
    rows_per = rt.get([_count_task.remote(r) for r in refs], timeout=300)
    total = sum(rows_per)
    base, extra = divmod(total, num_blocks)
    targets = [base + (1 if i < extra else 0) for i in range(num_blocks)]
    slices: list[list] = [[] for _ in range(num_blocks)]
    cur, need = 0, targets[0] if targets else 0
    for ref, cnt in zip(refs, rows_per):
        offset = 0
        while offset < cnt:
            if need == 0 and cur + 1 < num_blocks:
                cur += 1
                need = targets[cur]
            take = min(cnt - offset, need) if need else cnt - offset
            slices[cur].append(_slice_task.remote(ref, offset, offset + take))
            offset += take
            need -= take
    return [
        _merge_task.remote(*s) if s else rt.put(B.build_block([]))
        for s in slices
    ]


def _shuffle(refs: list, seed: int | None, stats_sink: dict | None = None) -> list:
    """Push-based two-phase shuffle (ref: push_based_shuffle.py:22):
    pipelined map rounds → node-affine merges → per-partition row shuffle."""
    from ray_tpu_torch.data.shuffle import ShuffleStats, push_based_shuffle

    n = max(1, len(refs))
    seeds = np.random.default_rng(seed).integers(0, 2**31, len(refs) + n)
    st = ShuffleStats()
    merged = push_based_shuffle(
        refs, n, _partition_task, _merge_task,
        partition_args=lambda i, r: (r, n, int(seeds[i])),
        stats=st,
    )
    if stats_sink is not None:
        stats_sink["random_shuffle"] = st.summary()
    return [
        _shuffle_rows_task.remote(m, int(s))
        for m, s in zip(merged, seeds[len(refs):])
    ]


def _sort(refs: list, key: str | None, descending: bool) -> list:
    if not refs:
        return refs
    # Sample bounds, sort each block, range-partition, merge-sort partitions.
    n = len(refs)
    sorted_refs = [_sort_block_task.remote(r, key, False) for r in refs]
    if n == 1:
        out = sorted_refs
    else:
        samples = []
        for blk in rt.get(sorted_refs, timeout=300):
            samples.extend(B.key_values(blk, key))
        samples = np.sort(np.asarray(samples))
        bounds = [
            samples[int(len(samples) * (i + 1) / n)]
            for i in range(n - 1)
        ] if len(samples) else []
        from ray_tpu_torch.data.shuffle import push_based_shuffle

        merged = push_based_shuffle(
            sorted_refs, n, _range_partition_task, _merge_task,
            partition_args=lambda i, r: (r, key, bounds),
        )
        out = [_sort_block_task.remote(m, key, False) for m in merged]
    if descending:
        out = [_sort_block_task.remote(r, key, True) for r in reversed(out)]
    return out


def from_items_local(items: list, parallelism: int = 4) -> Dataset:
    """Driver-side constructor (used by read_api and groupby results)."""
    n = max(1, min(parallelism, len(items) or 1))
    chunk = (len(items) + n - 1) // n if items else 0
    refs = []
    for i in range(0, len(items), chunk or 1):
        refs.append(rt.put(B.build_block(items[i:i + chunk])))
        if not items:
            break
    if not refs:
        refs = [rt.put(B.build_block([]))]
    return Dataset(refs, [])
