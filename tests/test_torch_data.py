"""The port's data plane (ray_tpu_torch.data) against the JAX package's
(ray_tpu.data), case for case.

One parity case for each case of ``tests/test_data.py`` and
``tests/test_data_pipeline.py``: the same construction goes through both
packages, each on its own module-scoped cluster (``num_cpus=4``), and
the results are compared: ``take_all()``, ``count()`` and the aggregates
equal (rows as python values; the port's tensor rows are numpy arrays,
the reference's lists), the shuffle order, the sample and the splits
equal for the same seed, the CSV and JSON columns of the same types. The
reference's own checks (timing of the streaming pool and the window
prefetch, constructions per actor) hold for both. Cases that repeat a
construction with other data are parametrised cases of one test.
"""

import glob
import json as _json
import os
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import data as J
from ray_tpu.core import serialization as jser
from ray_tpu_torch import data as T
from ray_tpu_torch.core import serialization as tser

RUNTIME = {J: ray_tpu, T: ray_tpu_torch}
SERIALIZATION = {J: jser, T: tser}


@pytest.fixture(scope="module")
def clusters():
    ray_tpu.init(num_cpus=4)
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def norm(x):
    """Python values for comparison: arrays and tuples as lists, numpy
    scalars as python ones, recursively."""
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    if isinstance(x, np.ndarray):
        return norm(x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    return x


def same(fn):
    """fn(data module) for both packages → the port's result, after
    asserting it equals the reference's."""
    ref, port = norm(fn(J)), norm(fn(T))
    assert port == ref
    return port


def block_rows(d, ds):
    return [RUNTIME[d].get(r, timeout=60).num_rows for r in ds._block_refs]


# ------------------------------------------- tests/test_data.py, by value

CASES = {
    # test_range_count_take
    "range_count_take": lambda d: (d.range(100).count(),
                                   d.range(100).take(3)),
    # test_from_items_simple_block
    "from_items_simple_block": lambda d: (
        d.from_items([1, 2, 3, 4, 5]).count(),
        d.from_items([1, 2, 3, 4, 5]).take_all()),
    # test_map_and_filter_fused
    "map_and_filter_fused": lambda d: (lambda ds: (len(ds._stages),
                                                   ds.take_all()))(
        d.range(50).map(lambda r: {"id": r["id"] * 2})
        .filter(lambda r: r["id"] % 4 == 0)),
    # test_map_batches_numpy
    "map_batches_numpy": lambda d: d.range(64).map_batches(
        lambda b: {"id": b["id"], "sq": b["id"] ** 2},
        batch_size=16).take_all(),
    # test_flat_map
    "flat_map": lambda d: sorted(r["x"] for r in d.from_items(
        [{"x": 1}, {"x": 2}]).flat_map(
            lambda r: [{"x": r["x"]}, {"x": -r["x"]}]).take_all()),
    # test_aggregates
    "aggregates": lambda d: (lambda ds: (ds.sum("id"), ds.mean("id"),
                                         ds.min("id"), ds.max("id")))(
        d.range(10)),
    # test_repartition
    "repartition": lambda d: (lambda ds: (ds.num_blocks(), ds.count(),
                                          block_rows(d, ds)))(
        d.range(100, parallelism=4).repartition(7).materialize()),
    # test_random_shuffle: the same permutation for the same seed
    "random_shuffle": lambda d: [r["id"] for r in d.range(
        200, parallelism=4).random_shuffle(seed=7).take_all()],
    # test_sort
    "sort": lambda d: (lambda ds: (ds.sort("v").take_all(),
                                   ds.sort("v", descending=True).take_all()))(
        d.from_items([{"v": int(v)} for v in
                      np.random.default_rng(3).permutation(300)],
                     parallelism=4)),
    # test_split_equal: the same rows in each part
    "split_equal": lambda d: [p.take_all() for p in d.range(
        103, parallelism=4).split(4)],
    # test_groupby
    "groupby": lambda d: (lambda ds: (
        ds.groupby("k").count().take_all(),
        ds.groupby("k").sum("v").take_all(),
        ds.groupby("k").mean("v").take_all()))(
        d.from_items([{"k": i % 3, "v": i} for i in range(30)])),
    # test_iter_batches
    "iter_batches": lambda d: (
        list(d.range(100, parallelism=3).iter_batches(batch_size=32)),
        list(d.range(100, parallelism=3).iter_batches(batch_size=32,
                                                      drop_last=True))),
    # test_from_numpy_roundtrip (the port's column is [N, 4] already)
    "from_numpy_roundtrip": lambda d: np.concatenate([
        np.stack(b["data"]) for b in d.from_numpy(
            np.arange(32, dtype=np.float32).reshape(8, 4),
            parallelism=2).iter_batches(batch_size=8)]),
    # test_union
    "union": lambda d: d.range(10).union(d.range(5)).count(),
    # TestStatsAndSizeAwareRepartition::test_target_block_size_repartition
    "target_block_size_repartition": lambda d: (lambda ds: (
        len(ds._block_refs), sorted(int(r["data"]) for r in ds.take_all())))(
        d.from_numpy(np.arange(1024)).repartition(2).repartition(
            target_block_size_bytes=1024).materialize()),
    # TestOpBreadth::test_add_column
    "add_column": lambda d: d.from_items(
        [{"a": i} for i in range(10)], parallelism=3).add_column(
            "b", lambda batch: batch["a"] * 2).take_all(),
    # TestOpBreadth::test_limit_preserves_order_and_slices
    "limit": lambda d: (lambda ds: (ds.limit(7).take_all(),
                                    ds.limit(100).count()))(
        d.from_items([{"a": i} for i in range(20)], parallelism=4)),
    # TestOpBreadth::test_random_sample_deterministic_with_seed
    "random_sample": lambda d: (lambda ds: (
        ds.random_sample(0.3, seed=7).take_all(),
        ds.random_sample(1.0, seed=1).count()))(
        d.from_items([{"a": i} for i in range(200)], parallelism=4)),
    # TestOpBreadth::test_zip_aligns_mismatched_block_boundaries
    "zip_aligns": lambda d: d.from_items(
        [{"x": i} for i in range(12)], parallelism=3).zip(d.from_items(
            [{"y": 100 + i} for i in range(12)], parallelism=4)).take_all(),
    # TestOpBreadth::test_zip_suffixes_colliding_columns
    "zip_suffixes": lambda d: d.from_items(
        [{"x": i} for i in range(6)], parallelism=2).zip(d.from_items(
            [{"x": -i} for i in range(6)], parallelism=2)).take_all(),
    # TestDynamicBlockSplitting::test_small_outputs_do_not_split
    "small_outputs_do_not_split": lambda d: (lambda ds: (
        ds.num_blocks(), ds.count(), ds.take_all()))(
        d.from_items([{"a": i} for i in range(10)], parallelism=2).map(
            lambda r: {"a": r["a"] + 1}).materialize()),
    # TestMoreOpBreadth::test_select_drop_rename
    "select_drop_rename": lambda d: (lambda ds: (
        ds.select_columns(["a", "c"]).take_all(),
        ds.drop_columns(["b"]).take_all(),
        ds.rename_columns({"a": "alpha"}).take_all()))(
        d.from_items([{"a": i, "b": 2 * i, "c": 3 * i} for i in range(8)],
                     parallelism=2)),
    # TestMoreOpBreadth::test_split_at_indices
    "split_at_indices": lambda d: [p.take_all() for p in d.from_items(
        [{"a": i} for i in range(10)], parallelism=3).split_at_indices(
            [3, 7])],
    # TestMoreOpBreadth::test_train_test_split (plain, then shuffled)
    "train_test_split": lambda d: (lambda ds: [
        [p.take_all() for p in ds.train_test_split(0.25)],
        [p.take_all() for p in ds.train_test_split(0.25, shuffle=True,
                                                   seed=3)]])(
        d.from_items([{"a": i} for i in range(20)], parallelism=4)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_result(clusters, case):
    same(CASES[case])


# Constructions each package must refuse, as the reference's tests check.
REFUSALS = {
    # TestStatsAndSizeAwareRepartition::test_repartition_arg_validation
    "repartition_no_arg": (ValueError,
                           lambda d: d.from_items([1, 2, 3]).repartition()),
    "repartition_two_args": (ValueError, lambda d: d.from_items(
        [1, 2, 3]).repartition(4, target_block_size_bytes=100)),
    # TestOpBreadth::test_zip_rejects_count_mismatch
    "zip_count_mismatch": (Exception, lambda d: d.from_items(
        [{"x": i} for i in range(5)]).zip(d.from_items(
            [{"y": i} for i in range(6)])).materialize()),
    # TestMoreOpBreadth: an unknown column, indices out of order
    "select_unknown_column": (Exception, lambda d: d.from_items(
        [{"a": 1}]).select_columns(["nope"]).take_all()),
    "split_at_decreasing_indices": (ValueError, lambda d: d.from_items(
        [{"a": i} for i in range(10)]).split_at_indices([5, 2])),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_same_refusal(clusters, case):
    exc, fn = REFUSALS[case]
    for d in (J, T):
        with pytest.raises(exc):
            fn(d)


def test_push_shuffle_multinode_with_stats(clusters):
    def run(d):
        vals = sorted(r["id"] for r in
                      d.range(500).random_shuffle(seed=7).take_all())
        stats = d.dataset.last_stage_stats()["random_shuffle"]
        again = d.range(300).random_shuffle(seed=1).sort("id").take_all()
        return vals, {k: v for k, v in stats.items() if k != "wall_s"}, again

    vals, stats, again = same(run)
    assert vals == list(range(500))
    assert stats["map_tasks"] > 0 and stats["merge_tasks"] > 0
    assert [r["id"] for r in again] == list(range(300))


def test_iter_tpu_batches_and_iter_cuda_batches_on_the_cpu(clusters):
    ref = [{k: np.asarray(v) for k, v in b.items()}
           for b in J.range(64).iter_tpu_batches(batch_size=16)]
    port = [{k: v.numpy() for k, v in b.items()}
            for b in T.range(64).iter_cuda_batches(batch_size=16,
                                                   device="cpu")]
    assert norm(port) == norm(ref)
    # The column's own int64 (jax without x64 puts int32 on its device).
    assert len(port) == 4 and port[0]["id"].dtype == np.int64


def test_iter_torch_batches(clusters):
    import torch

    ref = list(J.range(40).iter_torch_batches(batch_size=16))
    port = list(T.range(40).iter_torch_batches(batch_size=16))
    assert all(isinstance(b["id"], torch.Tensor) for b in port)
    assert norm([b["id"].tolist() for b in port]) == norm(
        [b["id"].tolist() for b in ref])


def test_read_write_parquet(clusters, tmp_path):
    for i in range(3):
        pq.write_table(pa.table({"a": list(range(i * 10, (i + 1) * 10))}),
                       str(tmp_path / f"part-{i}.parquet"))
    got = same(lambda d: (lambda ds: (ds.count(), ds.sum("a"),
                                      ds.num_blocks(), ds.take_all()))(
        d.read_parquet(str(tmp_path))))
    assert got[:3] == [30, sum(range(30)), 3]


def _schema_dtypes(d, ds):
    """Each column's value type as numpy names it: the reference's arrow
    types as pandas maps them (a list type by its value type), the
    port's dtypes (a tensor column by its element dtype; an object
    column that holds nulls by its other values' type, the port's
    difference: arrow keeps the type beside a null mask)."""
    schema = ds.schema()
    if d is J:
        return {f.name: ("list", np.dtype(f.type.value_type.to_pandas_dtype()))
                if pa.types.is_list(f.type)
                else np.dtype(f.type.to_pandas_dtype()) for f in schema}
    out = {}
    for name, dt in schema.items():
        if dt.subdtype is not None:
            out[name] = ("list", dt.subdtype[0])
        elif dt == object:
            vals = [r[name] for r in ds.take_all() if r[name] is not None]
            types = {np.asarray(v).dtype for v in vals}
            numeric = len(types) == 1 and next(iter(types)).kind in "biuf"
            out[name] = types.pop() if numeric else dt
        else:
            out[name] = dt
    return out


@pytest.mark.parametrize("text", [
    "a,b\n1,2\n3,4\n",                                  # tests/test_data.py
    "i,f,b,s\n1,2.5,true,x\n-3,1e3,False,\"y,z\"\n",
    "i,f\n1,\n,2.0\n"])
def test_read_csv(clusters, tmp_path, text):
    p = tmp_path / "x.csv"
    p.write_text(text)
    same(lambda d: d.read_csv(str(p)).take_all())
    assert _schema_dtypes(T, T.read_csv(str(p))) == _schema_dtypes(
        J, J.read_csv(str(p)))


def test_datasource_plugin_roundtrip(clusters, tmp_path):
    def run(d):
        class SquaresSource(d.Datasource):
            def __init__(self, n):
                self.n = n

            def prepare_read(self, parallelism, **kw):
                per = max(1, self.n // parallelism)
                return [d.ReadTask(lambda lo=s, hi=min(s + per, self.n): (
                    {"x": i, "sq": i * i} for i in range(lo, hi)))
                    for s in range(0, self.n, per)]

        class JsonDirSink(d.Datasource):
            def __init__(self, out_dir):
                self.out_dir = out_dir

            def do_write(self, rows, **kw):
                import uuid

                os.makedirs(self.out_dir, exist_ok=True)
                p = os.path.join(self.out_dir,
                                 f"part-{uuid.uuid4().hex}.json")
                with open(p, "w") as f:
                    for r in rows:
                        f.write(_json.dumps(r) + "\n")
                return len(rows)

        ds = d.read_datasource(SquaresSource(40), parallelism=4)
        out = str(tmp_path / f"sink-{d.__name__}")
        counts = d.write_datasource(ds, JsonDirSink(out))
        rows = []
        for p in glob.glob(os.path.join(out, "*.json")):
            rows += [_json.loads(line) for line in open(p)]
        return (ds.count(), sorted(r["sq"] for r in ds.take_all()),
                sum(counts), sorted(r["x"] for r in rows))

    got = same(run)
    assert got[0] == 40 and got[1][:4] == [0, 1, 4, 9]
    assert got[3] == list(range(40))


def test_stateful_class_constructs_once_per_actor(clusters, tmp_path):
    def run(d):
        marker = str(tmp_path / f"ctor-{d.__name__}")

        class AddModel:
            def __init__(self):
                with open(marker, "a") as f:
                    f.write(f"{os.getpid()}\n")
                self.offset = 100

            def __call__(self, batch):
                return {"x": batch["x"] + self.offset}

        ds = d.from_items([{"x": i} for i in range(64)]).repartition(8)
        out = ds.map_batches(AddModel, compute=d.ActorPoolStrategy(
            min_size=2, max_size=2))
        rows = sorted(r["x"] for r in out.take_all())
        ctors = open(marker).read().splitlines()
        assert 1 <= len(ctors) <= 2, ctors
        return rows

    assert same(run) == [100 + i for i in range(64)]


def test_pool_autoscales_and_function_fn(clusters):
    got = same(lambda d: sorted(d.from_items(list(range(40))).repartition(
        10).map_batches(lambda b: [v * 2 for v in b],
                        compute=d.ActorPoolStrategy(
                            min_size=1, max_size=4,
                            max_tasks_in_flight=1)).take_all()))
    assert got == sorted(v * 2 for v in range(40))


def test_batch_predictor_actor_compute(clusters):
    from ray_tpu import air as jair
    from ray_tpu_torch import air as tair

    def run(d):
        air = jair if d is J else tair

        class Doubler(air.Predictor):
            def __init__(self, factor):
                self.factor = factor

            @classmethod
            def from_checkpoint(cls, ck, **kw):
                return cls(ck.to_dict()["factor"])

            def predict_batch(self, batch):
                return {"y": batch["x"] * self.factor}

        bp = air.BatchPredictor.from_checkpoint(
            air.Checkpoint.from_dict({"factor": 3}), Doubler)
        ds = d.from_items([{"x": i} for i in range(20)]).repartition(4)
        out = bp.predict(ds, compute=d.ActorPoolStrategy(1, 2))
        return sorted(r["y"] for r in out.take_all())

    assert same(run) == [3 * i for i in range(20)]


def test_dataset_stats_surface(clusters):
    for d in (J, T):
        s = (d.from_items([{"x": i} for i in range(100)]).repartition(4)
             .map_batches(lambda b: {"x": b["x"] * 2}).materialize().stats())
        assert "repartition" in s and "map_batches" in s and "blocks" in s
    same(lambda d: [line.split(":")[1] for line in (
        d.from_items([{"x": i} for i in range(100)]).repartition(4)
        .map_batches(lambda b: {"x": b["x"] * 2}).materialize()
        .stats().splitlines()) if line.startswith("Stage")])


def test_expanding_flat_map_splits_blocks(clusters):
    def run(d):
        ctx = d.DataContext.get_current()
        old = ctx.target_max_block_size
        ctx.target_max_block_size = 4096
        try:
            big = d.from_items([{"n": 100}], parallelism=1).flat_map(
                lambda r: [{"v": np.zeros(100)} for _ in range(r["n"])]
            ).materialize()
            sizes = [d.block.size_bytes(b) for b in
                     RUNTIME[d].get(big._block_refs, timeout=120)]
            assert max(sizes) <= 4096 * 2, sizes
            return big.num_blocks(), big.count(), big.take_all()
        finally:
            ctx.target_max_block_size = old

    n_blocks, count, _ = same(run)
    assert n_blocks > 10 and count == 100


def test_results_stream_before_stage_completes(clusters):
    for d in (J, T):
        ser = SERIALIZATION[d]
        rt = RUNTIME[d]

        def make_apply():
            def apply(blk):
                time.sleep(0.8)
                return blk

            return apply

        blocks = [rt.put([{"a": i} for i in range(4)]) for _ in range(6)]
        t0 = time.perf_counter()
        refs = d.compute.run_actor_map(
            ser.pack(make_apply), blocks, d.ActorPoolStrategy(
                min_size=2, max_size=2, max_tasks_in_flight=2))
        ready, _ = rt.wait(refs, num_returns=1, timeout=60)
        t_first = time.perf_counter() - t0
        rt.wait(refs, num_returns=len(refs), timeout=60)
        t_all = time.perf_counter() - t0
        assert len(ready) >= 1
        assert t_all - t_first > 0.5, (d.__name__, t_first, t_all)
        assert rt.get(refs, timeout=60) == [[{"a": i} for i in range(4)]] * 6


def test_many_blocks_bounded_dispatch(clusters):
    for d in (J, T):
        ser = SERIALIZATION[d]
        rt = RUNTIME[d]

        def make_apply():
            return lambda blk: blk

        blocks = [rt.put([0, 1]) for _ in range(1000)]
        t0 = time.perf_counter()
        refs = d.compute.run_actor_map(
            ser.pack(make_apply), blocks, d.ActorPoolStrategy(
                min_size=4, max_size=4, max_tasks_in_flight=4))
        rt.wait(refs, num_returns=len(refs), timeout=300)
        wall = time.perf_counter() - t0
        assert len(refs) == 1000
        assert all(v == [0, 1] for v in rt.get(refs[::250], timeout=60))
        assert wall < 120, (d.__name__, wall)


def test_std_unique_show(clusters, capsys):
    def run(d):
        ds = d.from_items([{"v": float(x)} for x in [1, 1, 2, 2, 3, 3]],
                          parallelism=2)
        ds.show(2)
        return ds.unique("v"), ds.std("v"), capsys.readouterr().out

    unique, std, out = same(run)
    assert unique == [1.0, 2.0, 3.0]
    assert std == pytest.approx(np.std([1, 1, 2, 2, 3, 3], ddof=1))
    assert out.count("\n") == 2


# ----------------------------------- tests/test_data_pipeline.py, by value

def test_parquet_roundtrip(clusters, tmp_path):
    def run(d):
        ds = d.from_items([{"x": i, "y": i * 2.0} for i in range(20)])
        out = str(tmp_path / f"pq-{d.__name__}")
        paths = ds.write_parquet(out)
        back = d.read_parquet(out)
        return (len(paths) == ds.num_blocks(), back.count(),
                sorted(back.take_all(), key=lambda r: r["x"]))

    ok, count, rows = same(run)
    assert ok and count == 20 and rows[7] == {"x": 7, "y": 14.0}


@pytest.mark.parametrize("rows,fmt", [
    ([{"a": i} for i in range(10)], "csv"),
    ([{"a": i, "f": i / 4, "b": i % 2 == 0, "s": f"r,{i}"}
      for i in range(10)], "csv"),
    ([{"s": f"row{i}"} for i in range(6)], "json"),
    ([{"s": f"row{i}", "n": i, "v": [i, i + 1]} for i in range(6)], "json"),
], ids=["csv", "csv_typed", "json", "json_typed"])
def test_text_roundtrip(clusters, tmp_path, rows, fmt):
    """Each package reads back what it wrote, the same rows with the same
    column types; then each reads the other's files alike."""
    def written(d):
        out = str(tmp_path / f"{fmt}-{d.__name__}")
        getattr(d.from_items(rows), f"write_{fmt}")(out)
        return out

    dirs = {d: written(d) for d in (J, T)}
    read = lambda d, path: getattr(d, f"read_{fmt}")(path)  # noqa: E731
    for path in dirs.values():
        got = same(lambda d: sorted(read(d, path).take_all(),
                                    key=lambda r: str(r)))
        assert got == norm(sorted(rows, key=lambda r: str(r)))
        assert _schema_dtypes(T, read(T, path)) == _schema_dtypes(
            J, read(J, path))


def test_to_pandas(clusters):
    got = same(lambda d: sorted(d.from_items(
        [{"v": i} for i in range(5)]).to_pandas()["v"].tolist()))
    assert got == [0, 1, 2, 3, 4]


PIPELINES = {
    "windows_and_transforms": lambda d: (lambda pipe: (
        pipe.num_windows(), sorted(r["id"] for r in pipe.take_all())))(
        d.range(32, parallelism=8).window(blocks_per_window=2).map(
            lambda r: {"id": r["id"] * 10})),
    "repeat_epochs": lambda d: (lambda pipe: (
        pipe.num_windows(), [r["id"] for r in pipe.take_all()]))(
        d.range(8, parallelism=4).window(blocks_per_window=4).repeat(3)),
    "iter_batches_streams_across_windows": lambda d: list(
        d.from_items([{"x": float(i)} for i in range(40)]).window(
            blocks_per_window=1).iter_batches(batch_size=16)),
}


@pytest.mark.parametrize("case", sorted(PIPELINES))
def test_pipeline_same_result(clusters, case):
    same(PIPELINES[case])


def test_window_failure_surfaces(clusters):
    def boom(x):
        raise ValueError("boom")

    for d in (J, T):
        with pytest.raises(Exception):
            d.range(4, parallelism=2).window().map(boom).take_all()


def test_prefetch_overlaps(clusters):
    def slow(r):
        time.sleep(0.5)
        return r

    for d in (J, T):
        pipe = d.range(4, parallelism=4).window(blocks_per_window=1).map(slow)
        t0 = time.monotonic()
        for w in pipe.iter_windows():
            w.take_all()
            time.sleep(0.5)   # consumer work, overlapped with prefetch
        dt = time.monotonic() - t0
        assert dt < 3.5, (d.__name__, dt)
