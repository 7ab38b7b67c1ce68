"""The port's block format (ray_tpu_torch.data.block) against the JAX
package's arrow blocks (ray_tpu.data.block), with no cluster.

Every block function takes the same seeded batches and rows in both
packages and must give the same values: rows through ``to_rows`` (the
port's tensor rows as numpy arrays, the reference's as lists), numpy
batches with the same dtypes (a tensor column against ``np.stack`` of the
reference's object array of rows), the same list-block fallbacks, the
same concatenation, slicing, sorting and key values. Then the port's
rule that it needs neither pyarrow nor pandas: in a subprocess that
blocks both, the package imports, a range → map_batches →
random_shuffle → iter_batches run works, and the pyarrow and pandas
entry points raise ImportError naming the package.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

from ray_tpu.data import block as jB
from ray_tpu_torch.data import block as tB

ROOT = Path(__file__).resolve().parents[1]


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


def column_as_port(col: np.ndarray) -> np.ndarray:
    """A reference numpy column as the port keeps it: an object array of
    equal-shape numeric rows stacked to [N, ...]."""
    if (col.dtype == object and len(col)
            and all(isinstance(r, np.ndarray) and r.dtype.kind in "biuf"
                    for r in col)
            and len({r.shape for r in col}) == 1):
        return np.stack(col)
    return col


def assert_same_block(ref, port):
    assert isinstance(ref, pa.Table) == isinstance(port, tB.TableBlock)
    assert jB.num_rows(ref) == tB.num_rows(port)
    assert norm(jB.to_rows(ref)) == norm(tB.to_rows(port))
    if isinstance(ref, pa.Table):
        assert ref.column_names == port.column_names
        rb, tb = jB.to_batch(ref, "numpy"), tB.to_batch(port, "numpy")
        for k in rb:
            want = column_as_port(rb[k])
            if not len(want) and want.dtype == object:
                assert len(tb[k]) == 0, k   # no rows to type a list column
            elif ref.column(k).null_count:
                # A null: arrow's numpy column is float NaN (numbers) or
                # object; the port keeps None in an object column (the
                # rows, compared above, hold None in both).
                assert tb[k].dtype == object, k
            elif want.dtype == object:
                assert tb[k].dtype == object, k
                assert norm(list(want)) == norm(list(tb[k])), k
            else:
                assert tb[k].dtype == want.dtype, (k, tb[k].dtype,
                                                   want.dtype)
                np.testing.assert_array_equal(tb[k], want)


def seeded_rows(n=12, seed=0):
    rng = np.random.default_rng(seed)
    return [{"i": int(rng.integers(-50, 50)), "f": float(rng.normal()),
             "b": bool(rng.integers(0, 2)), "s": f"w{int(rng.integers(9))}",
             "v": rng.normal(size=3)} for _ in range(n)]


def seeded_batch(n=10, seed=1):
    rng = np.random.default_rng(seed)
    return {"i64": rng.integers(0, 1000, n),
            "i32": rng.integers(0, 1000, n).astype(np.int32),
            "f32": rng.normal(size=n).astype(np.float32),
            "f64": rng.normal(size=n),
            "b": rng.integers(0, 2, n).astype(bool),
            "tok": rng.integers(0, 50257, (n, 9)).astype(np.int32),
            "emb": rng.normal(size=(n, 4)).astype(np.float32),
            "s": np.array([f"s{i}" for i in range(n)])}


# Rows given to build_block: typed tables, and every case where the
# reference's pa.table raises (the list-block fallback), or that is not
# rows of dicts at all.
BUILD_CASES = {
    "seeded": seeded_rows(),
    "ints": [{"id": i} for i in range(5)],
    "int_and_float": [{"x": 1}, {"x": 2.5}],
    "numpy_scalars": [{"x": np.float32(1.5)}, {"x": np.float32(2)}],
    "int32_and_int": [{"x": np.int32(1)}, {"x": 2}],
    "bools_with_none": [{"x": True}, {"x": None}],
    "all_none": [{"x": None}, {"x": None}],
    "ints_with_none": [{"x": 1}, {"x": None}],
    "strings_and_bytes": [{"x": "a"}, {"x": b"b"}],
    "dicts": [{"x": {"k": 1}}, {"x": {"k": 2}}],
    "equal_arrays": [{"v": np.zeros(4)} for _ in range(3)],
    "equal_lists": [{"v": [1, 2]}, {"v": [3, 4]}],
    "ragged_lists": [{"v": [1, 2]}, {"v": [3]}],
    "missing_key": [{"a": 1, "b": 2}, {"a": 3}],
    "extra_key": [{"a": 1}, {"a": 2, "b": 3}],
    "fallback_int_and_str": [{"x": 1}, {"x": "x"}],
    "fallback_int_and_bool": [{"x": 1}, {"x": True}],
    "fallback_float_and_str": [{"x": 1.5}, {"x": "x"}],
    "fallback_array_and_scalar": [{"x": np.zeros(2)}, {"x": 3}],
    "fallback_list_and_str": [{"x": [1, 2]}, {"x": "x"}],
    "fallback_unknown_object": [{"x": object()}, {"x": 1}],
    "simple_ints": [1, 2, 3, 4, 5],
    "simple_mixed": [{"a": 1}, 2],
    "empty": [],
}


@pytest.mark.parametrize("name", sorted(BUILD_CASES))
def test_build_block(name):
    rows = BUILD_CASES[name]
    ref, port = jB.build_block(rows), tB.build_block(rows)
    if name.startswith("fallback") or name.startswith("simple") \
            or name == "empty":
        assert isinstance(ref, list) and isinstance(port, list)
        assert port == list(rows) and port == ref
        return
    if name == "fallback_unknown_object":
        return
    assert_same_block(ref, port)


def test_equal_arrays_stay_one_tensor_column():
    """Rows of one shape, of any rank, stay one [N, ...] column (arrow
    takes no row of rank 2 or more from numpy: the reference raises)."""
    port = tB.build_block([{"v": np.full((2, 3), i, np.int32)}
                           for i in range(4)])
    assert port.columns["v"].shape == (4, 2, 3)
    assert port.columns["v"].dtype == np.int32
    img = np.arange(24, dtype=np.float32).reshape(4, 2, 3)
    with pytest.raises(pa.ArrowInvalid):
        jB.from_batch({"img": img})
    port = tB.from_batch({"img": img})
    np.testing.assert_array_equal(tB.to_batch(port)["img"], img)
    assert [r["img"].shape for r in tB.to_rows(port)] == [(2, 3)] * 4


@pytest.mark.parametrize("cols", [
    ("i64", "i32", "f32", "f64", "b"), ("tok", "emb"), ("s",),
    ("i64", "tok", "s")], ids=["typed", "tensor", "strings", "mixed"])
def test_from_batch_to_batch_numpy(cols):
    batch = {k: v for k, v in seeded_batch().items() if k in cols}
    ref, port = jB.from_batch(batch), tB.from_batch(batch)
    assert_same_block(ref, port)
    out = tB.to_batch(port, "numpy")
    for k in cols:
        want = batch[k].astype(object) if k == "s" else batch[k]
        assert out[k].dtype == want.dtype
        np.testing.assert_array_equal(out[k], want)
        assert not out[k].flags.writeable     # as arrow's zero-copy views


def test_from_batch_list_columns_and_arrays():
    batch = {"a": [1, 2, 3], "b": [[1.0, 2.0]] * 3}
    assert_same_block(jB.from_batch(batch), tB.from_batch(batch))
    arr = np.arange(12, dtype=np.float32).reshape(4, 3)
    ref, port = jB.from_batch(arr), tB.from_batch(arr)
    assert_same_block(ref, port)
    np.testing.assert_array_equal(port.columns["data"], arr)
    flat = np.arange(5)
    assert_same_block(jB.from_batch(flat), tB.from_batch(flat))
    assert tB.from_batch([1, 2]) == jB.from_batch([1, 2]) == [1, 2]


def test_from_batch_refuses_what_the_reference_refuses():
    with pytest.raises(pa.ArrowInvalid):
        jB.from_batch({"a": [1, "x"]})
    with pytest.raises(TypeError):
        tB.from_batch({"a": [1, "x"]})
    with pytest.raises(pa.ArrowInvalid):
        jB.from_batch({"a": [1, 2], "b": [1]})
    with pytest.raises(ValueError):
        tB.from_batch({"a": [1, 2], "b": [1]})
    for b in (jB, tB):
        with pytest.raises(TypeError):
            b.from_batch(3.5)


def test_from_pandas_and_arrow_batches():
    batch = seeded_batch()
    df = pd.DataFrame({k: batch[k] for k in ("i64", "f32", "b", "s")})
    assert_same_block(jB.from_batch(df), tB.from_batch(df))
    t = pa.table({"a": [1, 2, None], "s": ["x", "y", "z"],
                  "v": [[1, 2], [3, 4], [5, 6]]})
    port = tB.from_batch(t)
    assert norm(tB.to_rows(port)) == norm(t.to_pylist())
    assert port.columns["v"].shape == (3, 2)


def test_num_rows_size_bytes_to_rows():
    batch = {k: v for k, v in seeded_batch().items()
             if k in ("i64", "i32", "f32", "f64")}
    ref, port = jB.from_batch(batch), tB.from_batch(batch)
    assert jB.num_rows(ref) == tB.num_rows(port) == 10
    assert jB.size_bytes(ref) == tB.size_bytes(port)
    rows = seeded_rows()
    assert norm(jB.to_rows(jB.build_block(rows))) == norm(
        tB.to_rows(tB.build_block(rows)))
    assert tB.size_bytes([1, 2]) == jB.size_bytes([1, 2])


@pytest.mark.parametrize("start,end", [(0, 0), (0, 4), (3, 10), (9, 10)])
def test_slice_block(start, end):
    batch = seeded_batch()
    ref, port = jB.from_batch(batch), tB.from_batch(batch)
    assert_same_block(jB.slice_block(ref, start, end),
                      tB.slice_block(port, start, end))
    assert tB.slice_block([1, 2, 3], 1, 3) == [2, 3]


def test_concat_blocks_promotes_missing_columns():
    parts = [[{"a": 1, "b": 2.0}], [{"a": 3}], [{"c": "x", "a": 5}]]
    ref = jB.concat_blocks([jB.build_block(p) for p in parts])
    port = tB.concat_blocks([tB.build_block(p) for p in parts])
    assert ref.column_names == port.column_names == ["a", "b", "c"]
    assert norm(jB.to_rows(ref)) == norm(tB.to_rows(port))


def test_concat_blocks_same_types_and_tensors():
    b1, b2 = seeded_batch(seed=2), seeded_batch(n=5, seed=3)
    ref = jB.concat_blocks([jB.from_batch(b1), jB.from_batch(b2)])
    port = tB.concat_blocks([tB.from_batch(b1), tB.from_batch(b2)])
    assert_same_block(ref, port)
    assert port.columns["tok"].shape == (15, 9)


def test_concat_blocks_tables_and_lists_and_refusals():
    mixed = [[{"a": 1}], [], [{"a": 2}]]
    ref = jB.concat_blocks([jB.build_block(m) for m in mixed])
    port = tB.concat_blocks([tB.build_block(m) for m in mixed])
    assert_same_block(ref, port)
    assert tB.concat_blocks([]) == jB.concat_blocks([]) == []
    assert tB.concat_blocks([[1], [2, 3]]) == [1, 2, 3]
    ints, floats = [{"a": 1}], [{"a": 1.5}]
    with pytest.raises(pa.ArrowTypeError):
        jB.concat_blocks([jB.build_block(ints), jB.build_block(floats)])
    with pytest.raises(TypeError):
        tB.concat_blocks([tB.build_block(ints), tB.build_block(floats)])
    ragged = tB.concat_blocks([tB.build_block([{"v": [1, 2]}]),
                               tB.build_block([{"v": [1, 2, 3]}])])
    assert norm(tB.to_rows(ragged)) == [{"v": [1, 2]}, {"v": [1, 2, 3]}]


def test_empty_like():
    batch = seeded_batch()
    port = tB.empty_like(tB.from_batch(batch))
    assert_same_block(jB.empty_like(jB.from_batch(batch)), port)
    assert port.column_names == list(batch)
    assert tB.empty_like([1, 2]) == []


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("key", ["k", "s"])
def test_sort_block_stable_with_ties(key, descending):
    rng = np.random.default_rng(5)
    rows = [{"k": int(rng.integers(0, 4)), "s": f"s{int(rng.integers(3))}",
             "pos": i} for i in range(30)]
    ref = jB.sort_block(jB.build_block(rows), key, descending)
    port = tB.sort_block(tB.build_block(rows), key, descending)
    assert norm(jB.to_rows(ref)) == norm(tB.to_rows(port))
    vals = [3, 1, 2, 1]
    assert tB.sort_block(vals, None, descending) == jB.sort_block(
        vals, None, descending)


def test_key_values():
    rows = seeded_rows()
    for k in ("i", "f", "b"):
        ref = jB.key_values(jB.build_block(rows), k)
        port = tB.key_values(tB.build_block(rows), k)
        assert ref.dtype == port.dtype
        np.testing.assert_array_equal(ref, port)
    np.testing.assert_array_equal(jB.key_values([3, 1], None),
                                  tB.key_values([3, 1], None))
    with pytest.raises(ValueError):
        tB.key_values(tB.build_block(rows), None)


def test_take_keeps_the_order_asked():
    batch = seeded_batch()
    idx = [7, 0, 3, 3]
    port = tB.take(tB.from_batch(batch), idx)
    ref = jB.from_batch(batch).take(idx)
    assert_same_block(ref, port)
    assert tB.take([5, 6, 7], [2, 0]) == [7, 5]


def test_to_batch_pandas_and_arrow():
    batch = {k: v for k, v in seeded_batch().items()
             if k in ("i64", "f32", "b", "s", "tok")}
    ref, port = jB.from_batch(batch), tB.from_batch(batch)
    rdf, tdf = jB.to_batch(ref, "pandas"), tB.to_batch(port, "pandas")
    assert list(rdf.columns) == list(tdf.columns)
    for c in rdf.columns:
        assert norm(list(rdf[c])) == norm(list(tdf[c])), c
    rt, tt = jB.to_batch(ref, "arrow"), tB.to_batch(port, "arrow")
    assert rt.schema == tt.schema
    assert rt.to_pylist() == tt.to_pylist()
    assert tB.to_batch([1, 2], "arrow") == jB.to_batch([1, 2], "arrow")
    np.testing.assert_array_equal(tB.to_batch([1, 2], "numpy"),
                                  jB.to_batch([1, 2], "numpy"))
    for b in (jB, tB):
        with pytest.raises(ValueError):
            b.to_batch(port if b is tB else ref, "torch")


_BLOCKED = r"""
import sys
sys.modules["pyarrow"] = None
sys.modules["pandas"] = None
import numpy as np
import ray_tpu_torch as rt
from ray_tpu_torch import data as rd
assert "torch" not in sys.modules
rt.init(num_cpus=2)
try:
    ds = (rd.range(40, parallelism=4)
          .map_batches(lambda b: {"id": b["id"], "sq": b["id"] ** 2})
          .random_shuffle(seed=3))
    got = sorted((int(i), int(s)) for b in ds.iter_batches(batch_size=16)
                 for i, s in zip(b["id"], b["sq"]))
    assert got == [(i, i * i) for i in range(40)], got
    errors = {}
    for name, call in [
            ("read_parquet", lambda: rd.read_parquet("x.parquet")),
            ("write_parquet", lambda: ds.write_parquet("out")),
            ("from_pandas", lambda: rd.from_pandas(None)),
            ("from_arrow", lambda: rd.from_arrow(None)),
            ("to_pandas", lambda: ds.to_pandas()),
            ("pandas batches", lambda: next(ds.iter_batches(
                batch_format="pandas"))),
            ("arrow batches", lambda: next(ds.iter_batches(
                batch_format="arrow")))]:
        try:
            call()
        except ImportError as e:
            errors[name] = str(e)
    print(sorted(errors))
    for name, msg in errors.items():
        want = "pyarrow" if "parquet" in name or "arrow" in name else "pandas"
        assert want in msg, (name, msg)
    print("mods", sorted(m for m in ("torch", "pyarrow", "pandas")
                         if sys.modules.get(m) is not None))
finally:
    rt.shutdown()
"""


def test_runs_without_pyarrow_or_pandas():
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    res = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = res.stdout.splitlines()
    assert lines[-2] == str(sorted([
        "read_parquet", "write_parquet", "from_pandas", "from_arrow",
        "to_pandas", "pandas batches", "arrow batches"])), res.stdout
    assert lines[-1] == "mods []", res.stdout
