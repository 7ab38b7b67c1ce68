"""Dataset constructors / IO.

Counterpart of ``ray_tpu/data/read_api.py`` (parity:
``python/ray/data/read_api.py``: range, from_items, from_numpy,
from_pandas, from_arrow, read_parquet/csv/json) on the port's block
format. ``from_pandas``, ``from_arrow`` and ``read_parquet`` import
pandas or pyarrow when called and raise ImportError naming the package
where it is not installed. CSV and JSON go through the standard library
(the reference reads both with pyarrow):

- ``read_csv``: the first row names the columns (``csv`` module quoting).
  A column is int64 if every cell is an integer (``[+-]digits`` within
  int64), else float64 if every cell is a decimal or exponent number,
  else bool if every cell is true/false (``true``, ``True``, ``TRUE``
  and the same for false), else str. An empty cell in a column of
  numbers or bools is a null (None, in an object column); in a str
  column it is "".
- ``read_json``: one JSON object per line; the columns are the keys in
  order of first appearance (a missing key is None), typed as
  `block.build_block` types Python values (int → int64, float →
  float64, str, bool; lists of one shape → an [N, ...] column).
"""

from __future__ import annotations

import builtins
import csv
import glob as globlib
import json
import os
import re

import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch.data import block as B
from ray_tpu_torch.data.dataset import Dataset, from_items_local


def from_items(items: list, *, parallelism: int = 4) -> Dataset:
    return from_items_local(items, parallelism)


def range(n: int, *, parallelism: int = 4) -> Dataset:  # noqa: A001
    items = [{"id": i} for i in builtins.range(n)]
    return from_items_local(items, parallelism)


def from_numpy(arr: np.ndarray, *, parallelism: int = 4) -> Dataset:
    chunks = np.array_split(arr, max(1, parallelism))
    refs = [
        rt.put(B.from_batch({"data": c})) for c in chunks if len(c)
    ]
    return Dataset(refs or [rt.put(B.build_block([]))], [])


def from_pandas(df, *, parallelism: int = 4) -> Dataset:
    B.require("pandas", "from_pandas")
    n = max(1, parallelism)
    rows = len(df)
    chunk = (rows + n - 1) // n if rows else 1
    refs = []
    for i in builtins.range(0, rows, chunk):
        refs.append(rt.put(B.from_batch(df.iloc[i:i + chunk])))
    return Dataset(refs or [rt.put(B.build_block([]))], [])


def from_arrow(table) -> Dataset:
    B.require("pyarrow", "from_arrow")
    return Dataset([rt.put(B.from_arrow_table(table))], [])


def _expand_paths(paths: str | list[str], suffix: str) -> list[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(globlib.glob(os.path.join(p, f"*{suffix}"))))
        elif "*" in p:
            out.extend(sorted(globlib.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files found for {paths}")
    return out


_INT = re.compile(r"[+-]?\d+\Z")
_FLOAT = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?\Z")
_BOOL = {"true": True, "True": True, "TRUE": True,
         "false": False, "False": False, "FALSE": False}


def _is_int(cell: str) -> bool:
    return bool(_INT.match(cell)) and -2**63 <= int(cell) < 2**63


def _csv_column(cells: list) -> np.ndarray:
    """A CSV column's cells → its typed column (the module's rule)."""
    present = [c for c in cells if c != ""]
    for test, parse in ((_is_int, int), (_FLOAT.match, float),
                        (_BOOL.__contains__, _BOOL.__getitem__)):
        if present and all(test(c) for c in present):
            return B.column_of([parse(c) if c != "" else None for c in cells])
    return B.object_column(cells)


def read_csv_file(path: str) -> B.TableBlock:
    """One CSV file → a TableBlock, typed by the module's rule."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        return B.TableBlock({})
    names, body = rows[0], rows[1:]
    for i, r in enumerate(body):
        if len(r) != len(names):
            raise ValueError(f"{path}: row {i + 2} has {len(r)} cells, the "
                             f"header {len(names)}")
    return B.TableBlock({name: _csv_column([r[j] for r in body])
                         for j, name in enumerate(names)})


def read_json_file(path: str):
    """One JSON-lines file → a block (a TableBlock, or a list block where
    a key's values mix kinds no typed column holds)."""
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return B.rows_to_table(rows)


@rt.remote
def _read_parquet_task(path):
    pq = B.require("pyarrow.parquet", "read_parquet")
    return B.from_arrow_table(pq.read_table(path))


@rt.remote
def _read_csv_task(path):
    return read_csv_file(path)


@rt.remote
def _read_json_task(path):
    return read_json_file(path)


def read_parquet(paths: str | list[str]) -> Dataset:
    B.require("pyarrow.parquet", "read_parquet")
    files = _expand_paths(paths, ".parquet")
    return Dataset([_read_parquet_task.remote(f) for f in files], [])


def read_csv(paths: str | list[str]) -> Dataset:
    files = _expand_paths(paths, ".csv")
    return Dataset([_read_csv_task.remote(f) for f in files], [])


def read_json(paths: str | list[str]) -> Dataset:
    files = _expand_paths(paths, ".json")
    return Dataset([_read_json_task.remote(f) for f in files], [])
