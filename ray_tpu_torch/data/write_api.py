"""Dataset write APIs: one output file per block, written by tasks.

Counterpart of ``ray_tpu/data/write_api.py`` (parity:
``python/ray/data/dataset.py`` write_parquet/write_csv/write_json over
``data/datasource/file_based_datasource.py``). Parquet goes through
pyarrow, imported when called (ImportError naming it where absent); CSV
and JSON through the standard library. CSV quotes the header and the
strings (``csv.QUOTE_NONNUMERIC``, as arrow's writer quotes them), writes
bools as true/false and a null as an empty cell, and refuses a tensor
column (arrow's writer refuses list columns). JSON writes one object per
row, a tensor row as a list.
"""

from __future__ import annotations

import csv
import json
import os

import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch.data import block as B


def _block_table(blk) -> B.TableBlock:
    if isinstance(blk, B.TableBlock):
        return blk
    # Simple (list) blocks: wrap as a single "value" column.
    return B.TableBlock({"value": B.column_of(list(blk))})


@rt.remote
def _write_parquet_task(blk, path):
    pq = B.require("pyarrow.parquet", "write_parquet")
    pq.write_table(B.to_arrow_table(_block_table(blk)), path)
    return path


def _csv_cell(v):
    if isinstance(v, bool):
        return "true" if v else "false"
    return "" if v is None else v


@rt.remote
def _write_csv_task(blk, path):
    t = _block_table(blk)
    for name, col in t.columns.items():
        if col.ndim > 1:
            raise TypeError(f"write_csv: column {name!r} holds [N, "
                            f"{', '.join(map(str, col.shape[1:]))}] rows")
    with open(path, "w", newline="") as f:
        w = csv.writer(f, quoting=csv.QUOTE_NONNUMERIC)
        w.writerow(t.column_names)
        for row in B.to_rows(t):
            w.writerow([_csv_cell(v) for v in row.values()])
    return path


def _json_default(o):
    if isinstance(o, (np.ndarray, np.generic)):
        return o.tolist()
    return str(o)


@rt.remote
def _write_json_task(blk, path):
    with open(path, "w") as f:
        for row in B.to_rows(blk):
            f.write(json.dumps(row, default=_json_default) + "\n")
    return path


def write_blocks(refs: list, path: str, suffix: str, task) -> list[str]:
    os.makedirs(path, exist_ok=True)
    out_refs = [
        task.remote(ref, os.path.join(path, f"part-{i:05d}.{suffix}"))
        for i, ref in enumerate(refs)
    ]
    return rt.get(out_refs)
