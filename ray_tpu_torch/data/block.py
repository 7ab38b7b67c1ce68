"""Block accessors on a columnar block format of the port's own.

Counterpart of ``ray_tpu/data/block.py`` (parity:
``python/ray/data/block.py`` + ``_internal/arrow_block.py`` /
``simple_block.py``). The reference keeps a tabular block as a
``pyarrow.Table``; the port keeps it as a `TableBlock`, an ordered
``name → numpy array`` map whose columns all have one length, so no
worker and no driver needs pyarrow or pandas:

- numbers and bools stay typed, with the dtypes arrow infers from the
  same Python values (int64, float64, bool; numpy scalars keep theirs);
- a multi-dimensional column stays one ``[N, ...]`` array (arrow makes
  it a list column, which ``to_batch(..., "numpy")`` returns as a 1-D
  object array of row arrays), and `to_rows` gives its rows as numpy
  arrays (arrow: lists);
- strings, bytes, dicts, ragged sequences and any column holding None
  are object arrays, as arrow's ``to_numpy(zero_copy_only=False)``
  gives them; a null stays None.

A simple block stays a python ``list``. `build_block` falls back to a
list block where ``pa.table`` raises: a column whose values mix kinds
arrow cannot unify (a number and a string, an int and a bool, a
sequence and a scalar) or hold a value arrow does not know.

Batches surface as ``dict[str, np.ndarray]`` ("numpy", the device feed's
format) or, when asked for, pandas ("pandas") and pyarrow ("arrow"):
those two import their package at the call and raise ImportError naming
it where it is not installed. Importing this module imports numpy only.
"""

from __future__ import annotations

import importlib
import sys
from typing import Any

import numpy as np

Block = Any  # TableBlock | list


class TableBlock:
    """A tabular block: ``columns`` maps each name, in order, to a numpy
    array whose first dimension is the block's ``num_rows``."""

    __slots__ = ("columns", "num_rows")

    def __init__(self, columns: dict):
        cols = dict(columns)
        lengths = {len(v) for v in cols.values()}
        if len(lengths) > 1:
            raise ValueError("columns of different lengths: "
                             f"{ {k: len(v) for k, v in cols.items()} }")
        self.columns = cols
        self.num_rows = lengths.pop() if lengths else 0

    @property
    def column_names(self) -> list:
        return list(self.columns)

    @property
    def nbytes(self) -> int:
        return sum(_col_nbytes(v) for v in self.columns.values())

    def slice(self, start: int, end: int) -> "TableBlock":
        return TableBlock({k: v[start:end] for k, v in self.columns.items()})

    def take(self, indices) -> "TableBlock":
        idx = np.asarray(indices, dtype=np.int64)
        return TableBlock({k: v[idx] for k, v in self.columns.items()})

    def __repr__(self):
        cols = ", ".join(f"{k}: {v.dtype}{list(v.shape[1:]) or ''}"
                         for k, v in self.columns.items())
        return f"TableBlock({self.num_rows} rows; {cols})"


class _Unconvertible(Exception):
    """A column's values mix kinds that one typed column cannot hold
    (where ``pa.table`` raises ArrowInvalid or ArrowTypeError)."""


def _kind(v) -> str | None:
    if v is None:
        return "none"
    if isinstance(v, (bool, np.bool_)):
        return "bool"
    if isinstance(v, (int, np.integer)):
        return "int"
    if isinstance(v, (float, np.floating)):
        return "float"
    if isinstance(v, (str, bytes, np.str_, np.bytes_)):
        return "str"
    if isinstance(v, (list, tuple, np.ndarray)):
        return "seq"
    if isinstance(v, dict):
        return "dict"
    return None


def object_column(values) -> np.ndarray:
    """Values → a 1-D object array (numpy scalars as python ones)."""
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v.item() if isinstance(v, np.generic) else v
    return out


def _row_array(v):
    try:
        return np.asarray(v)
    except ValueError:          # ragged nesting: keep the value itself
        return v


def column_of(values: list) -> np.ndarray:
    """Python values of one column → its array, typed as arrow types
    them; `_Unconvertible` where arrow raises."""
    kinds = {_kind(v) for v in values}
    if None in kinds:
        raise _Unconvertible("a value of no known kind")
    has_null = "none" in kinds
    kinds.discard("none")
    if len(kinds) > 1 and kinds != {"int", "float"}:
        raise _Unconvertible(f"values of kinds {sorted(kinds)}")
    if kinds == {"str"} and any(isinstance(v, (bytes, np.bytes_))
                                for v in values):
        # str beside bytes: arrow makes the column binary
        return object_column([v.encode() if isinstance(v, str) else v
                              for v in values])
    if not kinds or has_null or kinds & {"str", "dict"}:
        return object_column(values)
    if kinds == {"seq"}:
        rows = [_row_array(v) for v in values]
        if (all(isinstance(r, np.ndarray) and r.dtype.kind in "biuf"
                for r in rows) and len({r.shape for r in rows}) == 1):
            return np.stack(rows)
        return object_column(rows)
    arr = np.asarray(values)
    if kinds == {"bool"}:
        return arr.astype(bool)
    if kinds == {"int"}:
        if arr.dtype.kind not in "iu":
            raise _Unconvertible("an int beyond 64 bits")
        return arr
    return arr if arr.dtype.kind == "f" else arr.astype(np.float64)


def _as_column(v) -> np.ndarray:
    """A batch's column (list, array, array-like) → a block column."""
    if isinstance(v, list):
        return column_of(v)
    arr = np.asarray(v)
    if arr.ndim == 0:
        raise ValueError("a batch column needs one value per row, got a "
                         f"scalar {arr!r}")
    if arr.dtype.kind in "US":
        return arr.astype(object)
    if arr.dtype == object and arr.ndim == 1:
        try:
            return column_of(list(arr))
        except _Unconvertible:
            return arr
    return arr


def _col_nbytes(a: np.ndarray) -> int:
    if a.dtype != object:
        return a.nbytes
    return sum(x.nbytes if isinstance(x, np.ndarray) else sys.getsizeof(x)
               for x in a)


def _row_values(a: np.ndarray) -> list:
    """Per-row python values of a column: scalars for a 1-D typed column
    (as arrow's to_pylist), row arrays (copies) for an [N, ...] one, the
    stored objects for an object column."""
    if a.dtype == object:
        return list(a)
    if a.ndim == 1:
        return a.tolist()
    return [np.array(r) for r in a]


def _readonly(a: np.ndarray) -> np.ndarray:
    view = a.view()
    view.flags.writeable = False
    return view


def require(module: str, what: str):
    """Import ``module`` for ``what``, or raise ImportError naming it."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(
            f"{what} needs {module.split('.')[0]}, which is not installed "
            "(the port's blocks are numpy columns; only this format or "
            "file type needs it)") from e


# ---------------------------------------------------------------- building

def build_block(rows: list) -> Block:
    """Rows of dicts → a TableBlock (columns named by the first row, as
    the reference builds ``pa.table`` from it); anything else, or rows
    whose columns no typed array can hold, → a simple list block."""
    if rows and all(isinstance(r, dict) for r in rows):
        try:
            return TableBlock({k: column_of([r.get(k) for r in rows])
                               for k in rows[0]})
        except _Unconvertible:
            return list(rows)
    return list(rows)


def rows_to_table(rows: list) -> Block:
    """Rows of dicts whose keys may differ from row to row (JSON lines)
    → columns named in order of first appearance, a missing key None."""
    keys: dict = {}
    for r in rows:
        keys.update(dict.fromkeys(r))
    try:
        return TableBlock({k: column_of([r.get(k) for r in rows])
                           for k in keys})
    except _Unconvertible:
        return list(rows)


def from_arrow_table(table) -> TableBlock:
    """A pyarrow Table → a TableBlock (the caller imported pyarrow)."""
    import pyarrow as pa

    cols = {}
    for name in table.column_names:
        col = table.column(name)
        t = col.type
        if (pa.types.is_list(t) or pa.types.is_large_list(t)
                or pa.types.is_fixed_size_list(t) or col.null_count):
            try:
                cols[name] = column_of(col.to_pylist())
            except _Unconvertible:
                cols[name] = object_column(col.to_pylist())
        else:
            cols[name] = _as_column(col.to_numpy(zero_copy_only=False))
    return TableBlock(cols)


def from_batch(batch: Any) -> Block:
    """A user-returned batch → block."""
    if isinstance(batch, TableBlock):
        return batch
    if isinstance(batch, dict):
        cols = {}
        for k, v in batch.items():
            try:
                cols[k] = _as_column(v)
            except _Unconvertible as e:
                raise TypeError(f"batch column {k!r}: {e}") from None
        return TableBlock(cols)
    # A DataFrame or an arrow Table can only exist if its package is
    # loaded: look, never import.
    pd = sys.modules.get("pandas")
    if pd is not None and isinstance(batch, pd.DataFrame):
        return TableBlock({str(c): _as_column(batch[c].to_numpy())
                           for c in batch.columns})
    pa = sys.modules.get("pyarrow")
    if pa is not None and isinstance(batch, pa.Table):
        return from_arrow_table(batch)
    if isinstance(batch, list):
        return build_block(batch)
    if isinstance(batch, np.ndarray):
        return TableBlock({"data": _as_column(batch)})
    raise TypeError(f"cannot convert {type(batch)} to a block")


# ---------------------------------------------------------------- reading

def num_rows(block: Block) -> int:
    if isinstance(block, TableBlock):
        return block.num_rows
    return len(block)


def size_bytes(block: Block) -> int:
    if isinstance(block, TableBlock):
        return block.nbytes
    return sum(sys.getsizeof(x) for x in block)


def to_rows(block: Block) -> list:
    if isinstance(block, TableBlock):
        names = block.column_names
        if not names:
            return []
        cols = [_row_values(block.columns[n]) for n in names]
        return [dict(zip(names, vals)) for vals in zip(*cols)]
    return list(block)


def to_arrow_table(block: TableBlock):
    """A TableBlock → a pyarrow Table (tensor and object columns as
    arrow infers them from their rows)."""
    pa = require("pyarrow", 'batch_format="arrow"')
    return pa.table({k: pa.array(v if v.ndim == 1 and v.dtype != object
                                 else list(v))
                     for k, v in block.columns.items()})


def to_batch(block: Block, batch_format: str = "numpy") -> Any:
    if batch_format == "arrow":
        t = block if isinstance(block, TableBlock) else from_batch(block)
        return to_arrow_table(t) if isinstance(t, TableBlock) else t
    if batch_format == "pandas":
        pd = require("pandas", 'batch_format="pandas"')
        t = block if isinstance(block, TableBlock) else from_batch(block)
        if not isinstance(t, TableBlock):
            raise TypeError("a simple block has no pandas form")
        return pd.DataFrame({k: (list(v) if v.ndim > 1 else v)
                             for k, v in t.columns.items()},
                            index=range(t.num_rows))
    if batch_format == "numpy":
        if isinstance(block, TableBlock):
            return {k: _readonly(v) for k, v in block.columns.items()}
        return np.asarray(block)
    raise ValueError(f"unknown batch_format {batch_format!r}")


def slice_block(block: Block, start: int, end: int) -> Block:
    if isinstance(block, TableBlock):
        return block.slice(start, end)
    return block[start:end]


def take(block: Block, indices) -> Block:
    """The rows of ``block`` at ``indices``, in that order."""
    if isinstance(block, TableBlock):
        return block.take(indices)
    return [block[int(i)] for i in indices]


def _concat_column(pieces: list) -> np.ndarray:
    typed = [p for p in pieces if p.dtype != object]
    if len(typed) == len(pieces):
        dtypes = {p.dtype for p in pieces}
        if len(dtypes) > 1:
            raise TypeError(f"cannot concatenate columns of types "
                            f"{sorted(map(str, dtypes))}")
        if len({p.shape[1:] for p in pieces}) == 1:
            return np.concatenate(pieces)
    return object_column([v for p in pieces for v in _row_values(p)])


def concat_blocks(blocks: list) -> Block:
    """Concatenate blocks. Tables unify their columns as arrow's
    ``promote_options="default"`` does: names in order of first
    appearance, a column a table lacks filled with None; columns of two
    different number types raise (arrow: ArrowTypeError); tensor columns
    of different row shapes become object columns of rows."""
    tables = [b for b in blocks if isinstance(b, TableBlock)]
    if tables and len(tables) == len(blocks):
        names: dict = {}
        for t in tables:
            names.update(dict.fromkeys(t.columns))
        return TableBlock({
            name: _concat_column([
                t.columns[name] if name in t.columns
                else object_column([None] * t.num_rows) for t in tables])
            for name in names})
    out: list = []
    for b in blocks:
        out.extend(to_rows(b))
    return build_block(out)


def empty_like(block: Block) -> Block:
    if isinstance(block, TableBlock):
        return block.slice(0, 0)
    return []


def _stable_order(vals: np.ndarray, descending: bool) -> np.ndarray:
    """A stable argsort; descending keeps equal keys in their order (as
    arrow's sort_by)."""
    if not descending:
        return np.argsort(vals, kind="stable")
    n = len(vals)
    return (n - 1) - np.argsort(vals[::-1], kind="stable")[::-1]


def sort_block(block: Block, key: str | None,
               descending: bool = False) -> Block:
    if isinstance(block, TableBlock):
        if key is None:
            raise ValueError("tabular sort needs a key column")
        return block.take(_stable_order(block.columns[key], descending))
    return sorted(block, reverse=descending)


def key_values(block: Block, key: str | None) -> np.ndarray:
    if isinstance(block, TableBlock):
        if key is None:
            raise ValueError("a tabular block's values need a key column")
        return block.columns[key]
    return np.asarray(list(block))


__all__ = ["Block", "TableBlock", "build_block", "column_of",
           "concat_blocks", "empty_like", "from_arrow_table", "from_batch",
           "key_values", "num_rows", "object_column", "require",
           "rows_to_table", "size_bytes", "slice_block", "sort_block",
           "take", "to_arrow_table", "to_batch", "to_rows"]
