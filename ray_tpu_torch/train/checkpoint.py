"""AIR-style Checkpoint: dict ↔ directory interconvertible.

Counterpart of ``ray_tpu/train/checkpoint.py``'s `Checkpoint` (parity:
``python/ray/air/checkpoint.py:61``). `from_params` takes the port's
parameters (a dict of torch tensors, or lists and tuples of such
dicts) and moves every tensor to the host, so a checkpoint written on
one device loads on any other. The directory form is one pickle
(``checkpoint.pkl``).

`save_sharded`/`load_sharded` are the counterparts of the reference's
orbax-backed pair: every rank of a process mesh writes the pieces it
holds (``shard-<rank>.pt``, one ``torch.save`` file per rank, each piece
with its leaf and its index range on every dimension, so a leaf split
on two dimensions round-trips; a piece every rank of an axis holds
alike is written once), rank 0 writes ``index.json`` (world size,
each leaf's global shape and dtype), and `load_sharded` rebuilds any
target layout from them: the saved world's, or one whole copy.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import pickle
import shutil
import tempfile
import uuid
from typing import Any


def _to_host(tree: Any) -> Any:
    """Every tensor of ``tree`` (dicts, lists and tuples of them)
    detached and on the CPU; other leaves as they are. Never imports
    torch: a tensor can only exist if torch is loaded."""
    import sys

    torch = sys.modules.get("torch")
    if torch is not None and isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


class Checkpoint:
    def __init__(self, data: dict | None = None, path: str | None = None):
        if (data is None) == (path is None):
            raise ValueError("exactly one of data/path required")
        self._data = data
        self._path = path

    # ---- constructors ----

    @classmethod
    def from_dict(cls, data: dict) -> "Checkpoint":
        return cls(data=dict(data))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path=path)

    @classmethod
    def from_params(cls, params: Any, **extra) -> "Checkpoint":
        """Move a parameter tree's tensors to the host and wrap it."""
        return cls(data={"params": _to_host(params), **extra})

    # ---- accessors ----

    def to_dict(self) -> dict:
        if self._data is not None:
            return self._data
        with open(os.path.join(self._path, "checkpoint.pkl"), "rb") as f:
            return pickle.load(f)

    def to_directory(self, path: str | None = None) -> str:
        if path is None:
            path = os.path.join(
                tempfile.gettempdir(),
                f"raytpu-torch-ckpt-{uuid.uuid4().hex[:8]}")
        os.makedirs(path, exist_ok=True)
        if self._path is not None:
            if os.path.abspath(self._path) != os.path.abspath(path):
                shutil.copytree(self._path, path, dirs_exist_ok=True)
        else:
            with open(os.path.join(path, "checkpoint.pkl"), "wb") as f:
                pickle.dump(self._data, f, protocol=5)
        return path

    def to_params(self) -> Any:
        return self.to_dict()["params"]

    def __getitem__(self, k):
        return self.to_dict()[k]

    def get(self, k, default=None):
        return self.to_dict().get(k, default)


INDEX_FILE = "index.json"


def _world() -> tuple[int, int]:
    """(rank, world size) of the default process group, (0, 1) without."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier() -> None:
    import torch.distributed as dist

    if _world()[1] > 1:
        dist.barrier()


def save_sharded(params: dict, path: str, shardings: dict | None = None
                 ) -> None:
    """Write this rank's pieces of ``params`` (a flat dict of the rank's
    tensors) under directory ``path``. ``shardings``: the leaves'
    ``parallel/mesh.py::Sharding`` (from ``tree_to_shardings`` on the
    process mesh); None means every leaf is whole and this process
    writes all of them. Every rank of the group calls it; it returns
    once every rank has written (ref capability: Train checkpoint
    streaming, train/_internal/checkpoint.py)."""
    import torch

    rank, world = _world()
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    pieces, leaves = {}, {}
    for name, t in params.items():
        s = None if shardings is None else shardings[name]
        shape = list(t.shape)
        for split in () if s is None else s.splits:
            shape[split.dim] *= split.count
        leaves[name] = {"shape": shape, "dtype": str(t.dtype)}
        if s is not None and not s.writer:
            continue
        bounds = ([(0, n) for n in shape] if s is None
                  else [list(b) for b in s.bounds(shape)])
        pieces[name] = {"bounds": bounds, "tensor": t.detach().cpu()}
    torch.save(pieces, os.path.join(path, f"shard-{rank:05d}.pt"))
    if rank == 0:
        with open(os.path.join(path, INDEX_FILE), "w") as f:
            json.dump({"world": world, "leaves": leaves}, f)
    _barrier()


def _bounds(piece: dict, shape) -> list:
    """A saved piece's [start, stop) on every dimension. Pieces written
    before a leaf could split on two dimensions name one ``dim`` (None:
    the whole leaf) and its ``start``/``stop``."""
    if "bounds" in piece:
        return piece["bounds"]
    box = [[0, n] for n in shape]
    if piece["dim"] is not None:
        box[piece["dim"]] = [piece["start"], piece["stop"]]
    return box


def _whole(name: str, meta: dict, saved: list):
    """Leaf ``name`` joined from its saved pieces, each placed at its
    bounds (one per dimension); they must cover the leaf exactly once."""
    shape = meta["shape"]
    boxes = [_bounds(p, shape) for p in saved]
    inside = all(0 <= a < b <= n for box in boxes
                 for (a, b), n in zip(box, shape))
    overlap = any(all(a1 < b2 and a2 < b1
                      for (a1, b1), (a2, b2) in zip(x, y))
                  for x, y in itertools.combinations(boxes, 2))
    volume = sum(math.prod(b - a for a, b in box) for box in boxes)
    if not saved or not inside or overlap or volume != math.prod(shape):
        raise ValueError(f"checkpoint leaf {name!r} is torn: pieces "
                         f"{boxes} of {shape}")
    out = saved[0]["tensor"].new_empty(shape)
    for p, box in zip(saved, boxes):
        out[tuple(slice(a, b) for a, b in box)] = p["tensor"]
    return out


def load_sharded(path: str, target: dict) -> dict:
    """This rank's pieces of the leaves saved under ``path`` in the
    layout ``target`` (a flat dict of ``parallel/mesh.py::Sharding``,
    e.g. ``tree_to_shardings`` on this rank's process mesh: the saved
    world's layout, or world 1's whole leaves), each on its sharding's
    device: the counterpart of orbax's restore into an abstract tree."""
    import torch

    path = os.path.abspath(path)
    with open(os.path.join(path, INDEX_FILE)) as f:
        index = json.load(f)
    saved: dict[str, list] = {}
    for rank in range(index["world"]):
        fname = os.path.join(path, f"shard-{rank:05d}.pt")
        for name, piece in torch.load(fname, map_location="cpu",
                                      weights_only=True).items():
            saved.setdefault(name, []).append(piece)
    missing = set(target) - set(index["leaves"])
    if missing:
        raise KeyError(f"leaves not in the checkpoint: {sorted(missing)}")
    return {name: s.shard(_whole(name, index["leaves"][name],
                                 saved.get(name, [])))
            for name, s in target.items()}


__all__ = ["Checkpoint", "save_sharded", "load_sharded"]
