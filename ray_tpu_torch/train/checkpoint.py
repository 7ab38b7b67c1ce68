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
with its leaf, dimension and index range; a piece every rank of an axis
holds alike is written once), rank 0 writes ``index.json`` (world size,
each leaf's global shape and dtype), and `load_sharded` rebuilds any
target layout from them: the saved world's, or one whole copy.
"""

from __future__ import annotations

import json
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
        if s is not None and s.dim is not None:
            shape[s.dim] *= s.count
        leaves[name] = {"shape": shape, "dtype": str(t.dtype)}
        if s is not None and not s.writer:
            continue
        dim = None if s is None else s.dim
        start, stop = (0, 0) if dim is None else s.bounds(shape[dim])
        pieces[name] = {"dim": dim, "start": start, "stop": stop,
                        "tensor": t.detach().cpu()}
    torch.save(pieces, os.path.join(path, f"shard-{rank:05d}.pt"))
    if rank == 0:
        with open(os.path.join(path, INDEX_FILE), "w") as f:
            json.dump({"world": world, "leaves": leaves}, f)
    _barrier()


def _whole(name: str, meta: dict, saved: list):
    """Leaf ``name`` joined from its saved pieces (a whole piece, or
    pieces that tile one dimension exactly)."""
    import torch

    whole = [p for p in saved if p["dim"] is None]
    if whole:
        return whole[0]["tensor"]
    dims = {p["dim"] for p in saved}
    if len(dims) != 1:
        raise ValueError(f"checkpoint leaf {name!r} has no pieces or pieces "
                         f"on several dimensions {sorted(dims)}")
    dim = dims.pop()
    saved = sorted(saved, key=lambda p: p["start"])
    edges = [0] + [p["stop"] for p in saved]
    if ([p["start"] for p in saved] != edges[:-1]
            or edges[-1] != meta["shape"][dim]):
        raise ValueError(f"checkpoint leaf {name!r} is torn: pieces "
                         f"{[(p['start'], p['stop']) for p in saved]} of "
                         f"{meta['shape'][dim]}")
    return torch.cat([p["tensor"] for p in saved], dim=dim)


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
