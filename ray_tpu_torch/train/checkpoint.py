"""AIR-style Checkpoint: dict ↔ directory interconvertible.

Counterpart of ``ray_tpu/train/checkpoint.py``'s `Checkpoint` (parity:
``python/ray/air/checkpoint.py:61``). `from_params` takes the port's
parameters (a dict of torch tensors, or lists and tuples of such
dicts) and moves every tensor to the host, so a checkpoint written on
one device loads on any other. The directory form is one pickle
(``checkpoint.pkl``). The reference's orbax-backed
``save_sharded``/``load_sharded`` are not ported.
"""

from __future__ import annotations

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


__all__ = ["Checkpoint"]
