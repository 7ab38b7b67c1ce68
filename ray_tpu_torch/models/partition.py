"""Regex partition rules and the serving tensor-parallel mesh (PyTorch).

Counterpart of the serving half of ``ray_tpu/models/partition.py``:
`KV_HEAD_AXIS`, `split_head_planes`/`concat_head_planes`, `TP_AXIS`,
`PartitionRuleError`, `tree_path_names`, `match_partition_rules`,
`make_tp_mesh` and `shard_by_rules`; and of the training half's
logical-axis resolution, `logical_to_spec`, with `place_on_axis` (read
back by ``parallel/mesh.py::axis_shards``), the single-controller
counterpart of ``tree_to_shardings`` + ``shard_tree`` over ONE mesh
axis: expert
stacks split on ``"expert"`` over an ep mesh, layer stacks on
``"layers"`` over a pp mesh (`PIPELINE_LOGICAL_RULES`). Placement over
several single-controller axes at once is not ported. Across processes,
`tree_to_shardings` resolves each leaf's logical axes on a process mesh
(``parallel/mesh.py::make_mesh``: dp and fsdp) to a `Sharding` (the
dimension fsdp splits and this rank's index range on it), and
`shard_tree` keeps this rank's pieces of whole leaves: the counterparts
of the JAX functions of the same names.

Models declare where each parameter shards once, as a rule table of
``(regex, dim)`` pairs over ``/``-joined tree paths
(``models/gpt.py::partition_rules``,
``models/paged_kv.py::KV_POOL_PARTITION_RULES``). ``dim`` is the
dimension split across the shards, or None for a leaf every shard holds
whole. A rule is the dimension itself, not a ``PartitionSpec``: the
port's mesh has the one ``"tp"`` axis.

The engine is single-controller, as the JAX one is: one process holds
one parameter dict and one page pool per shard on a list of devices
(the mesh), and each paged program runs its layer loop with the shards
in lockstep (``models/paged_kv.py`` ``*_tp`` twins). The head axis is
the partition axis because decode attention is already parallel over
heads: the QKV projections, rotary, per-head softmax and the page
reads and writes are shard-local; only the attention-out and MLP-down
partial sums cross shards (summed on shard 0's device), and the int8
pool's per-page scale (a maximum across shards). A device may appear
in the mesh more than once: the shards then run one after another on
it, the counterpart of the forced host-device count of the JAX tests.
"""

from __future__ import annotations

import re
import types
from typing import Any

import numpy as np
import torch

from ray_tpu_torch.parallel.mesh import DEFAULT_LOGICAL_RULES, device_mesh

__all__ = [
    "KV_HEAD_AXIS", "PartitionRuleError", "TP_AXIS",
    "concat_head_planes", "logical_to_spec", "make_tp_mesh",
    "match_partition_rules", "place_on_axis", "shard_by_rules",
    "shard_tree", "split_head_planes", "tree_path_names",
    "tree_to_shardings",
]

# KV page planes [L, n_pages, page_size, H, K] shard on their head dim,
# the axis the mesh partitions (paged_kv.KV_POOL_PARTITION_RULES).
# split_head_planes/concat_head_planes below speak the same axis.
KV_HEAD_AXIS = 3


def split_head_planes(payload: dict, tp: int) -> dict:
    """Full-head host page planes → per-shard planes keyed ``name@s``.

    A gathered payload ``{"k": [L, n, ps, H, K], ...}`` splits along the
    head axis into ``tp`` planes (``k@0`` … ``k@{tp-1}``), so each entry
    is one shard's bytes. ``_scale``-suffixed planes ([L, n] per-page
    scalars) are the same on every shard (`paged_kv._quant_write` takes
    their maximum across shards), so one copy rides unsuffixed.
    ``tp == 1`` is the identity. numpy arrays split with ``np.split``
    (the JAX function's bytes), torch tensors with ``torch.chunk``
    (views, in any dtype: numpy has no bf16)."""
    if tp <= 1:
        return dict(payload)
    out: dict = {}
    for name, arr in payload.items():
        if name.endswith("_scale") or getattr(arr, "ndim", 0) <= KV_HEAD_AXIS:
            out[name] = arr
            continue
        h = arr.shape[KV_HEAD_AXIS]
        if h % tp:
            raise ValueError(
                f"cannot split plane {name!r}: head dim {h} not divisible "
                f"by tp={tp}")
        pieces = (torch.chunk(arr, tp, dim=KV_HEAD_AXIS)
                  if isinstance(arr, torch.Tensor)
                  else np.split(arr, tp, axis=KV_HEAD_AXIS))
        for s, piece in enumerate(pieces):
            out[f"{name}@{s}"] = piece
    return out


def concat_head_planes(payload: dict, tp: int) -> dict:
    """Inverse of `split_head_planes`: ``name@s`` shard planes →
    full-head planes (head-axis concatenation in shard order). Raises if
    a shard plane is missing: a torn payload must fail, not bind garbage
    heads. Torch planes join with ``torch.cat``, numpy planes with
    ``np.concatenate``."""
    if tp <= 1:
        return dict(payload)
    out: dict = {}
    shards: dict[str, dict[int, Any]] = {}
    for name, arr in payload.items():
        base, sep, idx = name.rpartition("@")
        if sep and idx.isdigit():
            shards.setdefault(base, {})[int(idx)] = arr
        else:
            out[name] = arr
    for base, pieces in shards.items():
        if sorted(pieces) != list(range(tp)):
            raise ValueError(
                f"sharded payload plane {base!r} is torn: have shards "
                f"{sorted(pieces)}, want 0..{tp - 1}")
        parts = [pieces[s] for s in range(tp)]
        out[base] = (torch.cat(parts, dim=KV_HEAD_AXIS)
                     if isinstance(parts[0], torch.Tensor)
                     else np.concatenate(parts, axis=KV_HEAD_AXIS))
    return out


# The serving tensor-parallel mesh axis (the name the metrics report:
# ``mesh_shape == {"tp": tp}``).
TP_AXIS = "tp"


class PartitionRuleError(ValueError):
    """A tree leaf matched no partition rule."""


def _leaves(tree: Any, prefix: str = ""):
    """(path, leaf) pairs in the JAX flatten order: dict keys sorted,
    sequences by index; anything else is a leaf."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{prefix}/{key}" if prefix
                               else str(key))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def _map(fn, tree: Any, prefix: str = ""):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {key: _map(fn, sub, f"{prefix}/{key}" if prefix else str(key))
                for key, sub in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, sub, f"{prefix}/{i}" if prefix else str(i))
                          for i, sub in enumerate(tree))
    return fn(prefix, tree)


def tree_path_names(tree: Any) -> list[str]:
    """``/``-joined path of every leaf, in flatten order: what
    `match_partition_rules` matches its regexes against."""
    return [path for path, _leaf in _leaves(tree)]


def match_partition_rules(rules, params):
    """Tree of sharded dimensions (an int, or None for replicated) for
    ``params`` from a rule table.

    ``rules`` is an ordered sequence of ``(regex, dim)``; each leaf's
    ``/``-joined path is matched with ``re.search`` and the FIRST
    matching rule wins. Scalar leaves (ndim 0 or a single element) are
    never partitioned and resolve to None without consulting the table.
    A leaf no rule covers raises `PartitionRuleError` naming the path:
    replicating it silently would hide the weight the table forgot.
    Reads only the leaves' shapes."""
    compiled = [(re.compile(pat), dim) for pat, dim in rules]

    def get_dim(name, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) == 0 or int(np.prod(shape)) == 1:
            return None
        for pat, dim in compiled:
            if pat.search(name) is not None:
                return dim
        raise PartitionRuleError(
            f"no partition rule matches param {name!r} (shape "
            f"{shape}); add a rule or an explicit replicated entry — "
            "silent replication would hide the miss")

    return _map(get_dim, params)


def make_tp_mesh(tp: int, *, devices=None) -> list[torch.device]:
    """The serving mesh: ``tp`` devices, one per shard. By default the
    first ``tp`` visible CUDA devices (raises when there are fewer); an
    explicit ``devices`` list may repeat a device (the shards then run
    in turn on it)."""
    return device_mesh(tp, axis="tp", devices=devices)


def _shard(leaf: torch.Tensor, dim, s: int, tp: int,
           device: torch.device) -> torch.Tensor:
    """Shard ``s`` of ``leaf``: its piece along ``dim`` (the whole leaf
    when None), as a new contiguous tensor on ``device`` (its own
    allocation, also where the device repeats)."""
    piece = leaf if dim is None else torch.chunk(leaf, tp, dim=dim)[s]
    out = torch.empty(piece.shape, dtype=piece.dtype, device=device)
    return out.copy_(piece)


def shard_by_rules(mesh, rules, tree: Any) -> list:
    """Place ``tree`` on ``mesh`` per its rule table: one tree per
    shard, each leaf a contiguous tensor of its own on the shard's
    device, split along the rule's dimension (which must divide evenly)
    or copied whole."""
    dims = match_partition_rules(rules, tree)
    dim_of = dict(_leaves(dims))
    tp = len(mesh)
    for path, leaf in _leaves(tree):
        dim = dim_of[path]
        if dim is not None and leaf.shape[dim] % tp:
            raise ValueError(
                f"cannot shard {path!r}: dim {dim} of shape "
                f"{tuple(leaf.shape)} is not divisible by tp={tp}")
    return [_map(lambda path, leaf, s=s, dev=dev:
                 _shard(leaf, dim_of[path], s, tp, dev), tree)
            for s, dev in enumerate(mesh)]


# --------------------------------------------------------------------------
# Logical-axis resolution (the training half): models annotate each
# parameter with logical axis names (``param_specs(cfg)[name]["axes"]``)
# and a rule table maps them to mesh axes. The memory audit
# (``train/memory_audit.py``) reads the result.


def logical_to_spec(logical_axes: tuple[Any, ...],
                    rules: tuple[tuple[str, Any], ...] = DEFAULT_LOGICAL_RULES,
                    *, mesh=None) -> tuple:
    """Map a tuple of logical axis names to a partition spec: a tuple
    with one entry per leading dimension, each None (whole), a mesh axis
    name, or a tuple of names; trailing Nones are dropped, as the JAX
    ``PartitionSpec`` of the same function drops them.

    If ``mesh`` (anything with a ``shape`` dict of axis sizes) is given,
    a mesh axis of size 1, or absent, resolves to None, so the same rules
    work on one device and on many. A mesh axis is consumed by at most
    one dimension of an array."""
    table = dict(rules)
    used: set[str] = set()
    out: list[Any] = []
    for ax in logical_axes:
        mapped = table.get(ax) if ax is not None else None
        if mapped is None:
            out.append(None)
            continue
        axes = (mapped,) if isinstance(mapped, str) else tuple(mapped)
        kept = []
        for m in axes:
            if m in used:
                continue
            if mesh is not None and mesh.shape.get(m, 1) == 1:
                continue
            kept.append(m)
            used.add(m)
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(tuple(kept))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _split_dim(axes: tuple, axis: str, n: int, rules) -> int | None:
    """The dimension of a leaf with logical ``axes`` that mesh axis
    ``axis`` (of ``n`` shards) splits under ``rules``, or None."""
    spec = logical_to_spec(axes, rules,
                           mesh=types.SimpleNamespace(shape={axis: n}))
    for d, m in enumerate(spec):
        if m == axis or (isinstance(m, tuple) and axis in m):
            return d
    return None


def place_on_axis(params: dict, logical_axes: dict, mesh, axis: str,
                  rules=DEFAULT_LOGICAL_RULES) -> dict:
    """Place a flat parameter dict on ``mesh``, the devices of mesh axis
    ``axis``: a leaf whose logical axes (``logical_axes[name]``) resolve
    to ``axis`` under ``rules`` is split along that dimension into
    ``len(mesh)`` shards, shard s as ``name@s``, its own contiguous
    tensor on ``mesh[s]`` (the dimension must divide evenly); every
    other leaf stays whole on ``mesh[0]``, the controller's device. On a
    mesh of one device nothing is split. ``parallel/mesh.py::axis_shards``
    reads the shards back in shard order."""
    n = len(mesh)
    out = {}
    for name, leaf in params.items():
        dim = _split_dim(logical_axes[name], axis, n, rules)
        if dim is None:
            out[name] = leaf.to(mesh[0])
            continue
        if leaf.shape[dim] % n:
            raise ValueError(
                f"cannot place {name!r} on {axis}={n}: dim {dim} of shape "
                f"{tuple(leaf.shape)} does not divide evenly")
        for s, dev in enumerate(mesh):
            out[f"{name}@{s}"] = _shard(leaf, dim, s, n, dev)
    return out


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def tree_to_shardings(logical_tree: Any, mesh,
                      rules: tuple[tuple[str, Any], ...] = DEFAULT_LOGICAL_RULES
                      ) -> Any:
    """Map a tree (dicts, lists) of logical-axis tuples to a tree of
    ``parallel/mesh.py::Sharding`` on the process mesh ``mesh``: each
    leaf's `logical_to_spec` on the mesh, seen from this rank."""
    if _is_axes(logical_tree):
        return mesh.sharding(logical_to_spec(logical_tree, rules, mesh=mesh))
    if isinstance(logical_tree, dict):
        return {k: tree_to_shardings(v, mesh, rules)
                for k, v in logical_tree.items()}
    return type(logical_tree)(tree_to_shardings(v, mesh, rules)
                              for v in logical_tree)


def shard_tree(tree: Any, shardings: Any) -> Any:
    """This rank's pieces of a tree of whole leaves (torch tensors or
    numpy arrays) per a matching tree of shardings, each its own tensor
    on the mesh's device: the counterpart of ``jax.device_put(x,
    NamedSharding)`` on one rank."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tree(v, s) for v, s in zip(tree, shardings))
    return shardings.shard(tree)
