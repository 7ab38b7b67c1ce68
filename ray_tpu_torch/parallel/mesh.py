"""The logical-axis rules and single-controller device meshes.

Counterpart of the part of ``ray_tpu/parallel/mesh.py`` the port needs:
`MESH_AXES`, `DEFAULT_LOGICAL_RULES` and `PIPELINE_LOGICAL_RULES` (read
by ``models/partition.py::logical_to_spec`` and ``place_on_axis``, and
by the memory audit). The port's meshes are single-controller, as its
tensor-parallel engine is: a mesh is a plain list of devices, one per
shard of ONE mesh axis, and a device may repeat (the shards then run in
turn on it, the counterpart of the forced host-device count of the JAX
tests). `device_mesh` builds one: ``device_mesh(n, axis="ep")`` is the
expert-parallel mesh of ``ops/moe.py``, ``device_mesh(n, axis="pp")``
the pipeline mesh of ``parallel/pipeline.py``; ``models/partition.py``
`make_tp_mesh` and ``parallel/ring.py`` `make_sp_mesh` name the tp and
sp ones. Shard 0's device is the controller's: leaves that no axis
splits, and the cross-shard sums (`reduce_shards`), live there.
`axis_shards` hands a leaf's shards to the code that runs over the mesh.
"""

from __future__ import annotations

from typing import Any

import torch

# Canonical axis order, outermost (slowest) first. The port's meshes span
# one axis each; dp and fsdp need several processes and are not ported.
MESH_AXES: tuple[str, ...] = ("dp", "pp", "fsdp", "sp", "ep", "tp")

# Logical model axes → mesh axes. Anything not listed is replicated.
DEFAULT_LOGICAL_RULES: tuple[tuple[str, Any], ...] = (
    ("batch", ("dp", "fsdp")),   # batch sharded over both data axes
    ("seq", "sp"),               # sequence/context parallelism
    ("embed", "fsdp"),           # ZeRO-3: shard params along embed over fsdp
    ("mlp", "tp"),               # megatron: shard mlp hidden over tp
    ("heads", "tp"),             # megatron: shard attention heads over tp
    ("kv", None),
    ("kv_heads", None),          # GQA kv heads (too few to shard over tp)
    ("vocab", "tp"),
    ("layers", None),            # stacked-layer leading axis
    ("expert", "ep"),            # MoE experts sharded over ep
)

# Pipeline variant: the stacked-layer axis shards over pp, so each stage
# holds n_layers/pp blocks (read by spmd.build_pipeline_training).
PIPELINE_LOGICAL_RULES: tuple[tuple[str, Any], ...] = tuple(
    (name, "pp") if name == "layers" else (name, ax)
    for name, ax in DEFAULT_LOGICAL_RULES
)


def device_mesh(n: int, *, axis: str, devices=None) -> list[torch.device]:
    """``n`` devices, one per shard of mesh axis ``axis``. By default the
    first ``n`` visible CUDA devices (raises when there are fewer); an
    explicit ``devices`` list may repeat a device."""
    if axis not in MESH_AXES:
        raise ValueError(f"unknown mesh axis {axis!r}; one of {MESH_AXES}")
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(count)]
    if n < 1:
        raise ValueError(f"{axis} must be >= 1, got {n}")
    if n > len(devices):
        raise ValueError(
            f"{axis}={n} exceeds the {len(devices)} visible device(s); "
            "pass an explicit device list (a device may repeat) to place "
            "several shards on one device")
    return [torch.device(d) for d in devices[:n]]


def reduce_shards(partials: list, device) -> torch.Tensor:
    """Sum of the shards' partials on ``device`` (shard 0's), in shard
    order and in the partials' dtype: the counterpart of the JAX bodies'
    ``psum`` of ``cfg.dtype`` partials. XLA may reassociate its sum;
    this one is fixed, ((p0 + p1) + p2) + ..., so with more than two
    bf16 partials the two can differ in the last bit. One partial is
    returned as it is."""
    out = partials[0].to(device)
    for p in partials[1:]:
        out = out + p.to(device)
    return out


def axis_shards(tree: dict, name: str, mesh) -> list:
    """Leaf ``name``'s shards over ``mesh``, shard s on ``mesh[s]``: the
    placed ``name@s`` leaves (``models/partition.py::place_on_axis``),
    or, when ``name`` is whole in ``tree``, its ``len(mesh)`` even
    chunks along dim 0 moved to their devices (views where a shard's
    device is the leaf's, so gradients flow back to the whole leaf).
    The split axis leads every leaf read here: one layer's expert stack
    [E, ...] over ep, a layer stack [L, ...] over pp."""
    n = len(mesh)
    if name in tree:
        leaf = tree[name]
        if leaf.shape[0] % n:
            raise ValueError(
                f"{name!r} of shape {tuple(leaf.shape)} does not split "
                f"into {n} shards along dim 0")
        return [w.to(d) for w, d in zip(torch.chunk(leaf, n), mesh)]
    if f"{name}@{n}" in tree or any(f"{name}@{s}" not in tree
                                    for s in range(n)):
        raise ValueError(f"{name!r} is not placed on {n} shards")
    return [tree[f"{name}@{s}"] for s in range(n)]


__all__ = ["DEFAULT_LOGICAL_RULES", "MESH_AXES", "PIPELINE_LOGICAL_RULES",
           "axis_shards", "device_mesh", "reduce_shards"]
