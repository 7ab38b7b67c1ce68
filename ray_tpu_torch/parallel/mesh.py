"""The logical-axis rules, single-controller device meshes and the
process mesh.

Counterpart of ``ray_tpu/parallel/mesh.py``: `MESH_AXES`,
`DEFAULT_LOGICAL_RULES` and `PIPELINE_LOGICAL_RULES` (read by
``models/partition.py::logical_to_spec`` and ``place_on_axis``, and by
the memory audit), `MeshConfig`, `make_mesh`, `single_device_mesh`,
`replicated` and `batch_sharding`.

Two kinds of mesh. The dp, fsdp and tp axes span processes: `make_mesh`,
called in every rank of a ``torch.distributed`` process group (a
`train.TorchTrainer` gang), resolves a `MeshConfig` over the world size
and returns this rank's `ProcessMesh` (the axis sizes, the rank's
coordinate on each axis with ranks laid out row-major over `MESH_AXES`,
as the JAX fallback lays out devices, a process group for every set of
live axes, and the rank's device), whose `Sharding` of a leaf names the
dimensions its axes split (up to two: embed over fsdp and heads, mlp or
vocab over tp) and this rank's index range on each. `gather_leaf` and
`reduce_from` are its collectives under autograd: the fsdp gather and
the sum of megatron's row-parallel partials (its column-parallel
product is ``models/decode.py::_column_parallel``). The other axes run on one
controller inside a rank, as the port's tensor-parallel engine does: a
single-controller mesh is a plain list of devices, one per shard of ONE
mesh axis, and a device may repeat (the shards then run in turn on it,
the counterpart of the forced host-device count of the JAX tests).
`device_mesh` builds one: ``device_mesh(n, axis="ep")`` is the
expert-parallel mesh of ``ops/moe.py``, ``device_mesh(n, axis="pp")``
the pipeline mesh of ``parallel/pipeline.py``; ``models/partition.py``
`make_tp_mesh` and ``parallel/ring.py`` `make_sp_mesh` name the tp and
sp ones. Shard 0's device is the controller's: leaves that no axis
splits, and the cross-shard sums (`reduce_shards`), live there.
`axis_shards` hands a leaf's shards to the code that runs over the mesh.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import weakref
from typing import Any

import numpy as np
import torch

# Canonical axis order, outermost (slowest) first.
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


# ------------------------------------------------------- the process mesh

# The axes whose shards are processes; the others run on one controller
# inside a rank (`device_mesh`).
PROCESS_AXES: tuple[str, ...] = ("dp", "fsdp", "tp")
# The process axes that split the batch: a gradient is averaged over
# those of them that do not split its leaf.
DATA_AXES: tuple[str, ...] = ("dp", "fsdp")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh shape. -1 on at most one axis means "use the rest"."""

    dp: int = 1
    fsdp: int = -1
    sp: int = 1
    tp: int = 1
    pp: int = 1
    ep: int = 1

    def resolve(self, n_devices: int) -> dict[str, int]:
        sizes = {"dp": self.dp, "pp": self.pp, "fsdp": self.fsdp,
                 "sp": self.sp, "ep": self.ep, "tp": self.tp}
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got {wild}")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {fixed}"
                )
            sizes[wild[0]] = n_devices // fixed
        if math.prod(sizes.values()) != n_devices:
            raise ValueError(
                f"mesh {sizes} does not cover {n_devices} devices"
            )
        return sizes


def mesh_coords(rank: int, shape: dict[str, int]) -> dict[str, int]:
    """``rank``'s coordinate on each axis, ranks laid out row-major over
    `MESH_AXES` (the last axis varies fastest)."""
    coords = {}
    for ax in reversed(MESH_AXES):
        rank, coords[ax] = divmod(rank, shape[ax])
    return {ax: coords[ax] for ax in MESH_AXES}


def _host_tensor(x) -> torch.Tensor:
    """``x`` as a tensor: a tensor as it is, a numpy array copied (numpy
    bf16 arrives as ``ml_dtypes.bfloat16`` and goes through fp32,
    exactly)."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


@dataclasses.dataclass(frozen=True)
class Split:
    """One dimension of a leaf split across processes: over mesh ``axes``
    into ``count`` even pieces, of which this rank holds piece ``index``
    (row-major over ``axes``, as the JAX sharding assigns the device at
    this rank's mesh position)."""

    dim: int
    axes: tuple[str, ...]
    index: int
    count: int


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where one leaf lies on a process mesh: the counterpart of a JAX
    ``NamedSharding`` seen from one rank. ``spec`` is the leaf's
    partition spec on the mesh (``models/partition.py::logical_to_spec``);
    ``splits`` the dimensions it splits (none: the rank holds the whole
    leaf; two, e.g. embed over fsdp and heads over tp). ``writer``: this
    rank's coordinate is 0 on every axis that does not split the leaf,
    so it writes this piece in a sharded checkpoint."""

    spec: tuple
    splits: tuple[Split, ...]
    device: torch.device
    writer: bool

    @property
    def axes(self) -> tuple[str, ...]:
        """Every mesh axis that splits the leaf."""
        return tuple(a for s in self.splits for a in s.axes)

    @property
    def count(self) -> int:
        """The number of pieces the leaf is cut into."""
        return math.prod(s.count for s in self.splits)

    @property
    def dim(self) -> int | None:
        """The one split dimension (None: whole). A leaf split on two
        dimensions has no one dimension: read ``splits``."""
        if len(self.splits) > 1:
            raise ValueError(f"spec {self.spec} splits "
                             f"{len(self.splits)} dimensions")
        return self.splits[0].dim if self.splits else None

    def split_dim(self, axis: str) -> int | None:
        """The dimension mesh ``axis`` splits, or None."""
        for s in self.splits:
            if axis in s.axes:
                return s.dim
        return None

    def bounds(self, shape) -> tuple[tuple[int, int], ...]:
        """[start, stop) of this rank's piece on each dimension of a
        leaf of the whole ``shape``."""
        out = [(0, size) for size in shape]
        for s in self.splits:
            size = shape[s.dim]
            if size % s.count:
                raise ValueError(
                    f"dimension {s.dim} of size {size} does not split "
                    f"evenly over {s.axes} ({s.count} shards)")
            n = size // s.count
            out[s.dim] = (s.index * n, (s.index + 1) * n)
        return tuple(out)

    def local_shape(self, shape) -> tuple[int, ...]:
        return tuple(b - a for a, b in self.bounds(tuple(shape)))

    def shard(self, x) -> torch.Tensor:
        """This rank's piece of the whole leaf ``x`` (a tensor or a numpy
        array), its own contiguous tensor on the mesh's device."""
        if self.splits:
            index = tuple(slice(a, b) for a, b in self.bounds(x.shape))
            x = (x[index] if isinstance(x, torch.Tensor)
                 else np.asarray(x)[index])
        t = _host_tensor(x)
        out = torch.empty(t.shape, dtype=t.dtype, device=self.device)
        return out.copy_(t)


@dataclasses.dataclass
class CollectiveStats:
    """What the mesh's collectives moved: calls, payload bytes (each
    rank's input), and the copies and bytes staged through host memory
    (gloo takes CUDA tensors through a host copy each way). ``whole``:
    the fsdp leaves `gather_leaf` has made whole that are still alive,
    ``whole_peak`` the most at once."""

    calls: int = 0
    bytes: int = 0
    staged_copies: int = 0
    staged_bytes: int = 0
    whole: int = 0
    whole_peak: int = 0


def _axes_key(axes) -> tuple[str, ...]:
    return tuple(a for a in MESH_AXES if a in set(axes))


class ProcessMesh:
    """One rank's view of a mesh whose axes span processes (`make_mesh`).

    ``shape`` maps every axis of `MESH_AXES` to its size, ``coords`` to
    this rank's coordinate; ``groups`` holds the process groups of the
    axes of size > 1: under an axis' name the ranks that differ from
    this one on that axis alone, under a tuple of axis names (in
    `MESH_AXES` order) those that differ on those axes alone (the whole
    world for every live axis: the default group); ``device`` is the
    rank's device. The collectives below run over the groups of the axes
    they are given; with gloo, CUDA tensors are staged through host
    memory (every copy counted in ``stats``), NCCL takes them where they
    lie."""

    def __init__(self, shape: dict[str, int], rank: int,
                 device: torch.device, groups: dict, backend: str | None):
        self.shape = dict(shape)
        self.rank = rank
        self.world_size = math.prod(shape.values())
        self.coords = mesh_coords(rank, shape)
        self.device = device
        self.groups = groups
        self.backend = backend
        self.stats = CollectiveStats()

    def __repr__(self):
        live = {a: n for a, n in self.shape.items() if n > 1}
        return (f"ProcessMesh({live or '1'}, rank={self.rank}, "
                f"device={self.device})")

    def live(self, axis: str) -> bool:
        return self.shape.get(axis, 1) > 1

    def sharding(self, spec: tuple) -> Sharding:
        """The `Sharding` of a leaf with partition ``spec`` on this mesh
        (mesh axes of size 1 split nothing)."""
        splits = []
        for d, entry in enumerate(spec):
            axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
            axes = tuple(a for a in axes if self.live(a))
            if not axes:
                continue
            index = 0
            for a in axes:
                index = index * self.shape[a] + self.coords[a]
            splits.append(Split(d, axes, index,
                                math.prod(self.shape[a] for a in axes)))
        split_axes = {a for s in splits for a in s.axes}
        return Sharding(
            spec=tuple(spec), splits=tuple(splits), device=self.device,
            writer=all(self.coords[a] == 0 for a in MESH_AXES
                       if a not in split_axes))

    def group(self, axes) -> tuple[Any, int]:
        """(process group, size) spanning mesh ``axes`` (one name or
        several): the size-1 axes drop out; no axis left is (None, 1)."""
        axes = _axes_key((axes,) if isinstance(axes, str) else axes)
        axes = tuple(a for a in axes if self.live(a))
        if not axes:
            return None, 1
        size = math.prod(self.shape[a] for a in axes)
        if len(axes) == 1:
            return self.groups[axes[0]], size
        if size == self.world_size:
            import torch.distributed as dist

            return dist.group.WORLD, size
        return self.groups[axes], size

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def _staged_copy(self, t: torch.Tensor, device) -> torch.Tensor:
        self.stats.staged_copies += 1
        self.stats.staged_bytes += t.numel() * t.element_size()
        return t.to(device)

    def _count(self, t: torch.Tensor) -> None:
        self.stats.calls += 1
        self.stats.bytes += t.numel() * t.element_size()

    def _all_reduce(self, t: torch.Tensor, axes, op: str) -> torch.Tensor:
        """``t`` reduced by ``op`` ("sum", "max" or "mean") over the ranks
        of ``axes``, every rank getting the same bits; ``t`` itself when
        no axis is live."""
        group, n = self.group(axes)
        if n == 1:
            return t
        import torch.distributed as dist

        self._count(t)
        staged = self._staged(t)
        buf = (self._staged_copy(t, "cpu") if staged
               else t.clone(memory_format=torch.contiguous_format))
        dist.all_reduce(buf, group=group, op=(dist.ReduceOp.MAX if op == "max"
                                              else dist.ReduceOp.SUM))
        if op == "mean":
            buf.div_(n)
        return self._staged_copy(buf, self.device) if staged else buf

    def all_reduce_mean(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The mean of ``t`` over the ranks of ``axes``: the sum, then a
        division by their count, every rank getting the same bits."""
        return self._all_reduce(t, axes, "mean")

    def all_reduce_sum(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The sum of ``t`` over the ranks of ``axes``."""
        return self._all_reduce(t, axes, "sum")

    def all_reduce_max(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The elementwise largest ``t`` of the ranks of ``axes``."""
        return self._all_reduce(t, axes, "max")

    def all_gather(self, t: torch.Tensor, axis, dim: int) -> torch.Tensor:
        """The pieces of ``t`` held along mesh ``axis`` (one name or
        several, their pieces row-major), joined along ``dim`` in the
        axes' order."""
        group, n = self.group(axis)
        if n == 1:
            return t
        import torch.distributed as dist

        self._count(t)
        piece = t.movedim(dim, 0).contiguous()
        staged = self._staged(piece)
        if staged:
            piece = self._staged_copy(piece, "cpu")
        out = piece.new_empty((n * piece.shape[0],) + tuple(piece.shape[1:]))
        dist.all_gather_into_tensor(out, piece, group=group)
        if staged:
            out = self._staged_copy(out, self.device)
        return out.movedim(0, dim)

    def gather_whole(self, t: torch.Tensor,
                     sharding: Sharding) -> torch.Tensor:
        """The whole leaf from this rank's piece ``t`` of it: gathered
        along every dimension ``sharding`` splits (no gradient)."""
        for s in sharding.splits:
            t = self.all_gather(t, s.axes, s.dim)
        return t

    def reduce_scatter_mean(self, t: torch.Tensor, axis: str,
                            dim: int) -> torch.Tensor:
        """This rank's piece along ``dim`` of the mean of ``t`` over the
        ranks of mesh ``axis``: the inverse of `all_gather` for
        gradients (sum, then a division by the axis size)."""
        group, n = self.group((axis,))
        if n == 1:
            return t
        import torch.distributed as dist

        self._count(t)
        whole = t.movedim(dim, 0).contiguous()
        staged = self._staged(whole)
        if staged:
            whole = self._staged_copy(whole, "cpu")
        out = whole.new_empty((whole.shape[0] // n,) + tuple(whole.shape[1:]))
        dist.reduce_scatter_tensor(out, whole, group=group)
        out.div_(n)
        if staged:
            out = self._staged_copy(out, self.device)
        return out.movedim(0, dim)


# ---------------------------------------- the collectives under autograd


def _whole_freed(stats: CollectiveStats) -> None:
    stats.whole -= 1


class _GatherLeaf(torch.autograd.Function):
    """A leaf's piece gathered whole along its fsdp dimension for the
    forward; its gradient reduce-scattered back to the piece in the
    backward (`ProcessMesh.reduce_scatter_mean`: each rank's loss is
    the mean over its own rows)."""

    @staticmethod
    def forward(ctx, piece, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.all_gather(piece, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return (ctx.mesh.reduce_scatter_mean(grad, ctx.axis, ctx.dim),
                None, None, None)


def gather_leaf(piece: torch.Tensor, mesh: ProcessMesh, axis: str,
                dim: int) -> torch.Tensor:
    """`_GatherLeaf` of ``piece``, counted in ``mesh.stats`` as a whole
    leaf until the gathered storage is freed (by the last view of it,
    autograd's saved tensors included)."""
    whole = _GatherLeaf.apply(piece, mesh, axis, dim)
    stats = mesh.stats
    stats.whole += 1
    stats.whole_peak = max(stats.whole_peak, stats.whole)
    weakref.finalize(whole.untyped_storage(), _whole_freed, stats)
    return whole


class _ReduceFrom(torch.autograd.Function):
    """The sum over ``axis`` forward, the identity backward: the partial
    sums of a row-parallel product (or a vocab-parallel lookup), which
    every rank of the axis then reads whole."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce_sum(x, (axis,))

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def reduce_from(x: torch.Tensor, mesh: ProcessMesh, axis: str) -> torch.Tensor:
    return _ReduceFrom.apply(x, mesh, axis)


def make_mesh(config: MeshConfig | dict[str, int] | None = None, *,
              device=None) -> ProcessMesh:
    """This rank's `ProcessMesh` over the ranks of the default process
    group (one rank, world 1, when no group is initialized).

    ``config`` resolves over the world size as `MeshConfig.resolve` does
    (None: every rank on fsdp, as the JAX default). dp, fsdp and tp may
    span processes; sp, ep or pp > 1 raise `NotImplementedError` (ROADMAP
    queue 1, "process-spanning axes"): inside a rank the sp, ep and pp
    meshes are `device_mesh` lists. ``device``: the rank's device, by
    default the train session's (`train.session.get_device`), else cuda
    (raises without a GPU). Every rank must call this together: it
    creates the process groups of every set of live axes, in one order
    on every rank."""
    from ray_tpu_torch._device import resolve_device

    import torch.distributed as dist

    joined = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if joined else 1
    rank = dist.get_rank() if joined else 0
    if config is None:
        config = MeshConfig(dp=1, fsdp=-1, sp=1, tp=1)
    if isinstance(config, MeshConfig):
        sizes = config.resolve(world)
    else:
        sizes = dict(config)
        for ax in MESH_AXES:
            sizes.setdefault(ax, 1)
        sizes = MeshConfig(**{k: sizes[k] for k in MESH_AXES}).resolve(world)
    for ax in MESH_AXES:
        if ax not in PROCESS_AXES and sizes[ax] > 1:
            raise NotImplementedError(
                f"{ax}={sizes[ax]} across processes is not ported (ROADMAP "
                "queue 1, the process-spanning axes); a rank's own sp, ep "
                "and pp meshes are device_mesh lists")
    if device is None:
        from ray_tpu_torch.train import session

        if session.active() and session.get_device() is not None:
            device = session.get_device()
    device = resolve_device(device)
    live = [ax for ax in PROCESS_AXES if sizes[ax] > 1]
    groups = {}
    for n in range(1, len(live) + 1):
        for axes in itertools.combinations(live, n):
            if n > 1 and n == len(live):
                continue            # every live axis: the default group
            # Every rank creates every group of these axes, in one order.
            members: dict[tuple, list[int]] = {}
            for r in range(world):
                c = mesh_coords(r, sizes)
                members.setdefault(tuple(v for a, v in c.items()
                                         if a not in axes), []).append(r)
            for ranks in members.values():
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[axes[0] if n == 1 else axes] = g
    return ProcessMesh(sizes, rank, device, groups,
                       dist.get_backend() if joined else None)


def single_device_mesh(device=None) -> ProcessMesh:
    """A world-1 `ProcessMesh` on ``device`` (cuda by default; raises
    without a GPU): every axis of size 1, no process group."""
    from ray_tpu_torch._device import resolve_device

    return ProcessMesh(MeshConfig(dp=1, fsdp=1).resolve(1), 0,
                       resolve_device(device), {}, None)


def replicated(mesh: ProcessMesh) -> Sharding:
    """The whole array on every rank."""
    return mesh.sharding(())


def batch_sharding(mesh: ProcessMesh) -> Sharding:
    """A [batch, ...] array split on batch over dp and fsdp: this rank's
    rows (`Sharding.shard` takes them from the global batch)."""
    return mesh.sharding((DATA_AXES,))


__all__ = ["DATA_AXES", "DEFAULT_LOGICAL_RULES", "MESH_AXES",
           "PIPELINE_LOGICAL_RULES", "PROCESS_AXES", "CollectiveStats",
           "MeshConfig", "ProcessMesh", "Sharding", "Split", "axis_shards",
           "batch_sharding", "device_mesh", "gather_leaf",
           "make_mesh", "mesh_coords", "reduce_from", "reduce_shards",
           "replicated", "single_device_mesh"]
