"""The logical-axis rules and single-controller device meshes.

Counterpart of the part of ``ray_tpu/parallel/mesh.py`` the port needs:
`DEFAULT_LOGICAL_RULES` (read by
``models/partition.py::logical_to_spec`` and the memory audit). The
port's meshes are single-controller, as its tensor-parallel engine is:
a mesh is a plain list of devices, one per shard, and a device may
repeat (the shards then run in turn on it, the counterpart of the
forced host-device count of the JAX tests). `device_mesh` builds one.
"""

from __future__ import annotations

from typing import Any

import torch

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


def device_mesh(n: int, *, axis: str, devices=None) -> list[torch.device]:
    """``n`` devices, one per shard of mesh axis ``axis``. By default the
    first ``n`` visible CUDA devices (raises when there are fewer); an
    explicit ``devices`` list may repeat a device."""
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


__all__ = ["DEFAULT_LOGICAL_RULES", "device_mesh"]
