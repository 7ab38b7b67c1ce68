"""Placement groups — gang scheduling API.

Parity: `python/ray/util/placement_group.py` + the
GCS/raylet two-phase bundle reservation (`gcs_placement_group_manager.cc`,
`node_manager.proto:377-384` PrepareBundle/CommitBundle). Strategies
PACK/SPREAD/STRICT_PACK/STRICT_SPREAD (`common.proto:758-765`).

TPU mapping: STRICT_PACK ≈ "same slice/host" (ICI-adjacent — all bundles
on one node), SPREAD/STRICT_SPREAD ≈ across hosts (DCN). Creation is
synchronous 2PC at the GCS: bundles are carved out of node capacity before
the call returns, and tasks/actors scheduled with
PlacementGroupSchedulingStrategy lease from those reservations.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ray_tpu_torch.core.ids import PlacementGroupID

PACK, SPREAD, STRICT_PACK, STRICT_SPREAD = (
    "PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD",
)


@dataclass
class PlacementGroup:
    id: PlacementGroupID
    bundles: list[dict[str, float]]
    strategy: str = PACK
    bundle_placements: list[dict] = field(default_factory=list)

    def ready(self):
        """ObjectRef resolving to True once reserved (already true: creation
        is synchronous)."""
        from ray_tpu_torch import api

        return api.put(True)

    def wait(self, timeout: float = 30.0) -> bool:
        return True

    @property
    def bundle_count(self) -> int:
        return len(self.bundles)


def placement_group(
    bundles: list[dict[str, float]], strategy: str = PACK, name: str = ""
) -> PlacementGroup:
    if strategy not in (PACK, SPREAD, STRICT_PACK, STRICT_SPREAD):
        raise ValueError(f"unknown strategy {strategy}")
    from ray_tpu_torch import api

    client = api._ensure_client()
    pg_id = PlacementGroupID.from_random()
    reply = client.create_placement_group(
        pg_id.binary(), [dict(b) for b in bundles], strategy, name)
    if not reply.get("ok"):
        raise RuntimeError(
            f"placement group creation failed: {reply.get('error')}")
    return PlacementGroup(
        id=pg_id, bundles=list(bundles), strategy=strategy,
        bundle_placements=reply["bundles"],
    )


def remove_placement_group(pg: PlacementGroup) -> None:
    from ray_tpu_torch import api

    client = api._ensure_client()
    client.remove_placement_group(pg.id.binary())


def list_placement_groups() -> list[dict]:
    from ray_tpu_torch import api

    client = api._ensure_client()
    return client.list_placement_groups()
