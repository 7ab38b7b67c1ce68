"""Scheduling strategy classes.

Parity: `python/ray/util/scheduling_strategies.py` —
`NodeAffinitySchedulingStrategy` pins a task/actor to a node (soft=True
degrades to best-effort), `PlacementGroupSchedulingStrategy` targets a PG
bundle. The raylet consumes these duck-typed (api._strategy_payload).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass
class NodeAffinitySchedulingStrategy:
    node_id: str
    soft: bool = False


@dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: Any
    placement_group_bundle_index: int = -1


__all__ = [
    "NodeAffinitySchedulingStrategy",
    "PlacementGroupSchedulingStrategy",
]
