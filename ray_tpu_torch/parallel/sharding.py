"""Logical-axis → partition-spec machinery (re-export).

Counterpart of ``ray_tpu/parallel/sharding.py``: the implementation
lives in ``ray_tpu_torch.models.partition`` (one spec-derivation
module, the serving rule tables beside the logical-axis resolution);
this module is the train stack's import path.
"""

from __future__ import annotations

from ray_tpu_torch.models.partition import (  # noqa: F401
    logical_to_spec,
    shard_tree,
    tree_to_shardings,
)

__all__ = ["logical_to_spec", "tree_to_shardings", "shard_tree"]
