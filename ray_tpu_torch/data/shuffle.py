"""Push-based distributed shuffle: pipelined map → merge → reduce.

Counterpart of ``ray_tpu/data/shuffle.py`` on the port's runtime
(parity: ``python/ray/data/_internal/push_based_shuffle.py:22``):
instead of fanning out all M×N intermediate partitions at once and
merging at the end (a "simple shuffle", which floods the cluster with
tiny objects and keeps them all alive until the final merge), map tasks
run in ROUNDS; each round's partition columns are merged immediately by
merge tasks pinned (soft node affinity) to the node that will run that
output partition's reduce. Intermediates from a round are dropped as
soon as its merges land, so the distributed ref counter reclaims them
while later rounds still run; in-flight rounds are bounded for
backpressure.

The driver only ever holds ObjectRefs and scheduling metadata — block
data never moves through it.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable

import ray_tpu_torch as rt


class ShuffleStats:
    def __init__(self):
        self.map_tasks = 0
        self.merge_tasks = 0
        self.reduce_tasks = 0
        self.rounds = 0
        self.wall_s = 0.0

    def summary(self) -> dict:
        return {
            "map_tasks": self.map_tasks,
            "merge_tasks": self.merge_tasks,
            "reduce_tasks": self.reduce_tasks,
            "rounds": self.rounds,
            "wall_s": round(self.wall_s, 3),
        }


def _reducer_nodes(n_out: int) -> list[bytes | None]:
    """Assign each output partition a home node (round-robin over alive
    nodes) so merge tasks for that partition colocate with its reduce
    (ref: push_based_shuffle merge-factor scheduling)."""
    try:
        nodes = [n for n in rt.nodes() if n["Alive"]]
    except Exception:
        nodes = []
    if not nodes:
        return [None] * n_out
    return [bytes.fromhex(nodes[j % len(nodes)]["NodeID"])
            for j in range(n_out)]


class _NodeAffinity:
    def __init__(self, node_id: bytes, soft: bool = True):
        self.node_id = node_id
        self.soft = soft


def push_based_shuffle(
    refs: list,
    n_out: int,
    partition_task: Any,
    merge_task: Any,
    *,
    partition_args: Callable[[int, Any], tuple] | None = None,
    round_size: int | None = None,
    max_rounds_in_flight: int = 2,
    stats: ShuffleStats | None = None,
) -> list:
    """Run the two-phase pipelined shuffle.

    - `partition_task.options(num_returns=n_out).remote(*partition_args(i,
      ref))` must return n_out partition blocks for input block i.
    - `merge_task.remote(*parts)` concatenates blocks.
    Returns one ref per output partition (the reduce output: a final merge
    of that partition's per-round merges).
    """
    t0 = time.monotonic()
    st = stats or ShuffleStats()
    if not refs:
        return []
    if partition_args is None:
        partition_args = lambda i, r: (r,)  # noqa: E731
    homes = _reducer_nodes(n_out)

    def merge_for(j: int):
        if homes[j] is None:
            return merge_task
        return merge_task.options(
            scheduling_strategy=_NodeAffinity(homes[j], soft=True))
    if round_size is None:
        # Reference heuristic flavor: a round's merge fan-in ("merge
        # factor") of ~2-4 map outputs per merge keeps merge inputs small
        # and the pipeline busy.
        round_size = max(1, min(len(refs), 2 * max(1, n_out // 2)))
    rounds = [refs[i:i + round_size]
              for i in range(0, len(refs), round_size)]
    merged_per_out: list[list] = [[] for _ in range(n_out)]
    in_flight: list[list] = []
    gi = 0  # global input-block index (seeds etc. key off it)
    for round_refs in rounds:
        st.rounds += 1
        parts = []
        for r in round_refs:
            parts.append(partition_task.options(num_returns=n_out).remote(
                *partition_args(gi, r)))
            gi += 1
        st.map_tasks += len(parts)
        if n_out == 1:
            parts = [[p] if not isinstance(p, list) else p for p in parts]
        round_merges = []
        for j in range(n_out):
            col = [parts[i][j] for i in range(len(parts))]
            round_merges.append(merge_for(j).remote(*col))
        st.merge_tasks += n_out
        # `parts` drop out of scope here: once a round's merges consume
        # them, the ref counter reclaims the M×N intermediates while later
        # rounds still run.
        for j, m in enumerate(round_merges):
            merged_per_out[j].append(m)
        in_flight.append(round_merges)
        if len(in_flight) >= max_rounds_in_flight:
            oldest = in_flight.pop(0)
            rt.wait(oldest, num_returns=len(oldest), timeout=600)
    out = []
    for j in range(n_out):
        ms = merged_per_out[j]
        if len(ms) == 1:
            out.append(ms[0])
            continue
        out.append(merge_for(j).remote(*ms))
        st.reduce_tasks += 1
    st.wall_s = time.monotonic() - t0
    return out
