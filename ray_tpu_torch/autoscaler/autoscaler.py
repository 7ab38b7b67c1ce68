"""StandardAutoscaler: reconcile cluster size against resource demand.

Counterpart of ``ray_tpu/autoscaler/autoscaler.py`` on the port's runtime;
importing it imports no torch.

Parity: `python/ray/autoscaler/_private/autoscaler.py:162`
(update loop) + `resource_demand_scheduler.py:171` (get_nodes_to_launch —
first-fit bin-packing of pending demand onto existing free capacity, then
onto hypothetical new nodes) + idle-node scale-down.

Demand comes from the GCS cluster view: every raylet heartbeats the
resource shapes of its queued lease requests (`pending_demand`). The
autoscaler packs those shapes onto the free capacity of alive nodes; what
doesn't fit drives launches, bounded per type by min/max_workers. Nodes
idle (fully free + no demand) longer than `idle_timeout_s` are terminated,
respecting min_workers.
"""

from __future__ import annotations

import logging
import time
from typing import Any

from ray_tpu_torch.autoscaler.node_provider import NodeProvider, NodeType
from ray_tpu_torch.core.config import Config

logger = logging.getLogger(__name__)

# GCS KV (namespace, key) where a running autoscaler advertises the
# resources of the node types it can launch, and how long an
# advertisement counts: a raylet queues a lease no live node can run
# while a fresh one names a type that could (core/raylet.py).
ADVERTISE_KEY = ("autoscaler", "node_types")
ADVERTISE_TTL_S = 30.0


def _fits(shape: dict, free: dict) -> bool:
    return all(free.get(k, 0.0) >= v for k, v in shape.items())


def _consume(shape: dict, free: dict) -> None:
    for k, v in shape.items():
        free[k] = free.get(k, 0.0) - v


def get_nodes_to_launch(
    demand: list[dict],
    free_capacities: list[dict],
    node_types: list[NodeType],
    counts_by_type: dict[str, int],
) -> dict[str, int]:
    """First-fit pack demand onto existing free capacity; unmet shapes are
    packed onto hypothetical nodes of each type in order, respecting
    max_workers. → {type name: count to launch}."""
    free = [dict(f) for f in free_capacities]
    unmet: list[dict] = []
    for shape in demand:
        for f in free:
            if _fits(shape, f):
                _consume(shape, f)
                break
        else:
            unmet.append(shape)

    to_launch: dict[str, int] = {}
    virtual: list[tuple[NodeType, dict]] = []
    for shape in unmet:
        placed = False
        for _, vfree in virtual:
            if _fits(shape, vfree):
                _consume(shape, vfree)
                placed = True
                break
        if placed:
            continue
        for nt in node_types:
            current = counts_by_type.get(nt.name, 0) + to_launch.get(nt.name, 0)
            if current >= nt.max_workers:
                continue
            if _fits(shape, dict(nt.resources)):
                vfree = dict(nt.resources)
                _consume(shape, vfree)
                virtual.append((nt, vfree))
                to_launch[nt.name] = to_launch.get(nt.name, 0) + 1
                placed = True
                break
        if not placed:
            logger.warning("demand shape %s is infeasible on all node types",
                           shape)
    return to_launch


class StandardAutoscaler:
    def __init__(self, provider: NodeProvider, node_types: list[NodeType],
                 *, idle_timeout_s: float = 60.0,
                 gcs_address: tuple[str, int] | None = None):
        self.provider = provider
        self.node_types = {nt.name: nt for nt in node_types}
        self.idle_timeout_s = idle_timeout_s
        self.gcs_address = gcs_address
        self._idle_since: dict[str, float] = {}
        # Launched but not yet registered in the GCS view: their capacity is
        # credited to bin-packing so each reconcile pass doesn't re-launch
        # for the same unmet demand (ref: resource_demand_scheduler pending
        # node accounting).
        self._booting: dict[str, tuple[str, float]] = {}  # id → (type, t0)
        self.boot_timeout_s = Config.from_env().autoscaler_boot_timeout_s

    # ---- inputs ----

    def _cluster_view(self) -> dict:
        """The GCS's cluster view, after advertising this autoscaler's
        node types there (`ADVERTISE_KEY`): a raylet queues a lease that
        no live node can run, as demand, while a fresh advertisement
        names a node type that could (the reference's raylets fail such
        a lease at once, so its autoscaler never sees that demand)."""
        import asyncio

        from ray_tpu_torch.core import rpc
        from ray_tpu_torch.core.config import Config

        async def go():
            conn = await rpc.connect(
                *self.gcs_address,
                timeout=Config.from_env().rpc_connect_timeout_s)
            try:
                await conn.call("kv_put", {
                    "ns": ADVERTISE_KEY[0], "key": ADVERTISE_KEY[1],
                    "value": {"at": time.time(), "node_types": [
                        dict(nt.resources) for nt in self.node_types.values()
                        if nt.max_workers > 0]}})
                return await conn.call("get_cluster_view", {})
            finally:
                await conn.close()

        return asyncio.run(go())

    # ---- one reconcile step ----

    def update(self, view: dict | None = None) -> dict[str, Any]:
        """One reconcile pass; `view` injectable for tests. Returns a
        summary of the actions taken."""
        if view is None:
            view = self._cluster_view()
        alive = {nid: n for nid, n in view.items() if n.get("alive", True)}
        demand = [s for n in alive.values()
                  for s in n.get("pending_demand", [])]
        free = [dict(n.get("resources_available", {}))
                for n in alive.values()]
        # Booting nodes: drop ones now visible (or timed out), credit the
        # rest as free capacity.
        now0 = time.monotonic()
        registered = {(n.get("labels") or {}).get("provider_node_id")
                      for n in alive.values()}
        for nid in list(self._booting):
            tname, t0 = self._booting[nid]
            if nid in registered or now0 - t0 > self.boot_timeout_s:
                del self._booting[nid]
        free += [dict(self.node_types[t].resources)
                 for t, _ in self._booting.values()]

        # Ensure min_workers.
        counts: dict[str, int] = {}
        for nid in self.provider.non_terminated_nodes():
            t = self.provider.node_type(nid)
            counts[t] = counts.get(t, 0) + 1
        launched: list[str] = []
        for nt in self.node_types.values():
            while counts.get(nt.name, 0) < nt.min_workers:
                nid = self.provider.create_node(nt)
                launched.append(nid)
                self._booting[nid] = (nt.name, now0)
                counts[nt.name] = counts.get(nt.name, 0) + 1

        # Scale up for unmet demand.
        plan = get_nodes_to_launch(
            demand, free, list(self.node_types.values()), counts)
        for type_name, n in plan.items():
            nt = self.node_types[type_name]
            for _ in range(n):
                nid = self.provider.create_node(nt)
                launched.append(nid)
                self._booting[nid] = (type_name, now0)
                counts[type_name] = counts.get(type_name, 0) + 1

        # Scale down idle provider nodes (fully free, no demand anywhere).
        terminated: list[str] = []
        now = time.monotonic()
        if not demand:
            idle_provider_nodes = self._find_idle(alive)
            # A node that went busy restarts its idle clock from scratch.
            for nid in list(self._idle_since):
                if nid not in idle_provider_nodes:
                    del self._idle_since[nid]
            for nid in idle_provider_nodes:
                since = self._idle_since.setdefault(nid, now)
                t = self.provider.node_type(nid)
                if (now - since >= self.idle_timeout_s
                        and counts.get(t, 0) >
                        self.node_types[t].min_workers):
                    self.provider.terminate_node(nid)
                    self._idle_since.pop(nid, None)
                    counts[t] -= 1
                    terminated.append(nid)
        else:
            self._idle_since.clear()
        return {"launched": launched, "terminated": terminated,
                "demand": len(demand)}

    def _find_idle(self, alive: dict) -> list[str]:
        """Provider nodes whose cluster-side twin is fully free.

        Matching is by the `provider_node_id` label the provider stamps on
        nodes it launches; unlabeled provider nodes (e.g. MockProvider in
        logic tests with no real cluster twin) fall back to a conservative
        resource-profile match: idle only if every alive node with that
        profile is fully free.
        """
        by_label: dict[str, dict] = {}
        fully_free_profiles = []
        busy_profiles = []
        for n in alive.values():
            pid = (n.get("labels") or {}).get("provider_node_id")
            if pid:
                by_label[pid] = n
            total = n.get("resources_total", {})
            availd = n.get("resources_available", {})
            profile = tuple(sorted(total.items()))
            if total == availd and not n.get("pending_demand"):
                fully_free_profiles.append(profile)
            else:
                busy_profiles.append(profile)
        idle = []
        for nid in self.provider.non_terminated_nodes():
            twin = by_label.get(nid)
            if twin is not None:
                if (twin.get("resources_total") ==
                        twin.get("resources_available")
                        and not twin.get("pending_demand")):
                    idle.append(nid)
                continue
            nt = self.node_types[self.provider.node_type(nid)]
            profile = tuple(sorted(
                {k: float(v) for k, v in nt.resources.items()}.items()))
            if profile in fully_free_profiles and profile not in busy_profiles:
                idle.append(nid)
        return idle
