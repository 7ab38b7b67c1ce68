"""GCS — cluster control plane (one per cluster).

Parity with the reference's GcsServer (`src/ray/gcs/
gcs_server/gcs_server.h:74`): node membership + death broadcast, health
checks, actor directory + lifecycle + central actor scheduling, jobs, KV
store, pubsub hub, cluster resource view, and (here) an object-location
directory. Runs as its own process with an asyncio loop; all state is
in-memory (a persistence backend mirrors gcs/store_client/ and can be added
behind `KvBackend`).
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any

from ray_tpu_torch.core import rpc
from ray_tpu_torch.core.config import Config
from ray_tpu_torch.core.ids import ActorID, JobID, NodeID
from ray_tpu_torch.utils.aio import spawn

logger = logging.getLogger(__name__)

# Actor lifecycle states (ref: gcs_actor_manager.cc FSM)
PENDING, ALIVE, RESTARTING, DEAD = "PENDING", "ALIVE", "RESTARTING", "DEAD"


@dataclass
class NodeInfo:
    node_id: bytes
    address: tuple[str, int]          # raylet RPC endpoint
    resources_total: dict[str, float]
    resources_available: dict[str, float]
    labels: dict[str, str] = field(default_factory=dict)
    alive: bool = True
    last_heartbeat: float = field(default_factory=time.monotonic)
    load: int = 0                     # queued lease requests
    pending_demand: list = field(default_factory=list)  # their resource shapes
    # Monotonic per-entry update stamp for delta sync (ref: ray_syncer.h:
    # 42-60 versioned reporter/receiver): bumped only on MATERIAL change,
    # so an idle cluster generates zero view traffic.
    version: int = 0


@dataclass
class ActorInfo:
    actor_id: bytes
    name: str | None
    state: str
    node_id: bytes | None = None
    address: tuple[str, int] | None = None   # owning worker RPC endpoint
    num_restarts: int = 0
    max_restarts: int = 0
    max_task_retries: int = 0
    create_spec: bytes | None = None          # serialized creation task
    owner_address: tuple[str, int] | None = None
    death_cause: str | None = None
    resources: dict[str, float] = field(default_factory=dict)
    placing: bool = False                     # a client is driving placement
    placing_since: float = 0.0


class GcsServer:
    def __init__(self, config: Config, host: str = "127.0.0.1", port: int = 0,
                 snapshot_path: str | None = None):
        self.config = config
        self.snapshot_path = snapshot_path
        self.server = rpc.Server(host, port)
        # Structured cluster event log (ref: src/ray/util/event.h +
        # dashboard/modules/event): bounded ring of {seq, ts, severity,
        # source, type, message, **extra} records for post-mortems —
        # node/actor lifecycle, OOM kills, PG churn. Raylets/workers
        # append via "event_add"; consumers page with "events_get".
        import collections as _collections

        self.events: _collections.deque = _collections.deque(maxlen=10_000)
        self._event_seq = 0
        self.nodes: dict[bytes, NodeInfo] = {}
        self.actors: dict[bytes, ActorInfo] = {}
        self.named_actors: dict[str, bytes] = {}
        self.kv: dict[str, dict[bytes, bytes]] = {}
        self.object_dir: dict[bytes, set[bytes]] = {}
        self.subscribers: dict[str, set[rpc.Connection]] = {}
        self._job_counter = 0
        self._node_conns: dict[bytes, rpc.Connection] = {}
        # pg_id → {"bundles": [{"index", "resources", "node_id"}],
        #          "strategy", "state", "name"}
        self.placement_groups: dict[bytes, dict] = {}
        # Observability (ref: gcs_service.proto AddProfileData; metrics hub)
        self.profile_events: list = []
        # Cluster-wide drop tally: per-process buffer drops reported by
        # flushes + events this table itself had no room for.
        self.profile_events_dropped = 0
        # source → last applied batch seq: a flusher retrying a batch whose
        # first attempt timed out AFTER applying must not double-insert.
        self.profile_seq_by_source: dict[str, int] = {}
        # Incremental trace views, maintained at insert time so polled
        # trace endpoints are O(result), not an O(table) scan on the
        # control-plane event loop.
        self.profile_by_trace: dict[str, list] = {}
        self.trace_summaries: dict[str, dict] = {}
        # source → (last push wall time, rows). Sources are per-session
        # (each driver run flushes under a fresh nonce): without expiry the
        # hub would grow one snapshot per job forever and keep exporting
        # dead drivers' stale gauges — see _sweep_stale_sources.
        self.metrics_by_source: dict[str, tuple[float, list]] = {}
        # Final counter/histogram rows of expired sources (totals must
        # survive their process); stale gauges are dropped with the source.
        self.metrics_retired: list[dict] = []
        # Rolling time-series store (obs_series.py): every metrics_push
        # additionally lands in bounded per-(name, tags, source) rings so
        # the decision plane (shadow autoscaler, SLO restart seeding,
        # `status --serve --history`) can query trends via series_query.
        # Memory is fixed: max_series × points; series of expired sources
        # or removed replicas tombstone and are swept after the TTL.
        from ray_tpu_torch.obs_series import SeriesStore

        self.series = SeriesStore(
            max_points=config.obs_series_points,
            resolution_s=config.obs_series_resolution_s,
            max_series=config.obs_series_max_series,
            tombstone_ttl_s=config.obs_series_tombstone_ttl_s)
        # ---- distributed ref counting (ref: reference_count.h) ----
        # Runtime state, deliberately NOT snapshotted: holders re-register
        # their full held sets on reconnect after a GCS failover.
        self.ref_holders: dict[bytes, set[bytes]] = {}   # obj → holder ids
        self.holder_objs: dict[bytes, set[bytes]] = {}   # holder → objs
        self.holder_conns: dict[bytes, rpc.Connection] = {}
        self.contained: dict[bytes, list[bytes]] = {}    # outer → inner objs
        # obj → owner holder id (its creator): recovery requests from
        # borrowers' failed pulls route here (object_recovery_manager parity).
        self.obj_owner: dict[bytes, bytes] = {}
        # Tombstones: recently freed ids; a late location announce for one of
        # these is answered with an immediate free (stragglers: replicas
        # sealing after the free broadcast).
        self._freed_recent: dict[bytes, float] = {}
        self._wal_f = None
        self._dirty = False
        self._view_version = 0
        self._register_handlers()

    # ---------- pubsub ----------

    def record_event(self, type_: str, message: str, *,
                     severity: str = "INFO", source: str = "gcs",
                     **extra) -> None:
        self._event_seq += 1
        self.events.append({
            "seq": self._event_seq, "ts": time.time(),
            "severity": severity, "source": source, "type": type_,
            "message": message, **extra,
        })

    async def _h_event_add(self, conn, p):
        self.record_event(
            p.get("type", "custom"), p.get("message", ""),
            severity=p.get("severity", "INFO"),
            source=p.get("source", "unknown"),
            **{k: v for k, v in p.items()
               if k not in ("type", "message", "severity", "source",
                            "seq", "ts")})
        return {"ok": True}

    async def _h_events_get(self, conn, p):
        after = p.get("after_seq", 0)
        limit = p.get("limit", 1000)
        out = [e for e in self.events if e["seq"] > after]
        # Forward-cursor paging: oldest-first after the cursor, so a
        # consumer advancing after_seq never skips backlog events.
        # tail=True flips to the newest `limit` rows (dashboard view) so
        # watchers don't have to transfer the whole ring per poll.
        if limit and limit > 0:
            out = out[-limit:] if p.get("tail") else out[:limit]
        return {"events": out, "latest_seq": self._event_seq}

    def publish(self, channel: str, msg: Any) -> None:
        dead = []
        for conn in self.subscribers.get(channel, ()):  # long-poll parity:
            if conn.closed:
                dead.append(conn)
                continue
            conn.notify("pub:" + channel, msg)
        for conn in dead:
            self.subscribers.get(channel, set()).discard(conn)

    # ---------- handlers ----------

    def _register_handlers(self) -> None:
        s = self.server
        s.register("register_node", self._register_node)
        s.register("heartbeat", self._heartbeat)
        s.register("get_cluster_view", self._get_cluster_view)
        s.register("get_view_delta", self._get_view_delta)
        s.register("drain_node", self._drain_node)
        s.register("subscribe", self._subscribe)
        s.register("publish", self._publish_rpc)
        s.register("next_job_id", self._next_job_id)
        s.register("kv_put", self._kv_put)
        s.register("kv_get", self._kv_get)
        s.register("kv_del", self._kv_del)
        s.register("kv_keys", self._kv_keys)
        s.register("register_actor", self._register_actor)
        s.register("actor_started", self._actor_started)
        s.register("actor_failed", self._actor_failed)
        s.register("kill_actor", self._kill_actor)
        s.register("get_actor", self._get_actor)
        s.register("list_actors", self._list_actors)
        s.register("obj_loc_add", self._obj_loc_add)
        s.register("obj_loc_remove", self._obj_loc_remove)
        s.register("obj_loc_get", self._obj_loc_get)
        s.register("obj_free", self._obj_free)
        s.register("ref_register_holder", self._ref_register_holder)
        s.register("ref_update", self._ref_update)
        s.register("ref_revive", self._ref_revive)
        s.register("obj_request_recovery", self._obj_request_recovery)
        s.register("ref_debug", self._ref_debug)
        s.register("pg_create", self._pg_create)
        s.register("pg_remove", self._pg_remove)
        s.register("pg_get", self._pg_get)
        s.register("pg_list", self._pg_list)
        s.register("event_add", self._h_event_add)
        s.register("events_get", self._h_events_get)
        s.register("profile_add", self._profile_add)
        s.register("profile_get", self._profile_get)
        s.register("profile_stats", self._profile_stats)
        s.register("profile_traces", self._profile_traces)
        s.register("metrics_push", self._metrics_push)
        s.register("metrics_get", self._metrics_get)
        s.register("series_query", self._series_query)
        s.on_disconnect(self._handle_disconnect)

    async def _register_node(self, conn, p):
        node_id = p["node_id"]
        info = NodeInfo(
            node_id=node_id,
            address=tuple(p["address"]),
            resources_total=dict(p["resources"]),
            resources_available=dict(p["resources"]),
            labels=p.get("labels", {}),
        )
        self._view_version += 1
        info.version = self._view_version
        self.nodes[node_id] = info
        self._node_conns[node_id] = conn
        # Re-registration after GCS failover: the raylet re-announces the
        # objects it still holds so the object directory heals.
        for ob in p.get("objects", ()):
            self.object_dir.setdefault(ob, set()).add(node_id)
        logger.info("node %s registered at %s", node_id.hex()[:8], info.address)
        import dataclasses

        self._wal_append(("node", dataclasses.asdict(info)))
        self.publish("node", {"event": "added", "node_id": node_id,
                              "address": info.address,
                              "resources": info.resources_total})
        self.record_event(
            "NODE_ADDED", f"node {node_id.hex()[:8]} joined",
            node_id=node_id.hex(), address=list(info.address),
            resources=info.resources_total)
        return {"ok": True}

    async def _heartbeat(self, conn, p):
        info = self.nodes.get(p["node_id"])
        if info is None:
            return {"ok": False, "reregister": True}
        info.last_heartbeat = time.monotonic()
        changed = (
            info.resources_available != p["resources_available"]
            or info.load != p.get("load", 0)
            or info.pending_demand != p.get("pending_demand", [])
            or not info.alive
        )
        info.resources_available = p["resources_available"]
        info.load = p.get("load", 0)
        info.pending_demand = p.get("pending_demand", [])
        info.alive = True
        if changed:
            self._view_version += 1
            info.version = self._view_version
        return {"ok": True, "view_version": self._view_version}

    @staticmethod
    def _node_view(n: NodeInfo) -> dict:
        return {
            "address": n.address,
            "resources_total": n.resources_total,
            "resources_available": n.resources_available,
            "alive": n.alive,
            "load": n.load,
            "pending_demand": n.pending_demand,
            "labels": n.labels,
        }

    async def _get_cluster_view(self, conn, p):
        return {nid: self._node_view(n) for nid, n in self.nodes.items()}

    async def _get_view_delta(self, conn, p):
        """Versioned view sync (ref: ray_syncer.h versioned gossip): only
        entries stamped after `since` ship — replacing the r1 raylets'
        full-view re-pull every heartbeat (O(nodes²) bytes)."""
        since = p.get("since", 0)
        return {
            "version": self._view_version,
            "nodes": {nid: self._node_view(n)
                      for nid, n in self.nodes.items()
                      if n.version > since},
        }

    async def _drain_node(self, conn, p):
        self._mark_node_dead(p["node_id"], "drained")
        return {"ok": True}

    async def _subscribe(self, conn, p):
        for channel in p["channels"]:
            self.subscribers.setdefault(channel, set()).add(conn)
        return {"ok": True}

    async def _publish_rpc(self, conn, p):
        """Application-level pubsub (ref: pubsub_handler.cc GCS channels):
        any client may publish; subscribers get `pub:<channel>` notifies —
        the push fan-out used by e.g. Serve's routing-table invalidation
        (long_poll.py parity)."""
        self.publish(p["channel"], p["message"])
        return {"ok": True}

    async def _next_job_id(self, conn, p):
        self._job_counter += 1
        self._wal_append(("job", self._job_counter))
        return JobID.from_int(self._job_counter).binary()

    # ---------- KV (ref: gcs_kv_manager.cc) ----------

    # ---------- placement groups ----------
    # (ref: gcs_placement_group_manager.cc + gcs_placement_group_scheduler.cc
    #  two-phase bundle reservation; strategies common.proto:758-765)

    def _place_bundles(self, bundles: list[dict], strategy: str):
        """→ list of node_ids per bundle, or None if infeasible. Packing is
        simulated against a copy of each node's available resources."""
        alive = [(nid, dict(n.resources_available))
                 for nid, n in self.nodes.items() if n.alive]
        if not alive:
            return None

        def fits(free, res):
            return all(free.get(k, 0) >= v for k, v in res.items())

        def consume(free, res):
            for k, v in res.items():
                free[k] = free.get(k, 0) - v

        placement: list[bytes] = []
        if strategy in ("PACK", "STRICT_PACK"):
            # Try to fit the whole group on one node (STRICT requires it).
            for nid, free in alive:
                trial = dict(free)
                ok = True
                for b in bundles:
                    if not fits(trial, b):
                        ok = False
                        break
                    consume(trial, b)
                if ok:
                    return [nid] * len(bundles)
            if strategy == "STRICT_PACK":
                return None
            # PACK fallback: greedy first-fit across nodes.
            for b in bundles:
                for nid, free in alive:
                    if fits(free, b):
                        consume(free, b)
                        placement.append(nid)
                        break
                else:
                    return None
            return placement
        # SPREAD / STRICT_SPREAD: distinct nodes, round-robin.
        used: set[bytes] = set()
        for b in bundles:
            chosen = None
            for nid, free in alive:
                if nid in used or not fits(free, b):
                    continue
                chosen = (nid, free)
                break
            if chosen is None:
                if strategy == "STRICT_SPREAD":
                    return None
                for nid, free in alive:  # soft spread: reuse nodes
                    if fits(free, b):
                        chosen = (nid, free)
                        break
                if chosen is None:
                    return None
            consume(chosen[1], b)
            used.add(chosen[0])
            placement.append(chosen[0])
        return placement

    async def _pg_create(self, conn, p):
        pg_id = p["pg_id"]
        bundles = p["bundles"]
        strategy = p["strategy"]
        placement = self._place_bundles(bundles, strategy)
        if placement is None:
            return {"ok": False,
                    "error": f"infeasible: {strategy} {bundles}"}
        reserved: list[tuple[bytes, int]] = []
        for i, (node_id, res) in enumerate(zip(placement, bundles)):
            node_conn = self._node_conns.get(node_id)
            try:
                r = await node_conn.call("pg_reserve", {
                    "pg_id": pg_id, "bundle_index": i, "resources": res,
                }, timeout=self.config.rpc_default_timeout_s)
            except Exception as e:
                r = {"ok": False, "error": repr(e)}
            if not r.get("ok"):
                # Rollback phase-1 reservations.
                for node_id2, j in reserved:
                    c2 = self._node_conns.get(node_id2)
                    if c2 is not None:
                        try:
                            await c2.call("pg_return", {
                                "pg_id": pg_id, "bundle_index": j,
                            }, timeout=self.config.rpc_default_timeout_s)
                        except Exception as e:
                            # A lost rollback strands the bundle's resources
                            # on that raylet until its next resync.
                            logger.warning(
                                "pg %s rollback on node %s failed: %s",
                                pg_id.hex()[:12], node_id2.hex()[:12], e)
                return {"ok": False, "error": r.get("error", "reserve failed")}
            reserved.append((node_id, i))
            # Keep the GCS resource view in sync immediately (heartbeats
            # would catch up anyway).
            info = self.nodes.get(node_id)
            if info is not None:
                for k, v in res.items():
                    info.resources_available[k] = (
                        info.resources_available.get(k, 0) - v)
        self.placement_groups[pg_id] = {
            "bundles": [
                {"index": i, "resources": b, "node_id": nid}
                for i, (nid, b) in enumerate(zip(placement, bundles))
            ],
            "strategy": strategy,
            "state": "CREATED",
            "name": p.get("name", ""),
        }
        self._wal_append(("pg", pg_id, self.placement_groups[pg_id]))
        return {"ok": True, "bundles": self.placement_groups[pg_id]["bundles"]}

    async def _pg_remove(self, conn, p):
        pg = self.placement_groups.pop(p["pg_id"], None)
        if pg is None:
            return {"ok": False}
        self._wal_append(("pgdel", p["pg_id"]))
        for b in pg["bundles"]:
            node_conn = self._node_conns.get(b["node_id"])
            if node_conn is not None:
                try:
                    await node_conn.call("pg_return", {
                        "pg_id": p["pg_id"], "bundle_index": b["index"],
                    }, timeout=self.config.rpc_default_timeout_s)
                except Exception as e:
                    logger.warning(
                        "pg %s bundle %d return on node %s failed "
                        "(resources stranded until raylet resync): %s",
                        p["pg_id"].hex()[:12], b["index"],
                        b["node_id"].hex()[:12], e)
            # Keep the GCS view in sync (mirror of pg_create's decrement).
            info = self.nodes.get(b["node_id"])
            if info is not None:
                for k, v in b["resources"].items():
                    info.resources_available[k] = (
                        info.resources_available.get(k, 0) + v)
        return {"ok": True}

    async def _pg_get(self, conn, p):
        return self.placement_groups.get(p["pg_id"])

    async def _pg_list(self, conn, p):
        return [{"pg_id": pid, **pg}
                for pid, pg in self.placement_groups.items()]

    # ---------- observability ----------

    MAX_PROFILE_EVENTS = 200_000
    METRICS_SOURCE_TTL_S = 600.0
    MAX_RETIRED_METRIC_ROWS = 10_000

    def _index_profile_event(self, e: dict) -> None:
        """Fold one accepted event into the per-trace index + summary."""
        a = e.get("args") or {}
        trace_id = a.get("trace_id")
        if not trace_id:
            return
        self.profile_by_trace.setdefault(trace_id, []).append(e)
        end = e["ts"] + e.get("dur", 0)
        s = self.trace_summaries.get(trace_id)
        if s is None:
            s = self.trace_summaries[trace_id] = {
                "trace_id": trace_id, "num_spans": 0, "root": e["name"],
                "start_ts_us": e["ts"], "_end": end, "_root_ts": None,
            }
        s["num_spans"] += 1
        s["start_ts_us"] = min(s["start_ts_us"], e["ts"])
        s["_end"] = max(s["_end"], end)
        if not a.get("parent_span_id") and (
                s["_root_ts"] is None or e["ts"] < s["_root_ts"]):
            s["root"], s["_root_ts"] = e["name"], e["ts"]
        s["duration_s"] = round((s["_end"] - s["start_ts_us"]) / 1e6, 6)

    async def _profile_add(self, conn, p):
        source, seq = p.get("source"), p.get("seq")
        if source is not None and seq is not None:
            if seq <= self.profile_seq_by_source.get(source, 0):
                return {"ok": True, "dup": True}
            self.profile_seq_by_source[source] = seq
        events = p["events"]
        room = max(0, self.MAX_PROFILE_EVENTS - len(self.profile_events))
        accepted = events[:room] if room > 0 else []
        self.profile_events.extend(accepted)
        for e in accepted:
            self._index_profile_event(e)
        self.profile_events_dropped += (
            len(events) - len(accepted) + int(p.get("dropped", 0)))
        return {"ok": True}

    async def _profile_get(self, conn, p):
        trace_id = (p or {}).get("trace_id")
        # Server-side trace filter via the insert-time index: a polled
        # get_trace() costs O(trace), never an O(table) scan/transfer.
        events = (self.profile_events if trace_id is None
                  else self.profile_by_trace.get(trace_id, []))
        return {"events": events,
                "dropped": self.profile_events_dropped}

    async def _profile_stats(self, conn, p):
        """Tally-only view: pollers must not move the whole event table."""
        return {"count": len(self.profile_events),
                "dropped": self.profile_events_dropped}

    async def _profile_traces(self, conn, p):
        """Per-trace summary rows (newest first), maintained incrementally
        at insert time — only the small summaries go over the wire."""
        rows = [{k: v for k, v in s.items() if not k.startswith("_")}
                for s in self.trace_summaries.values()]
        rows.sort(key=lambda r: -r["start_ts_us"])
        return rows

    def _sweep_stale_sources(self) -> None:
        """Expire per-session metric sources (drivers come and go): their
        final counter/histogram rows are retired so totals survive, stale
        gauges drop, and the seq-dedupe entry is released."""
        now = time.time()
        for source, (ts, rows) in list(self.metrics_by_source.items()):
            if now - ts <= self.METRICS_SOURCE_TTL_S:
                continue
            self.metrics_retired.extend(
                {**r, "tags": {**r.get("tags", {}), "source": source}}
                for r in rows if r.get("kind") != "gauge")
            del self.metrics_by_source[source]
            self.profile_seq_by_source.pop(source, None)
            # The source's time series go with it: tombstone now (still
            # queryable for post-mortems), deleted after the series TTL —
            # a churny bench's dead replicas can't grow GCS memory.
            self.series.tombstone_source(source, now)
        self.series.sweep(now)
        if len(self.metrics_retired) > self.MAX_RETIRED_METRIC_ROWS:
            del self.metrics_retired[
                : len(self.metrics_retired) - self.MAX_RETIRED_METRIC_ROWS]

    async def _metrics_push(self, conn, p):
        # Latest snapshot per source process replaces the previous one.
        self.metrics_by_source[p["source"]] = (time.time(), p["rows"])
        # ... and additionally lands in the rolling series store (full
        # snapshot per source, so series missing from this push — e.g. a
        # gauge the pusher dropped for a removed replica — tombstone).
        self.series.record_rows(p["source"], p["rows"])
        return {"ok": True}

    async def _series_query(self, conn, p):
        """Windowed read of the rolling series store: name + tag-subset
        filter, points oldest-first. The read path drives the sweeps so
        an idle store still retires tombstoned series."""
        self._sweep_stale_sources()
        return self.series.query(
            name=(p or {}).get("name"), tags=(p or {}).get("tags"),
            window_s=(p or {}).get("window_s"))

    async def _metrics_get(self, conn, p):
        self._sweep_stale_sources()
        out = list(self.metrics_retired)
        for source, (_ts, rows) in self.metrics_by_source.items():
            for r in rows:
                out.append({**r, "tags": {**r.get("tags", {}),
                                          "source": source}})
        return out

    async def _kv_put(self, conn, p):
        ns = self.kv.setdefault(p.get("ns", ""), {})
        existed = p["key"] in ns
        if p.get("overwrite", True) or not existed:
            ns[p["key"]] = p["value"]
            self._wal_append(("kv", p.get("ns", ""), p["key"], p["value"]))
        return {"existed": existed}

    async def _kv_get(self, conn, p):
        return self.kv.get(p.get("ns", ""), {}).get(p["key"])

    async def _kv_del(self, conn, p):
        ns = self.kv.get(p.get("ns", ""), {})
        deleted = ns.pop(p["key"], None) is not None
        if deleted:
            self._wal_append(("kvdel", p.get("ns", ""), p["key"]))
        return {"deleted": deleted}

    async def _kv_keys(self, conn, p):
        prefix = p.get("prefix", b"")
        return [k for k in self.kv.get(p.get("ns", ""), {}) if k.startswith(prefix)]

    # ---------- actors (ref: gcs_actor_manager.cc, gcs_actor_scheduler.cc) ----------

    async def _register_actor(self, conn, p):
        actor_id = p["actor_id"]
        name = p.get("name")
        if name:
            existing = self.named_actors.get(name)
            if existing is not None and self.actors[existing].state != DEAD:
                return {"ok": False, "error": f"actor name {name!r} taken"}
        info = ActorInfo(
            actor_id=actor_id,
            name=name,
            state=PENDING,
            max_restarts=p.get("max_restarts", 0),
            max_task_retries=p.get("max_task_retries", 0),
            create_spec=p.get("create_spec"),
            owner_address=tuple(p["owner_address"]) if p.get("owner_address") else None,
            resources=dict(p.get("resources", {})),
        )
        self.actors[actor_id] = info
        if p.get("create_spec") is not None:
            # durable enough for restart-replay (ref: gcs keeps the creation
            # task spec to restart actors, gcs_actor_manager.cc)
            self.kv.setdefault("actor_spec", {})[actor_id] = p["create_spec"]
            self._wal_append(("kv", "actor_spec", actor_id, p["create_spec"]))
        if name:
            self.named_actors[name] = actor_id
        node = self._schedule_actor(p.get("resources", {}))
        if node is None:
            return {"ok": False, "error": "no feasible node for actor"}
        info.node_id = node.node_id
        self._deduct(node, p.get("resources", {}))
        self._wal_actor(info)
        return {"ok": True, "node_id": node.node_id, "node_address": node.address}

    def _schedule_actor(self, resources: dict[str, float]) -> NodeInfo | None:
        """Central actor scheduling: least-loaded feasible node
        (ref: gcs_actor_scheduler.cc:49).

        Live-actor count dominates the score: every actor pins a worker
        PROCESS, so tiny-resource actors must spread by process count, not
        by fractional resource arithmetic — ranking by available-resource
        sum alone parks every 0.001-CPU actor on the biggest node until it
        exhausts its worker cap (found by the many-actors envelope bench).
        """
        live_by_node: dict[bytes, int] = {}
        for a in self.actors.values():
            if a.state != DEAD and a.node_id is not None:
                live_by_node[a.node_id] = live_by_node.get(a.node_id, 0) + 1
        best, best_score = None, None
        for n in self.nodes.values():
            if not n.alive:
                continue
            if not all(
                n.resources_total.get(k, 0) >= v for k, v in resources.items()
            ):
                continue
            avail = all(
                n.resources_available.get(k, 0) >= v for k, v in resources.items()
            )
            score = (not avail, live_by_node.get(n.node_id, 0), n.load,
                     -sum(n.resources_available.values()))
            if best_score is None or score < best_score:
                best, best_score = n, score
        return best

    def _deduct(self, node: NodeInfo, resources: dict[str, float]) -> None:
        for k, v in resources.items():
            node.resources_available[k] = node.resources_available.get(k, 0) - v

    async def _actor_started(self, conn, p):
        info = self.actors[p["actor_id"]]
        info.state = ALIVE
        info.address = tuple(p["address"])
        info.placing = False
        if p.get("node_id"):
            info.node_id = p["node_id"]
        self.record_event(
            "ACTOR_ALIVE", f"actor {p['actor_id'].hex()[:8]} alive",
            actor_id=p["actor_id"].hex())
        self.publish("actor", {"actor_id": p["actor_id"], "state": ALIVE,
                               "address": info.address})
        self._wal_actor(info)
        return {"ok": True}

    async def _actor_failed(self, conn, p):
        """Actor worker died. FSM (ref: gcs_actor_manager.cc:1068-1079):
        - restarts left → RESTARTING; stay RESTARTING even with no feasible
          node (waits for one); exactly one client drives the placement
          (`placing` guard, re-armable after a timeout in case that client
          died mid-placement).
        - budget exhausted → DEAD, broadcast."""
        info = self.actors.get(p["actor_id"])
        if info is None or info.state == DEAD:
            return {"ok": True, "restart": False,
                    "cause": info.death_cause if info else "unknown actor"}
        if info.state != RESTARTING:
            allowed = (
                info.max_restarts == -1
                or info.num_restarts < info.max_restarts
            )
            if not allowed:
                info.state = DEAD
                info.death_cause = p.get("error", "worker died")
                if info.name:
                    self.named_actors.pop(info.name, None)
                self.publish("actor", {"actor_id": p["actor_id"], "state": DEAD,
                                       "cause": info.death_cause})
                self.record_event(
                    "ACTOR_DIED",
                    f"actor {p['actor_id'].hex()[:8]} died: "
                    f"{info.death_cause}",
                    severity="ERROR", actor_id=p["actor_id"].hex(),
                    cause=str(info.death_cause))
                self._wal_actor(info)
                return {"ok": True, "restart": False, "cause": info.death_cause}
            info.num_restarts += 1
            info.state = RESTARTING
            self.record_event(
                "ACTOR_RESTARTING",
                f"actor {p['actor_id'].hex()[:8]} restarting "
                f"({info.num_restarts} so far)",
                severity="WARNING", actor_id=p["actor_id"].hex())
            info.address = None
            info.placing = False
            self._wal_actor(info)   # restart budget must survive a GCS crash
            self.publish("actor", {"actor_id": p["actor_id"],
                                   "state": RESTARTING})
        if p.get("transition_only"):
            # node-death sweep: flip state; owners drive placement when they
            # next touch the actor
            return {"ok": True, "restart": True, "node_id": None}
        if p.get("placement_failed"):
            # the caller held the placement slot and failed — release it so
            # the next attempt can claim a (possibly different) node
            info.placing = False
        if info.placing and (
            time.monotonic() - info.placing_since
            < self.config.lease_timeout_s
        ):
            return {"ok": True, "restart": True, "wait": True}
        node = self._schedule_actor(info.resources)
        if node is None:
            # No feasible node right now — caller retries; actor stays
            # RESTARTING until a node joins or the caller gives up.
            return {"ok": True, "restart": True, "node_id": None}
        info.node_id = node.node_id
        info.placing = True
        info.placing_since = time.monotonic()
        self._deduct(node, info.resources)
        return {"ok": True, "restart": True,
                "node_id": node.node_id, "node_address": node.address,
                "num_restarts": info.num_restarts}

    async def _kill_actor(self, conn, p):
        info = self.actors.get(p["actor_id"])
        if info is None:
            return {"ok": False}
        addr = info.address
        restartable = (info.max_restarts == -1
                       or info.num_restarts < info.max_restarts)
        if (not p.get("no_restart", True) and restartable
                and info.state != DEAD):
            # ray.kill(no_restart=False) parity: the process dies but the
            # actor FSM restarts it (replaying the creation spec) — used by
            # e.g. serve controller FT tests.
            info.num_restarts += 1
            info.state = RESTARTING
            info.address = None
            info.placing = False
            self._wal_actor(info)
            self.publish("actor", {"actor_id": p["actor_id"],
                                   "state": RESTARTING, "cause": "killed"})
            return {"ok": True, "address": addr, "restarting": True}
        info.state = DEAD
        info.death_cause = "ray_tpu_torch.kill"
        if info.name:
            self.named_actors.pop(info.name, None)
        self.publish("actor", {"actor_id": p["actor_id"], "state": DEAD,
                               "cause": "killed"})
        self.record_event(
            "ACTOR_DIED", f"actor {p['actor_id'].hex()[:8]} killed",
            severity="WARNING", actor_id=p["actor_id"].hex(),
            cause="ray_tpu_torch.kill")
        self._wal_actor(info)
        return {"ok": True, "address": addr}

    async def _get_actor(self, conn, p):
        actor_id = p.get("actor_id")
        if actor_id is None and p.get("name") is not None:
            actor_id = self.named_actors.get(p["name"])
        if actor_id is None:
            return None
        info = self.actors.get(actor_id)
        if info is None:
            return None
        return {
            "actor_id": info.actor_id, "state": info.state,
            "address": info.address, "node_id": info.node_id,
            "name": info.name, "num_restarts": info.num_restarts,
            "max_task_retries": info.max_task_retries,
            "death_cause": info.death_cause,
        }

    async def _list_actors(self, conn, p):
        return [
            {"actor_id": a.actor_id, "state": a.state, "name": a.name,
             "node_id": a.node_id}
            for a in self.actors.values()
        ]

    # ---------- object directory ----------

    async def _obj_loc_add(self, conn, p):
        for obj in p["object_ids"]:
            if obj in self._freed_recent:
                # Straggler seal of an already-freed object: free it there.
                node_conn = self._node_conns.get(p["node_id"])
                if node_conn is not None and not node_conn.closed:
                    node_conn.notify("free_objects", {"object_ids": [obj]})
                continue
            self.object_dir.setdefault(obj, set()).add(p["node_id"])
        return {"ok": True}

    async def _obj_loc_remove(self, conn, p):
        locs = self.object_dir.get(p["object_id"])
        if locs:
            locs.discard(p["node_id"])
        return {"ok": True}

    async def _obj_loc_get(self, conn, p):
        locs = self.object_dir.get(p["object_id"], set())
        return [
            {"node_id": nid, "address": self.nodes[nid].address}
            for nid in locs
            if nid in self.nodes and self.nodes[nid].alive
        ]

    async def _obj_free(self, conn, p):
        """Explicit delete (ray_tpu_torch.free): broadcast to storing nodes and
        drop any ref-counting state."""
        for obj in p["object_ids"]:
            self._free_object(obj, tombstone=True)
        return {"ok": True}

    # ---------- distributed ref counting ----------
    # (ref: core_worker/reference_count.h — here the GCS arbitrates
    #  process-level holds; exact counts live in each client process)

    MAX_TOMBSTONES = 50_000

    async def _ref_register_holder(self, conn, p):
        hid = p["holder_id"]
        self.holder_conns[hid] = conn
        for obj in p.get("held", ()):
            self.ref_holders.setdefault(obj, set()).add(hid)
            self.holder_objs.setdefault(hid, set()).add(obj)
        # Failover re-registration also replays ownership (recovery routing)
        # and containment pseudo-holders (refs-in-refs) — the ref tables are
        # runtime-only state rebuilt entirely from holder announcements.
        for obj in p.get("owned", ()):
            self.obj_owner[obj] = hid
        for outer, inners in p.get("contains", ()):
            pseudo = b"obj:" + outer
            bucket = self.contained.setdefault(outer, [])
            for inner in inners:
                if inner not in bucket:
                    self.ref_holders.setdefault(inner, set()).add(pseudo)
                    bucket.append(inner)
        return {"ok": True}

    async def _ref_update(self, conn, p):
        hid = p["holder_id"]
        self.holder_conns.setdefault(hid, conn)
        held = self.holder_objs.setdefault(hid, set())
        for obj in p.get("acquires", ()):
            self.ref_holders.setdefault(obj, set()).add(hid)
            held.add(obj)
        for obj in p.get("owned", ()):
            self.obj_owner[obj] = hid
        for outer, inners in p.get("contains", ()):
            pseudo = b"obj:" + outer
            bucket = self.contained.setdefault(outer, [])
            for inner in inners:
                self.ref_holders.setdefault(inner, set()).add(pseudo)
                bucket.append(inner)
        for obj in p.get("releases", ()):
            held.discard(obj)
            self._ref_release(hid, obj)
        for obj in p.get("releases_owned", ()):
            held.discard(obj)
            self._ref_release(hid, obj, free_unknown=True)
        return {"ok": True}

    async def _ref_revive(self, conn, p):
        """Lineage reconstruction is about to re-store these ids: clear any
        free-tombstone (else the re-created object is freed on seal) and
        register the recovering client as a holder."""
        hid = p["holder_id"]
        held = self.holder_objs.setdefault(hid, set())
        for obj in p["object_ids"]:
            self._freed_recent.pop(obj, None)
            self.ref_holders.setdefault(obj, set()).add(hid)
            self.obj_owner[obj] = hid
            held.add(obj)
        return {"ok": True}

    async def _obj_request_recovery(self, conn, p):
        """A raylet's pull found no live copy: ask the object's owner to
        reconstruct it (lineage re-execution / owner re-put). Fire-and-forget
        from the raylet's perspective — it keeps polling the directory."""
        notified = []
        for obj in p["object_ids"]:
            hid = self.obj_owner.get(obj)
            c = self.holder_conns.get(hid) if hid is not None else None
            if c is not None and not c.closed:
                c.notify("recover_objects", {"object_ids": [obj]})
                notified.append(obj)
        return {"notified": notified}

    async def _ref_debug(self, conn, p):
        """Introspection for `ray_tpu_torch memory`/debugging: who holds what."""
        out = {}
        for obj in p.get("object_ids", ()):
            out[obj] = {
                "holders": sorted(self.ref_holders.get(obj, set())),
                "owner": self.obj_owner.get(obj),
                "contained_by": [o for o, inners in self.contained.items()
                                 if obj in inners],
            }
        return out

    def _ref_release(self, holder: bytes, obj: bytes,
                     free_unknown: bool = False) -> None:
        holders = self.ref_holders.get(obj)
        if holders is None:
            # Never registered. Only the *creator's* release may free it
            # (put-then-drop before the owner's first flush); a borrower's
            # release must never race ahead of the owner's initial acquire.
            if free_unknown:
                self._free_object(obj)
            return
        holders.discard(holder)
        if not holders:
            self._free_object(obj)

    def _free_object(self, obj: bytes, tombstone: bool = True) -> None:
        self.ref_holders.pop(obj, None)
        owner = self.obj_owner.pop(obj, None)
        for nid in self.object_dir.pop(obj, set()):
            node_conn = self._node_conns.get(nid)
            if node_conn is not None and not node_conn.closed:
                node_conn.notify("free_objects", {"object_ids": [obj]})
        # Tell the owner the object is gone cluster-wide so its lineage
        # pin (kept while remote borrowers might still need recovery) drops.
        oconn = self.holder_conns.get(owner) if owner is not None else None
        if oconn is not None and not oconn.closed:
            oconn.notify("objects_freed", {"object_ids": [obj]})
        if tombstone:
            self._freed_recent[obj] = time.monotonic()
            while len(self._freed_recent) > self.MAX_TOMBSTONES:
                self._freed_recent.pop(next(iter(self._freed_recent)))
        # refs-in-refs cascade: the outer object's pseudo-holds die with it.
        for inner in self.contained.pop(obj, ()):  # noqa: B020
            self._ref_release(b"obj:" + obj, inner)

    def _drop_holder(self, hid: bytes) -> None:
        """Release everything a (dead) holder process held."""
        for obj in self.holder_objs.pop(hid, set()):
            self._ref_release(hid, obj)
        self.holder_conns.pop(hid, None)

    def _schedule_holder_cleanup(self, hid: bytes, conn) -> None:
        """Grace period: a reconnecting holder re-registers before its holds
        are dropped (parity: owner-death object cleanup,
        reference_count.h owner-dies semantics)."""

        async def cleanup():
            await asyncio.sleep(self.config.ref_holder_grace_s)
            if self.holder_conns.get(hid) is conn:
                self._drop_holder(hid)

        spawn(cleanup())

    # ---------- failure detection ----------

    def _handle_disconnect(self, conn) -> None:
        for nid, c in list(self._node_conns.items()):
            if c is conn:
                self._mark_node_dead(nid, "connection lost")
        for hid, c in list(self.holder_conns.items()):
            if c is conn:
                self._schedule_holder_cleanup(hid, conn)

    def _mark_node_dead(self, node_id: bytes, why: str) -> None:
        info = self.nodes.get(node_id)
        if info is None or not info.alive:
            return
        info.alive = False
        self._view_version += 1
        info.version = self._view_version
        self._wal_append(("nodedead", node_id))
        logger.warning("node %s dead: %s", node_id.hex()[:8], why)
        self._node_conns.pop(node_id, None)
        for obj, locs in list(self.object_dir.items()):
            locs.discard(node_id)
        self.publish("node", {"event": "dead", "node_id": node_id})
        self.record_event(
            "NODE_DIED", f"node {node_id.hex()[:8]} died ({why})",
            severity="ERROR", node_id=node_id.hex(), cause=str(why))
        # Fail-over actors that lived there.
        for info_a in list(self.actors.values()):
            if info_a.node_id == node_id and info_a.state in (ALIVE, PENDING):
                spawn(
                    self._actor_failed(None, {"actor_id": info_a.actor_id,
                                              "error": f"node died ({why})",
                                              "transition_only": True})
                )

    async def _health_loop(self) -> None:
        period = self.config.heartbeat_period_s
        limit = period * self.config.heartbeat_miss_limit
        while True:
            await asyncio.sleep(period)
            now = time.monotonic()
            for nid, info in list(self.nodes.items()):
                if info.alive and now - info.last_heartbeat > limit:
                    self._mark_node_dead(nid, "heartbeat timeout")

    async def start(self) -> tuple[str, int]:
        self._restore_snapshot()
        n = self._wal_replay()
        if n:
            logger.info("replayed %d WAL records", n)
        # Keep view-version stamps monotonic across restarts: restored
        # NodeInfo entries carry pre-crash stamps; new stamps must exceed
        # them or the delta protocol ships nothing / everything.
        if self.nodes:
            self._view_version = max(
                self._view_version,
                max(nd.version for nd in self.nodes.values()))
        self._wal_open()
        addr = await self.server.start()
        spawn(self._health_loop())
        if self.snapshot_path:
            spawn(self._snapshot_loop())
        logger.info("GCS listening on %s", addr)
        return addr

    async def stop(self) -> None:
        await self.server.stop()

    # ---------- fault tolerance: durable state ----------
    # (ref: gcs/store_client/redis_store_client.h — the reference persists
    #  every table write to Redis and reloads via gcs_init_data.cc. Here:
    #  a per-mutation WRITE-AHEAD LOG + periodic snapshot compaction, so a
    #  kill -9 at any point loses nothing — the r1 interval snapshot lost
    #  everything since its last tick, and re-pickled the full state
    #  (including 100MB KV blobs) every second.)

    def _wal_append(self, record: tuple) -> None:
        if self._wal_f is None:
            return
        import pickle

        data = pickle.dumps(record)
        self._wal_f.write(len(data).to_bytes(4, "little") + data)
        self._wal_f.flush()
        if self.config.gcs_wal_fsync:
            os.fsync(self._wal_f.fileno())
        self._dirty = True

    def _wal_open(self) -> None:
        if not self.snapshot_path:
            self._wal_f = None
            return
        self._wal_f = open(self.snapshot_path + ".wal", "ab")

    def _wal_replay(self) -> int:
        """Apply WAL records on top of the restored snapshot. Tolerates a
        torn tail (crash mid-append). Returns records applied."""
        import pickle

        path = (self.snapshot_path + ".wal") if self.snapshot_path else None
        if not path or not os.path.exists(path):
            return 0
        n = 0
        with open(path, "rb") as f:
            while True:
                hdr = f.read(4)
                if len(hdr) < 4:
                    break
                length = int.from_bytes(hdr, "little")
                body = f.read(length)
                if len(body) < length:
                    break  # torn tail
                try:
                    self._wal_apply(pickle.loads(body))
                    n += 1
                except Exception:
                    logger.exception("WAL record apply failed; skipping")
        # named_actors is derived state: rebuild after replay.
        self.named_actors = {
            a.name: a.actor_id for a in self.actors.values()
            if a.name and a.state != DEAD
        }
        return n

    def _wal_apply(self, rec: tuple) -> None:
        kind = rec[0]
        if kind == "kv":
            _, ns, key, value = rec
            self.kv.setdefault(ns, {})[key] = value
        elif kind == "kvdel":
            _, ns, key = rec
            self.kv.get(ns, {}).pop(key, None)
        elif kind == "job":
            self._job_counter = max(self._job_counter, rec[1])
        elif kind == "actor":
            d = dict(rec[1])
            if d.get("address") is not None:
                d["address"] = tuple(d["address"])
            if d.get("owner_address") is not None:
                d["owner_address"] = tuple(d["owner_address"])
            a = ActorInfo(**d)
            a.placing = False
            self.actors[a.actor_id] = a
        elif kind == "pg":
            self.placement_groups[rec[1]] = rec[2]
        elif kind == "pgdel":
            self.placement_groups.pop(rec[1], None)
        elif kind == "node":
            d = dict(rec[1])
            d["address"] = tuple(d["address"])
            info = NodeInfo(**d)
            info.last_heartbeat = time.monotonic()
            self.nodes[info.node_id] = info
        elif kind == "nodedead":
            info = self.nodes.get(rec[1])
            if info is not None:
                info.alive = False

    def _wal_actor(self, info: ActorInfo) -> None:
        import dataclasses

        self._wal_append(("actor", dataclasses.asdict(info)))

    def _snapshot_state(self) -> dict:
        import dataclasses

        return {
            "nodes": [dataclasses.asdict(n) for n in self.nodes.values()],
            "actors": [dataclasses.asdict(a) for a in self.actors.values()],
            "named_actors": dict(self.named_actors),
            "kv": {ns: dict(d) for ns, d in self.kv.items()},
            "placement_groups": dict(self.placement_groups),
            "object_dir": {k: set(v) for k, v in self.object_dir.items()},
            "job_counter": self._job_counter,
        }

    async def _snapshot_loop(self) -> None:
        """Periodic COMPACTION, not the durability mechanism: the WAL holds
        every mutation since the last snapshot, so this only bounds WAL
        length/replay time. (The r1 design re-pickled the whole state —
        including large KV blobs — every second and still lost the last
        interval on a crash.)"""
        import pickle

        while True:
            await asyncio.sleep(self.config.gcs_snapshot_interval_s)
            if not self._dirty:
                continue
            self._dirty = False
            try:
                blob = pickle.dumps(self._snapshot_state())
                tmp = f"{self.snapshot_path}.tmp"
                with open(tmp, "wb") as f:
                    f.write(blob)
                os.replace(tmp, self.snapshot_path)
                # Snapshot is durable → compact the WAL. Crash between the
                # replace and the truncate just replays idempotent upserts.
                if self._wal_f is not None:
                    os.truncate(self.snapshot_path + ".wal", 0)
            except Exception:
                logger.exception("snapshot failed")

    def _restore_snapshot(self) -> None:
        import pickle

        if not self.snapshot_path or not os.path.exists(self.snapshot_path):
            return
        with open(self.snapshot_path, "rb") as f:
            state = pickle.load(f)
        now = time.monotonic()
        for nd in state["nodes"]:
            nd["address"] = tuple(nd["address"])
            n = NodeInfo(**nd)
            # Give every restored node a fresh heartbeat window to
            # reconnect before being declared dead.
            n.last_heartbeat = now
            self.nodes[n.node_id] = n
        for ad in state["actors"]:
            if ad["address"] is not None:
                ad["address"] = tuple(ad["address"])
            if ad.get("owner_address") is not None:
                ad["owner_address"] = tuple(ad["owner_address"])
            a = ActorInfo(**ad)
            a.placing = False  # the placing client may be gone
            self.actors[a.actor_id] = a
        self.named_actors = state["named_actors"]
        self.kv = state["kv"]
        self.placement_groups = state["placement_groups"]
        self.object_dir = state["object_dir"]
        self._job_counter = state["job_counter"]
        logger.info(
            "restored snapshot: %d nodes, %d actors, %d kv namespaces",
            len(self.nodes), len(self.actors), len(self.kv))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--config", default=None)
    ap.add_argument("--ready-fd", type=int, default=None)
    ap.add_argument("--snapshot-path", default=None,
                    help="durable state file (enables restart recovery)")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO,
                        format="[gcs] %(levelname)s %(message)s")
    config = Config.from_json(open(args.config).read()) if args.config else Config.from_env()

    async def run():
        gcs = GcsServer(config, args.host, args.port,
                        snapshot_path=args.snapshot_path)
        host, port = await gcs.start()
        if args.ready_fd is not None:
            import os

            os.write(args.ready_fd, f"{host}:{port}\n".encode())
            os.close(args.ready_fd)
        await asyncio.Event().wait()

    asyncio.run(run())


if __name__ == "__main__":
    main()
