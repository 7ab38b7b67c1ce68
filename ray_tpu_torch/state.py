"""State API: introspect nodes, actors, and object stores.

Parity: `python/ray/experimental/state/api.py` +
`_private/state.py` (GlobalState over GlobalStateAccessor) — `ray list
nodes/actors`, `ray memory`, cluster resource totals. Data comes straight
from the GCS tables (cluster view, actor directory) and per-raylet store
stats; no separate aggregator process is needed at this scale.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any

from ray_tpu_torch.core import rpc
from ray_tpu_torch.core.config import Config

logger = logging.getLogger(__name__)


def _gcs_address() -> tuple[str, int]:
    import os

    from ray_tpu_torch import api

    client = api._client
    if client is None and (os.environ.get("RAY_TPU_TORCH_GCS_ADDRESS")
                           and os.environ.get("RAY_TPU_TORCH_RAYLET_ADDRESS")):
        # Inside a cluster worker that hasn't touched the client API
        # yet: lazy-ATTACH (cheap, reads the env addresses). This is
        # distinct from the clusterless case below, where
        # _ensure_client would silently BOOT a whole local cluster as
        # a side effect of a state query — the auto-init footgun every
        # client-adjacent constructor now gates against.
        client = api._ensure_client()
    if client is None:
        raise RuntimeError(
            "state queries need a running cluster — call "
            "ray_tpu_torch.init() (or attach with RAY_TPU_TORCH_ADDRESS) first")
    return client.gcs_address


def _call_gcs(method: str, payload: dict | None = None) -> Any:
    async def go():
        cfg = Config.from_env()
        conn = await rpc.connect(*_gcs_address(),
                                 timeout=cfg.rpc_connect_timeout_s)
        try:
            return await conn.call(method, payload or {})
        finally:
            await conn.close()

    return asyncio.run(go())


def list_nodes() -> list[dict]:
    """One row per node: id, address, aliveness, resources."""
    view = _call_gcs("get_cluster_view")
    out = []
    for node_id, info in view.items():
        row = dict(info)
        row["node_id"] = (node_id.hex() if isinstance(node_id, bytes)
                          else str(node_id))
        out.append(row)
    return sorted(out, key=lambda r: r["node_id"])


def list_actors(*, state: str | None = None) -> list[dict]:
    """Actor directory rows (id, class, state, node, restarts)."""
    rows = _call_gcs("list_actors")
    out = []
    for r in rows:
        row = dict(r)
        if isinstance(row.get("actor_id"), bytes):
            row["actor_id"] = row["actor_id"].hex()
        if state is None or row.get("state") == state:
            out.append(row)
    return out


def list_cluster_events(after_seq: int = 0,
                        limit: int = 1000,
                        return_latest_seq: bool = False,
                        tail: bool = False):
    """Structured cluster event log (ref: src/ray/util/event.h +
    dashboard/modules/event): node joins/deaths, actor lifecycle, OOM
    kills — the durable post-mortem trail. Page forward by passing the
    max returned seq (or `latest_seq` via return_latest_seq=True) back
    as after_seq; tail=True returns the newest `limit` rows instead."""
    resp = _call_gcs("events_get", {"after_seq": after_seq, "limit": limit,
                                    "tail": tail})
    if return_latest_seq:
        return resp["events"], resp.get("latest_seq", 0)
    return resp["events"]


def emit_cluster_event(type_: str, message: str, *,
                       severity: str = "INFO", source: str = "driver",
                       **extra) -> bool:
    """Append one structured record to the GCS cluster event log — the
    write half of `list_cluster_events` (library alarms like
    `recompile.storm` / `slo.violation` land here). Best-effort by
    contract: returns False when no client is attached or the GCS call
    fails — emitting an event must never take down the code path that
    observed it."""
    try:
        import os

        from ray_tpu_torch import api as _api

        client = _api._client
        if client is None and os.environ.get("RAY_TPU_TORCH_GCS_ADDRESS") \
                and os.environ.get("RAY_TPU_TORCH_RAYLET_ADDRESS"):
            # Inside a cluster worker that hasn't touched the client API
            # yet (e.g. a recompile storm during a serve replica's
            # cold-start warmup — the most storm-prone window): attach is
            # cheap and the alarm is the point. Clusterless processes
            # stay excluded — an alarm must never auto-START a cluster.
            client = _api._ensure_client()
        if client is None:
            return False
        client.event_add({"type": type_, "message": message,
                          "severity": severity, "source": source, **extra})
        return True
    except Exception as e:
        logger.debug("cluster event %s not delivered: %s", type_, e)
        return False


def _profile_events() -> tuple[list[dict], int]:
    """All profile events visible from this process (GCS aggregate + the
    local, NOT-drained buffer) plus the cluster-wide drop count."""
    from ray_tpu_torch import profiling

    resp = _call_gcs("profile_get")
    if isinstance(resp, dict):
        events, dropped = list(resp.get("events") or []), int(
            resp.get("dropped", 0))
    else:  # pre-drop-count GCS payload shape
        events, dropped = list(resp or []), 0
    # Unreported share only: a worker-hosted reader must not re-count
    # drops its flush loop already shipped into the GCS tally.
    return (events + profiling.peek_events(),
            dropped + profiling.events_dropped_unreported())


def list_tasks(limit: int = 200) -> list[dict]:
    """Recent task executions aggregated from worker profile spans
    (ref: dashboard/state_aggregator.py task rows + StatsGcsService
    AddProfileData). Newest first: name, kind, node, worker, start,
    duration."""
    resp = _call_gcs("profile_get")
    events = (resp.get("events") if isinstance(resp, dict) else resp) or []
    rows = []
    for ev in events:
        rows.append({
            "name": ev.get("name"),
            "kind": ev.get("cat"),
            "node": ev.get("pid"),
            "worker": ev.get("tid"),
            "start_ts": ev.get("ts"),
            "duration_s": (ev.get("dur", 0) or 0) / 1e6,
        })
    rows.sort(key=lambda r: r.get("start_ts") or 0, reverse=True)
    return rows[:limit]


def summarize_tasks() -> dict:
    """`ray summary tasks` analog: execution counts + total/mean runtime
    per task name."""
    agg: dict[str, dict] = {}
    for r in list_tasks(limit=100000):
        a = agg.setdefault(r["name"], {"name": r["name"], "count": 0,
                                       "total_s": 0.0})
        a["count"] += 1
        a["total_s"] += r["duration_s"]
    for a in agg.values():
        a["mean_s"] = round(a["total_s"] / max(a["count"], 1), 4)
        a["total_s"] = round(a["total_s"], 4)
    return {"tasks": sorted(agg.values(), key=lambda a: -a["total_s"])}


def object_store_stats() -> list[dict]:
    """Per-node shared-memory store stats (ray memory equivalent)."""
    nodes = list_nodes()
    cfg = Config.from_env()

    async def fetch(addr):
        try:
            conn = await rpc.connect(*addr, timeout=5.0)
            try:
                return await conn.call("store_stats", {})
            finally:
                await conn.close()
        except Exception:
            return None

    async def go():
        return await asyncio.gather(*[
            fetch(tuple(n["address"])) for n in nodes if n.get("alive", True)
        ])

    stats = asyncio.run(go())
    out = []
    for n, s in zip([n for n in nodes if n.get("alive", True)], stats):
        if s is not None:
            out.append({"node_id": n["node_id"], **s})
    return out


def timeline(filename: str | None = None):
    """Chrome-trace JSON of task/actor execution spans collected from all
    workers (ref: `_private/state.py:829` ray.timeline). Open in
    chrome://tracing or Perfetto. Returns the event list — including
    synthesized flow arrows (`ph: "s"/"f"`) connecting traced parent→child
    spans across pids; writes the trace (with an `events_dropped` metadata
    count) to `filename` when given."""
    from ray_tpu_torch import profiling, tracing

    events, dropped = _profile_events()
    events = events + tracing.flow_events(events)
    if filename:
        with open(filename, "w") as f:
            f.write(profiling.chrome_trace(
                events, metadata={"profile_events_dropped": dropped}))
    return events


def timeline_metadata() -> dict:
    """The metadata block timeline(filename) embeds, for direct pollers —
    tally-only RPC, so it never moves the full event table."""
    from ray_tpu_torch import profiling

    stats = _call_gcs("profile_stats") or {}
    return {"profile_events_dropped":
            int(stats.get("dropped", 0))
            + profiling.events_dropped_unreported()}


def list_traces() -> list[dict]:
    """One row per distributed trace (newest first): trace_id, span count,
    root span name, start, end-to-end duration (tracing.py). Grouped
    server-side over the FLUSHED spans — every process (drivers included)
    ships its buffer on a ~1s cadence, so rows lag live spans by at most
    one flush tick but the event table never moves over the wire."""
    return list(_call_gcs("profile_traces") or [])


def get_trace(trace_id: str) -> dict | None:
    """Reconstructed span tree for one trace_id: per-span pid/tid, start +
    duration, and the queue-wait / transfer / execute breakdown each hop
    recorded. None if no span of that trace has been flushed yet.
    Filtered server-side — polling this endpoint must not move the whole
    profile-event table per call."""
    from ray_tpu_torch import profiling, tracing

    resp = _call_gcs("profile_get", {"trace_id": trace_id})
    events = (resp.get("events") if isinstance(resp, dict) else resp) or []
    return tracing.build_trace_tree(
        list(events) + profiling.peek_events(), trace_id)


def metrics_rows() -> list[dict]:
    """Aggregated metric rows from every reporting process. Every process
    with a client — drivers included — pushes its snapshot to the GCS on
    the flush cadence, so the hub view IS the complete view (appending the
    local snapshot here would double-count this process's counters)."""
    return list(_call_gcs("metrics_get"))


def prometheus_metrics() -> str:
    from ray_tpu_torch import profiling

    return profiling.prometheus_text(metrics_rows())


def query_series(name: str | None = None, tags: dict | None = None,
                 window_s: float | None = None) -> list[dict]:
    """Rolling metric history from the GCS series store (obs_series.py):
    one row per matching (name, tags, source) series with its in-window
    points oldest-first — {"name", "tags", "source", "kind", "points":
    [[ts, value], ...], "tombstoned"} (histogram series carry their
    per-bucket count vectors + "boundaries"). `tags` subset-filters;
    `window_s=None` returns full retention. This is the read path the
    shadow autoscaler, SLO restart seeding, and `status --serve
    --history` sparklines share."""
    payload: dict = {}
    if name is not None:
        payload["name"] = name
    if tags:
        payload["tags"] = {str(k): str(v) for k, v in tags.items()}
    if window_s is not None:
        payload["window_s"] = float(window_s)
    return list(_call_gcs("series_query", payload) or [])


def _call_raylet_addr(address, method: str, payload: dict) -> Any:
    async def go():
        conn = await rpc.connect(*tuple(address), timeout=5.0)
        try:
            return await conn.call(method, payload, timeout=30.0)
        finally:
            await conn.close()

    try:
        return asyncio.run(go())
    except Exception:
        return None


def list_logs(node_id: str | None = None) -> dict:
    """node_id(hex, prefix ok) → its log files; all alive nodes if None
    (ref: dashboard/modules/log list API). One cluster-view fetch total."""
    out = {}
    for n in list_nodes():
        if not n.get("alive", True):
            continue
        if node_id is not None and not n["node_id"].startswith(node_id):
            continue
        files = _call_raylet_addr(n["address"], "log_list", {})
        out[n["node_id"]] = files or []
    return out


def fetch_log(node_id: str, name: str,
              tail_bytes: int = 64 * 1024) -> dict | None:
    """Tail of one worker/driver log file on `node_id` (hex, prefix ok)."""
    node = next((n for n in list_nodes()
                 if n["node_id"].startswith(node_id)
                 and n.get("alive", True)), None)
    if node is None:
        return None
    return _call_raylet_addr(node["address"], "log_fetch",
                             {"name": name, "tail_bytes": tail_bytes})


def cluster_status() -> dict:
    """Summary used by `status` CLI and the dashboard."""
    nodes = list_nodes()
    alive = [n for n in nodes if n.get("alive", True)]
    total: dict[str, float] = {}
    avail: dict[str, float] = {}
    for n in alive:
        for k, v in (n.get("resources_total") or n.get("resources") or {}).items():
            total[k] = total.get(k, 0) + v
        for k, v in (n.get("resources_available") or {}).items():
            avail[k] = avail.get(k, 0) + v
    actors = list_actors()
    return {
        "nodes_alive": len(alive),
        "nodes_dead": len(nodes) - len(alive),
        "resources_total": total,
        "resources_available": avail,
        "actors_alive": sum(1 for a in actors if a.get("state") == "ALIVE"),
        "actors_total": len(actors),
    }
