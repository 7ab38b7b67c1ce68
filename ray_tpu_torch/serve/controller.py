"""ServeController: singleton control-plane actor.

Parity: `python/ray/serve/controller.py:61` +
`_private/deployment_state.py:1767` — reconciles desired deployment state
(replica count, config, user code version) against actual replica actors,
restarts dead replicas, autoscales on observed load
(`_private/autoscaling_policy.py` BasicAutoscalingPolicy), and pushes
routing-table invalidations to handles/proxies over GCS pubsub
(`_private/long_poll.py:40` LongPollHost parity).
"""

from __future__ import annotations

import logging
import math
import threading
import time
from typing import Any

from ray_tpu_torch import chaos as _chaos
from ray_tpu_torch import profiling as _profiling

logger = logging.getLogger(__name__)

ROUTES_CHANNEL = "serve_routes"
CKPT_NS = "serve"
CKPT_KEY = b"controller_ckpt"

# Drain protocol observability: one count per drained replica by outcome
# (clean = in-flight work finished inside the window; exported =
# continuations handed back for cross-replica resume; timeout = the
# window expired without an answer → hard kill; dead = the replica died
# mid-drain), plus the wall time each drain took and how many
# continuations left.
_DRAIN_TOTAL = _profiling.Counter(
    "serve_drain_total",
    description="Serve replicas drained, by outcome",
    tag_keys=("deployment", "outcome"))
_DRAIN_EXPORTED = _profiling.Counter(
    "serve_drain_exported_total",
    description="Resumable continuations exported by draining replicas",
    tag_keys=("deployment",))
_DRAIN_DURATION = _profiling.Histogram(
    "serve_drain_duration_s",
    description="Wall time from drain request to replica reap",
    boundaries=_profiling.LATENCY_BUCKETS_S,
    tag_keys=("deployment",))

# Routing-push payload (control-plane soak measurement): serialized
# bytes of the per-replica load/summary table each get_routing build
# ships — the number that must stay bounded as replica counts and KV
# summaries grow (the summary rides this push; serve_kv_summary_max is
# the per-replica cap).
_ROUTES_PUSH_BYTES = _profiling.Counter(
    "serve_routes_push_bytes",
    description="Serialized load-table bytes shipped by routing pushes")

# Per-replica load HISTORY (decision plane): each reconcile re-exports
# the probe's engine load under deployment-tagged gauges, so the GCS
# series store accumulates the rolling per-replica history the shadow
# autoscaler (serve/autoscale.py), `status --serve --history`
# sparklines, and /api/series query. Series of removed replicas are
# remove()d here — the next metrics flush omits them, which tombstones
# their history in the store.
_REPLICA_LOAD_GAUGES = {
    key: _profiling.Gauge(f"serve_replica_{key}", description=desc,
                          tag_keys=("deployment", "replica"))
    for key, desc in (
        ("queue_depth", "Replica engine queue depth at the last probe"),
        ("ongoing", "Replica inflight + queued at the last probe"),
        ("ttft_ewma_ms", "Replica TTFT EWMA at the last probe"),
        ("kv_pages_free", "Replica KV page-pool free at the last probe"),
        ("prefix_cache_hit_rate",
         "Replica prefix-cache hit rate at the last probe"),
        ("spec_accepted_per_step",
         "Replica speculative tokens-per-verify-step EWMA at the last "
         "probe"),
    )
}

# Record fields persisted across controller restarts. Runtime bookkeeping
# (over/under_since) deliberately excluded — autoscaler timers restart clean.
_CKPT_FIELDS = (
    "name", "cls_blob", "init_args", "init_kwargs", "num_replicas",
    "route_prefix", "resources", "max_concurrent_queries", "user_config",
    "autoscaling", "autoscaling_spec", "generation", "pool_role",
)


class ServeController:
    """Runs as a named detached actor ("ray_tpu_serve_controller").

    Fault-tolerant: desired state (deployments, versions, target replica
    counts) AND the current replica handle set are checkpointed to the GCS
    KV on every mutation (ref: serve/_private/storage/kv_store.py +
    deployment_state.py:1767 checkpointing). On restart (the actor is
    created with max_restarts) the checkpoint is restored and the reconcile
    loop adopts still-live replicas (health probe) / replaces dead ones —
    routes keep serving through a controller kill -9.
    """

    def __init__(self):
        # name → deployment record
        self.deployments: dict[str, dict] = {}
        self.version = 0
        self._lock = threading.Lock()
        self._stop = False
        self._ckpt_seq = 0          # monotonic: drop out-of-order KV writes
        self._ckpt_write_lock = threading.Lock()
        # actor_id → (consecutive failed probes, last-strike monotonic).
        # A replica is reaped only after `serve_health_failure_threshold`
        # consecutive misses (ref: gcs_health_check_manager.cc
        # failure_threshold) — a single timed-out probe on a loaded host
        # must not kill a healthy replica. The timestamp rate-limits
        # strikes to one per probe window: reconciles can overlap (the
        # background loop plus deploy/request_scale_up-scoped ones), and
        # double-counting one wedged window would defeat the threshold.
        # Own lock (not self._lock): strikes are recorded in the probe
        # section, which deliberately runs outside self._lock because it
        # blocks on ray_tpu_torch.wait/get — but the strike read-modify-write
        # still needs mutual exclusion across overlapping reconciles.
        self._health_lock = threading.Lock()
        self._health_fails: dict[str, tuple[int, float]] = {}
        from ray_tpu_torch.core.config import runtime_config

        self._cfg = runtime_config()
        # Shadow autoscaler (serve/autoscale.py): observe-only replica
        # recommendations over the series store's metric history by
        # default; `serve_autoscale_mode=enact` applies them through the
        # normal reconcile scale paths, `off` disables it entirely.
        from ray_tpu_torch.serve.autoscale import AutoscalePolicy, ShadowAutoscaler

        mode = getattr(self._cfg, "serve_autoscale_mode", "shadow")
        self._shadow = (None if mode not in ("shadow", "enact")
                        else ShadowAutoscaler(
                            policy=AutoscalePolicy.from_config(self._cfg),
                            mode=mode))
        self._autoscale_last = 0.0
        self._kv_sweep_last = 0.0
        # (deployment, replica short id) pairs with live history gauges —
        # diffed each full reconcile so removed replicas' series retire.
        self._load_series: set[tuple[str, str]] = set()
        self._restore()
        self._reconciler = threading.Thread(target=self._loop, daemon=True)
        self._reconciler.start()
        # The KV orphan sweep on its own thread: a reconcile pass can
        # block up to serve_health_probe_timeout_s on a booting
        # replica's probe (the replacement of a SIGKILLed donor, say),
        # and the donor's pages must not wait that out.
        self._kv_sweeper = threading.Thread(target=self._kv_sweep_loop,
                                            daemon=True)
        self._kv_sweeper.start()

    # ------------------------------------------------------- checkpointing

    def _restore(self) -> None:
        from ray_tpu_torch import api as _api
        from ray_tpu_torch.core import serialization

        try:
            raw = _api._ensure_client().kv_get(CKPT_NS, CKPT_KEY)
        except Exception as e:
            # Unreadable checkpoint on controller start = every deployment
            # silently forgotten. Must be loud.
            logger.warning("controller checkpoint read failed (starting "
                           "empty): %s", e)
            raw = None
        if not raw:
            return
        try:
            snap = serialization.unpack(raw)
        except Exception as e:
            logger.warning("controller checkpoint corrupt (starting "
                           "empty): %s", e)
            return
        for name, rec in snap.get("deployments", {}).items():
            # .get: fields added after a checkpoint was written (e.g.
            # pool_role) restore as None instead of refusing the whole
            # snapshot.
            d = {k: rec.get(k) for k in _CKPT_FIELDS}
            d["over_since"] = None
            d["under_since"] = None
            d["cold_ts"] = None
            d["replica_load"] = {}
            # Runtime-only: replicas draining at crash time are orphans
            # for the restarted controller — their membership loop sees
            # is_member()=False, self-drains, and exits.
            d["draining"] = []
            import time as _time

            _now = _time.monotonic()
            d["starting"] = [(a, h, _now)
                             for (a, h) in rec.get("starting", [])]
            # Pickled (actor_id, handle) pairs: dead ones are filtered by
            # the first reconcile health probe; live ones are adopted as-is.
            d["replicas"] = rec["replicas"]
            self.deployments[name] = d
        # Version must move FORWARD past anything handles may have cached —
        # including bumps the best-effort async checkpoint writer lost before
        # the crash. A generous jump is safe (handles only compare order);
        # too small a jump leaves handles with pushed_version > version,
        # force-refreshing on every request.
        self.version = snap.get("version", 0) + 1024

    def _checkpoint_locked(self) -> None:
        """Snapshot under the lock; write to the GCS KV off-thread (a slow
        GCS must not stall deploy/reconcile). Last-writer-wins guarded by a
        sequence number so a delayed older write can't clobber newer state."""
        from ray_tpu_torch.core import serialization

        self._ckpt_seq += 1
        seq = self._ckpt_seq
        snap = {
            "version": self.version,
            "deployments": {
                name: {**{k: d[k] for k in _CKPT_FIELDS},
                       "replicas": list(d["replicas"]),
                       # Persisted separately: a restored booting replica
                       # must re-enter STARTING (fresh timeout clock), not
                       # the routable strike path.
                       "starting": [(a, h) for (a, h, _t)
                                    in d.get("starting", [])]}
                for name, d in self.deployments.items()
            },
        }
        blob = serialization.pack(snap)

        def _write():
            from ray_tpu_torch import api as _api

            # Bounded retry with backoff: one transient GCS blip must not
            # silently cost the NEXT controller restart its state. The
            # lock is released between attempts (a newer snapshot may be
            # racing) and the seq guard re-checks before every write so a
            # superseded snapshot aborts instead of clobbering.
            retries = max(0, int(getattr(
                self._cfg, "serve_ckpt_write_retries", 4)))
            backoff = getattr(self._cfg, "serve_ckpt_write_backoff_s", 0.2)
            last: Exception | None = None
            for attempt in range(retries + 1):
                try:
                    with self._ckpt_write_lock:     # one writer in flight
                        with self._lock:
                            if seq != self._ckpt_seq:
                                return  # a newer snapshot supersedes this
                        _chaos.hit("serve.controller.ckpt_write")
                        # graftlint: disable=LOCK-ORDER (holding the RPC inside _ckpt_write_lock IS the design: this single-purpose lock serializes checkpoint writers only — reconcile/deploy contend on self._lock, which is released before the RPC)
                        _api._ensure_client().kv_put(
                            CKPT_NS, CKPT_KEY, bytes(blob))
                    return
                except Exception as e:
                    last = e
                    logger.debug("controller checkpoint write attempt "
                                 "%d/%d failed: %s", attempt + 1,
                                 retries + 1, e)
                if attempt < retries:      # no dead sleep after the last try
                    time.sleep(backoff * (2 ** attempt))
            # Every attempt failed — the failure must not wait until the
            # next restart to surface.
            logger.warning("controller checkpoint write failed after %d "
                           "attempts: %s", retries + 1, last)

        threading.Thread(target=_write, daemon=True).start()

    # ------------------------------------------------------------ API

    def deploy(self, name: str, cls_blob: bytes, init_args: tuple,
               init_kwargs: dict, num_replicas: int,
               route_prefix: str | None,
               resources: dict | None,
               max_concurrent_queries: int = 8,
               user_config: Any = None,
               autoscaling_config: dict | None = None,
               pool_role: str | None = None) -> bool:
        if autoscaling_config:
            ac = dict(autoscaling_config)
            ac.setdefault("min_replicas", 1)
            # min_replicas=0 == scale-to-zero: with no replicas there is no
            # replica-side load signal, so the scale-UP trigger moves to the
            # caller — a handle that finds zero replicas calls
            # request_scale_up() and waits for the cold start (the
            # reference's handle-queue-driven path, autoscaling_policy.py).
            ac["min_replicas"] = max(0, ac["min_replicas"])
            ac.setdefault("max_replicas", max(num_replicas, 1))
            ac.setdefault("target_ongoing_requests", 2.0)
            ac.setdefault("upscale_delay_s", 0.5)
            ac.setdefault("downscale_delay_s", 5.0)
            num_replicas = max(
                ac["min_replicas"], min(num_replicas, ac["max_replicas"]))
        else:
            ac = None
        with self._lock:
            old = self.deployments.get(name)
            same_cfg = old is not None and (
                old["cls_blob"] == cls_blob
                and old["init_args"] == init_args
                and old["init_kwargs"] == init_kwargs
                and old["route_prefix"] == route_prefix
                and old["resources"] == resources
                and old["max_concurrent_queries"] == max_concurrent_queries
                and old["user_config"] == user_config
                and old.get("autoscaling_spec") == autoscaling_config
                and (ac is None) == (old.get("autoscaling") is None)
                and old.get("pool_role") == pool_role
            )
            if same_cfg and (ac is not None
                             or old["num_replicas"] == num_replicas):
                # Idempotent redeploy (graph re-runs, shared diamond
                # children): nothing changed — don't roll healthy replicas.
                return True
            if same_cfg:
                # Only the replica count changed: resize IN PLACE — the
                # reconcile loop sheds excess replicas through the drain
                # protocol (or spawns missing ones). Rolling every
                # healthy replica for a scale-down would churn exactly
                # the capacity a scale-down is trying to conserve.
                old["num_replicas"] = num_replicas
                old["over_since"] = None
                old["under_since"] = None
                resized = True
            else:
                resized = False
            if not resized:
                self.deployments[name] = {
                    "name": name,
                    "cls_blob": cls_blob,
                    "init_args": init_args,
                    "init_kwargs": init_kwargs,
                    "num_replicas": num_replicas,
                    "route_prefix": route_prefix,
                    "resources": resources,
                    "max_concurrent_queries": max_concurrent_queries,
                    "user_config": user_config,
                    "autoscaling": ac,
                    "autoscaling_spec": autoscaling_config,
                    # Disaggregated pool membership ("prefill"/"decode"/
                    # None=fused): rides the routing table so routers
                    # and the status surfaces see the split.
                    "pool_role": pool_role,
                    # autoscaler bookkeeping: when the load first crossed
                    # the scale-up/-down threshold (None = not crossed)
                    "over_since": None,
                    "under_since": None,
                    "cold_ts": None,
                    # actor_id → last stats-probe payload (runtime-only;
                    # the load surface behind get_load()/status()).
                    "replica_load": {},
                    "replicas": old["replicas"] if old else [],
                    # Spawned but not yet past their first health probe —
                    # NOT in the routing table (ref: deployment_state.py
                    # STARTING → RUNNING; routing a still-booting replica
                    # makes requests wait out the whole actor boot).
                    "starting": old.get("starting", []) if old else [],
                    # Replicas already mid-drain ride into the new record
                    # so the reaper keeps tracking them across the roll.
                    "draining": list(old.get("draining", [])) if old else [],
                    "generation": (old["generation"] + 1) if old else 0,
                }
                if old:
                    # config/code changed → roll all replicas: the old
                    # generation drains (in-flight work finishes or
                    # migrates) while the new generation boots.
                    self._drain_replicas(self.deployments[name], all=True)
            self._bump_version_locked()
            self._checkpoint_locked()
        self._reconcile_once(only=name)
        return True

    def delete_deployment(self, name: str) -> bool:
        with self._lock:
            d = self.deployments.pop(name, None)
            if d:
                # Explicit teardown: the deployment record is gone, so
                # nothing would reap an async drain — hard-kill, and
                # finish off anything already mid-drain.
                self._drain_replicas(d, all=True, hard=True)
                for ent in d.get("draining", []):
                    self._kill_replica(ent["h"])
            self._bump_version_locked()
            self._checkpoint_locked()
        if self._shadow is not None:
            self._shadow.forget(name)
        return True

    @staticmethod
    def _load_row(s: dict) -> dict:
        """Compact per-replica load row shipped to handles with the
        routing table (the router's blended-p2c / shed signal): the same
        fields _record_load_history exports as gauges, plus the probe
        wall time so consumers can staleness-decay a lagging probe."""
        load = s.get("load") or {}
        qd = float(load.get("queue_depth", 0.0))
        row = {
            "queue_depth": qd,
            "ongoing": float(s.get("inflight", 0.0)) + qd,
            "ttft_ewma_ms": float(load.get("ttft_ewma_ms", 0.0)),
            "kv_pages_free": float(load.get("pool_pages_free", 0.0)),
            "prefix_cache_hit_rate": float(
                load.get("prefix_cache_hit_rate", 0.0)),
            "spec_accepted_per_step": float(
                load.get("spec_accepted_per_step", 0.0)),
            "ts": s.get("ts", 0.0),
        }
        # Donated-chain summary (descriptor-less warm discovery): the
        # replica's chain heads ride the push so handles route/hint
        # against a LOCAL table — zero request-path index RPCs. Hard
        # cap re-applied here (the engine bounds its own export, but
        # the controller is the last line against an oversized row):
        # oldest-first lists degrade to chain-head truncation keeping
        # the newest, never an unbounded push.
        summary = load.get("kv_summary")
        if summary:
            from ray_tpu_torch.core.config import runtime_config

            cap = max(1, int(runtime_config().serve_kv_summary_max))
            row["kv_summary"] = [str(h) for h in summary[-cap:]]
        return row

    def get_routing(self, known_version: int = -1) -> dict | None:
        """Routing table for handles/proxies; None if caller is up to date.

        Besides replica membership, every push carries the per-replica
        LOAD table from the last reconcile probe (queue depth, ongoing,
        TTFT EWMA, kv pages free, prefix-cache hit rate + probe wall
        time) and the overload verdict — the reconcile loop bumps the
        version on every probe round, so handles see fresh load at push
        cadence with zero extra RPCs (the load rides the same pubsub
        bump + table fetch the routing layer already does)."""
        if known_version == self.version:
            return None
        routes = {}
        # Table build time on the CONTROLLER's clock: consumers compute
        # probe age as (table_ts - row_ts) + local time since receipt —
        # both same-clock differences, so cross-node wall-clock skew
        # can't silently disable blended routing / shedding.
        now = time.time()
        with self._lock:
            for name, d in self.deployments.items():
                live = {aid for aid, _h in d["replicas"]}
                routes[name] = {
                    "replicas": [h for (_aid, h) in d["replicas"]],
                    "route_prefix": d["route_prefix"],
                    "max_concurrent_queries": d["max_concurrent_queries"],
                    "pool_role": d.get("pool_role"),
                    "loads": {
                        aid: self._load_row(s)
                        for aid, s in (d.get("replica_load") or {}).items()
                        if aid in live
                    },
                    # Shed gate (http_proxy): the autoscaler says demand
                    # is at/above max_replicas AND the fleet is fully
                    # deployed — scaling can't absorb any more, so
                    # degradation policy takes over. Guarded on full
                    # deployment so a still-booting fleet (capacity
                    # coming) never sheds early.
                    "overload_pinned": bool(
                        d.get("overload_pinned")
                        and len(d["replicas"]) >= d["num_replicas"]),
                }
        # Push-size measurement (the 100-replica control-plane soak
        # number): serialized bytes of the JSON-able load/summary subset
        # — replica handles are excluded (they don't serialize and their
        # size is membership, not per-push payload). Counted per build
        # AND returned in-band so benches/tests read it off the table.
        import json as _json

        push_bytes = len(_json.dumps(
            {name: r.get("loads") or {} for name, r in routes.items()}))
        _ROUTES_PUSH_BYTES.inc(float(push_bytes))
        return {"version": self.version, "ts": now, "routes": routes,
                "push_bytes": push_bytes}

    def request_scale_up(self, name: str) -> bool:
        """Cold-start trigger from a handle that found zero replicas (the
        scale-to-zero wake-up path). Reconciles immediately so the caller's
        wait is one replica startup, not a reconcile tick + startup."""
        with self._lock:
            d = self.deployments.get(name)
            if d is None:
                return False
            # Record the handle-side demand even if replicas already exist:
            # during a cold start, replica stats can't see the queued
            # request yet, and without this mark one idle reconcile tick
            # would decay the fresh replica straight back to zero.
            d["cold_ts"] = time.monotonic()
            if d["num_replicas"] < 1:
                d["num_replicas"] = 1
                d["under_since"] = None
                d["over_since"] = None
            else:
                return True
        # Scoped: a wake-up must not wait behind probes of every other
        # deployment's replicas.
        self._reconcile_once(only=name)
        return True

    def is_member(self, deployment: str, actor_id_hex: str) -> bool:
        """Replica orphan check (see replica._membership_loop)."""
        with self._lock:
            d = self.deployments.get(deployment)
            if d is None:
                return False
            return (any(aid == actor_id_hex for aid, _h in d["replicas"])
                    or any(aid == actor_id_hex
                           for aid, _h, _t in d.get("starting", []))
                    # Draining replicas stay members until reaped: the
                    # orphan self-exit must not race the drain window
                    # (stream readers are still draining their cursors).
                    or any(ent["aid"] == actor_id_hex
                           for ent in d.get("draining", [])))

    def list_deployments(self) -> dict:
        # Shadow-autoscaler summary per deployment (full records live at
        # get_autoscale()/ /api/autoscale): read BEFORE taking the lock —
        # the autoscaler has its own lock and must never nest inside ours.
        autoscale: dict[str, dict] = {}
        if self._shadow is not None:
            for dep, rec in self._shadow.latest().items():
                autoscale[dep] = {
                    "mode": self._shadow.mode,
                    "recommended_replicas": rec["recommended_replicas"],
                    "rule": rec["rule"],
                    "ts": rec["ts"],
                }
        with self._lock:
            return {
                name: {
                    "num_replicas": d["num_replicas"],
                    "live_replicas": len(d["replicas"]),
                    "starting_replicas": len(d.get("starting", [])),
                    "draining_replicas": len(d.get("draining", [])),
                    "route_prefix": d["route_prefix"],
                    "pool_role": d.get("pool_role"),
                    "autoscaling": d.get("autoscaling"),
                    # Last stats probe per routable replica (short id →
                    # payload): serve.status() shows live load inline.
                    # Short id = the ActorID's unique TAIL — the hex head
                    # is the JobID, identical across replicas.
                    "replica_load": {
                        aid[-8:]: s
                        for aid, s in (d.get("replica_load") or {}).items()
                    },
                    # Last shadow-autoscaler verdict (None until the
                    # first evaluation lands or when mode=off).
                    "autoscale": autoscale.get(name),
                }
                for name, d in self.deployments.items()
            }

    def get_load(self) -> dict:
        """Per-replica load table (flight recorder): the last reconcile
        probe's stats — inflight/processed/idle plus any engine
        load_snapshot() payload — keyed deployment → routable replica.
        `serve.status()` and the load surface of the proxies
        render this; the least-loaded router will consume it."""
        with self._lock:
            return {
                name: {
                    "route_prefix": d["route_prefix"],
                    "num_replicas": d["num_replicas"],
                    "replicas": [
                        {"replica": aid[-8:], "actor_id": aid,
                         **(d.get("replica_load", {}).get(aid) or {})}
                        for aid, _h in d["replicas"]
                    ],
                }
                for name, d in self.deployments.items()
            }

    def shutdown(self) -> bool:
        self._stop = True
        with self._lock:
            names = list(self.deployments)
            for d in self.deployments.values():
                # Teardown, not scale-down: the controller is about to be
                # killed itself, so no reaper would outlive an async
                # drain — hard-kill (and reap anything mid-drain too).
                self._drain_replicas(d, all=True, hard=True)
                for ent in d.get("draining", []):
                    self._kill_replica(ent["h"])
                d["draining"] = []
            self.deployments.clear()
            self._bump_version_locked()
            self._checkpoint_locked()
        if self._shadow is not None:
            for name in names:
                self._shadow.forget(name)
        return True

    def install_chaos(self, rules) -> bool:
        """Arm a chaos spec in the controller process (fault-injection
        tests: kill-mid-reconcile, checkpoint write failure — see
        ray_tpu_torch/chaos.py)."""
        _chaos.install(rules)
        return True

    # ------------------------------------------------------------ reconcile

    def _bump_version_locked(self) -> None:
        """Version bump + push invalidation to every subscribed handle/proxy
        (LongPollHost parity — scaling events visible in <1s, no TTL). The
        publish itself runs on a worker thread: a slow/failing GCS must not
        stall the controller lock."""
        self.version += 1
        v = self.version

        def _publish():
            try:
                # Chaos fault point: a "drop" rule here loses the push —
                # handles/proxies must keep serving from their cached
                # table and converge through the TTL refresh.
                _chaos.hit("serve.routes.push")
                from ray_tpu_torch import api as _api

                _api._ensure_client().publish(ROUTES_CHANNEL, {"version": v})
            except Exception as e:
                logger.debug("routes push v%d failed (handles fall back "
                             "to TTL polling): %s", v, e)

        threading.Thread(target=_publish, daemon=True).start()

    @staticmethod
    def _kill_replica(handle) -> None:
        import ray_tpu_torch

        try:
            ray_tpu_torch.kill(handle)
        except Exception:  # graftlint: disable=EXC-SWALLOW (kill target may already be dead)
            pass

    def _drain_replicas(self, d: dict, all: bool = False, keep: int = 0,
                        hard: bool = False):
        """Shed serving replicas through the drain protocol: victims
        leave the routing table NOW (no new work routes to them), get a
        drain() RPC that finishes or exports their in-flight work, and
        are hard-killed only when the RPC answers or
        `serve_drain_timeout_s` expires (_reap_draining). `hard=True`
        (teardown paths / timeout<=0) restores the immediate kill.
        Booting replicas are always killed immediately — they hold no
        client work."""
        victims = list(d["replicas"] if all else d["replicas"][keep:])
        d["replicas"] = [] if all else d["replicas"][:keep]
        if all:
            for _aid, h, _t in d.get("starting", []):
                self._kill_replica(h)
            d["starting"] = []
        if not victims:
            return
        timeout = getattr(self._cfg, "serve_drain_timeout_s", 30.0)
        if hard or timeout <= 0:
            for _aid, handle in victims:
                self._kill_replica(handle)
            return
        now = time.monotonic()
        for aid, handle in victims:
            try:
                ref = handle.drain.remote(timeout)
            except Exception as e:
                # Submit failure is not a verdict — the reaper's
                # death-check/deadline still bounds the replica's life.
                logger.warning("drain submit to %s failed: %s", aid[-8:], e)
                ref = None
            d.setdefault("draining", []).append({
                "aid": aid, "h": handle, "ref": ref,
                "t0": now, "deadline": now + timeout,
            })

    def _reap_draining(self, only: str | None = None) -> None:
        """Finish the drain protocol: kill each draining replica once its
        drain() RPC answered, its deadline passed, or it died. Runs
        OUTSIDE the lock (kill/wait are RPCs); entries are removed under
        the lock by identity, so concurrent appends are never lost."""
        import ray_tpu_torch
        from ray_tpu_torch import api as _api

        with self._lock:
            # Claim entries under the lock: reconciles overlap (the
            # background loop plus deploy/delete-scoped ones), and two
            # passes reaping the same entry would double-kill and
            # double-count the drain metrics.
            snap = []
            for name, d in self.deployments.items():
                if only is not None and name != only:
                    continue
                for ent in d.get("draining", []):
                    if not ent.get("claimed"):
                        ent["claimed"] = True
                        snap.append((name, ent))
        if not snap:
            return
        client = _api._ensure_client()
        reaped: list[tuple[str, dict, str, dict | None]] = []
        for name, ent in snap:
            outcome = None
            res = None
            ref = ent.get("ref")
            if ref is not None:
                try:
                    ready, _p = ray_tpu_torch.wait([ref], num_returns=1, timeout=0)
                except Exception:  # graftlint: disable=EXC-SWALLOW (probe failure falls through to the death/deadline checks)
                    ready = []
                if ready:
                    try:
                        res = ray_tpu_torch.get(ref, timeout=5)
                        outcome = ("exported" if res.get("exported")
                                   else "clean")
                    except Exception:  # graftlint: disable=EXC-SWALLOW (replica died mid-drain; outcome recorded as dead)
                        outcome = "dead"
            if outcome is None:
                try:
                    dead = client.actor_state(
                        ent["h"]._actor_id.binary()).dead
                except Exception:  # graftlint: disable=EXC-SWALLOW (state probe failure: the deadline below still bounds the drain)
                    dead = False
                if dead:
                    outcome = "dead"
                elif time.monotonic() >= ent["deadline"]:
                    outcome = "timeout"
            if outcome is None:
                continue
            self._kill_replica(ent["h"])
            reaped.append((name, ent, outcome, res))
        with self._lock:
            reaped_set = {id(ent) for _n, ent, _o, _r in reaped}
            for name, ent in snap:
                if id(ent) not in reaped_set:
                    ent["claimed"] = False    # not done yet: next pass
            for name, ent, _o, _r in reaped:
                d = self.deployments.get(name)
                if d is not None:
                    d["draining"] = [e for e in d.get("draining", [])
                                     if e is not ent]
        if not reaped:
            return
        for name, ent, outcome, res in reaped:
            dur = time.monotonic() - ent["t0"]
            _DRAIN_TOTAL.inc(1.0, tags={"deployment": name,
                                        "outcome": outcome})
            _DRAIN_DURATION.observe(dur, tags={"deployment": name})
            exported = int((res or {}).get("exported", 0))
            if exported:
                _DRAIN_EXPORTED.inc(float(exported),
                                    tags={"deployment": name})
            logger.info("drained replica %s of %s: outcome=%s "
                        "exported=%d in %.2fs", ent["aid"][-8:], name,
                        outcome, exported, dur)

    def _loop(self):
        interval = getattr(self._cfg, "serve_reconcile_interval_s", 0.5)
        while not self._stop:
            try:
                self._reconcile_once()
            except Exception:
                # The reconcile loop IS the control plane: if every tick
                # fails, replicas never heal — keep looping, but loudly.
                logger.exception("reconcile tick failed")
            time.sleep(interval)

    def _autoscale_decision(self, d: dict, stats: list | None) -> None:
        """Queue-depth autoscaling (ref: autoscaling_policy.py
        BasicAutoscalingPolicy.get_decision_num_replicas): desired =
        ceil(total ongoing / target per replica), clamped to [min, max],
        applied after a sustained threshold crossing (up fast, down slow).
        Called under the lock with PRE-GATHERED stats."""
        ac = d.get("autoscaling")
        if not ac or stats is None:
            return
        if self._shadow is not None and self._shadow.mode == "enact":
            # The shadow autoscaler owns scaling in enact mode — two
            # policies adjusting num_replicas would fight each other.
            return
        total_ongoing = sum(s["inflight"] + s.get("queued", 0)
                            for s in stats)
        desired = math.ceil(total_ongoing / max(
            ac["target_ongoing_requests"], 1e-9))
        desired = max(ac["min_replicas"], min(desired, ac["max_replicas"]))
        now = time.monotonic()
        cur = d["num_replicas"]
        if desired == 0 and cur > 0:
            # Scale-TO-ZERO gates (beyond the sustained-undershoot timer):
            # every replica must have been idle for the downscale delay —
            # measured replica-side from its last completed request (a
            # cold-started replica counts from construction, so the waking
            # request can land before the first reap) — and a recent
            # handle-side wake-up (cold_ts) pins at least one replica for
            # the grace window.
            grace = getattr(self._cfg, "serve_cold_start_grace_s", 10.0)
            cold = d.get("cold_ts")
            if cold is not None and now - cold < grace:
                desired = 1
            elif (d.get("starting") or len(stats) < len(d["replicas"])
                  or any(s.get("idle_s", 1e9) < ac["downscale_delay_s"]
                         for s in stats)):
                # Booting capacity, unprobed replicas (struck this tick),
                # or recent activity: no evidence the deployment is idle.
                desired = 1
        if desired > cur:
            d["under_since"] = None
            if d["over_since"] is None:
                d["over_since"] = now
            if now - d["over_since"] >= ac["upscale_delay_s"]:
                d["num_replicas"] = desired
                d["over_since"] = None
        elif desired < cur:
            d["over_since"] = None
            if d["under_since"] is None:
                d["under_since"] = now
            if now - d["under_since"] >= ac["downscale_delay_s"]:
                d["num_replicas"] = desired
                d["under_since"] = None
        else:
            d["over_since"] = None
            d["under_since"] = None

    def _reconcile_once(self, only: str | None = None):
        """Desired → actual: start missing replicas, reap dead ones
        (ref: deployment_state.py:958 reconcile loop).

        Blocking probes (health checks, load stats) run OUTSIDE the lock so
        an unresponsive replica can't freeze get_routing/deploy, and they
        run in PARALLEL under one shared deadline (submit all, then one
        wait) — a wedged replica costs probe_timeout per tick, not per
        replica. Results are applied under the lock only if the deployment
        generation is unchanged, and only as targeted removals: replicas
        added concurrently (request_scale_up) must not be clobbered by a
        stale snapshot."""
        import ray_tpu_torch
        from ray_tpu_torch.serve.replica import Replica

        # Chaos fault point: a "kill" rule here dies mid-reconcile — the
        # scenario the checkpoint/adopt restart contract must survive.
        _chaos.hit("serve.controller.reconcile")
        # Finish any in-flight drains first: a drained replica's kill
        # must not wait behind this tick's probe round.
        self._reap_draining(only)
        with self._lock:
            snapshot = [
                (name, d["generation"], list(d["replicas"]),
                 list(d.get("starting", [])))
                for name, d in self.deployments.items()
                if only is None or name == only
            ]
        from ray_tpu_torch.exceptions import ActorDiedError

        probe_timeout = getattr(self._cfg, "serve_health_probe_timeout_s", 10.0)
        fail_limit = max(1, int(getattr(
            self._cfg, "serve_health_failure_threshold", 3)))
        probes = []     # (name, aid, ref, is_starting)
        for name, gen, replicas, starting in snapshot:
            for aid, handle in replicas:
                # Serving replicas are always probed via stats() (it
                # doubles as the health verdict): the payload now carries
                # the engine load_snapshot the load surface + autoscaler
                # read, so every deployment reports load, not just
                # autoscaled ones.
                try:
                    ref = handle.stats.remote()
                except Exception:  # graftlint: disable=EXC-SWALLOW (failed probe submit IS the unhealthy verdict — strikes accrue below)
                    ref = None
                probes.append((name, aid, ref, False))
            for aid, handle, _spawned in starting:
                try:
                    ref = handle.health.remote()
                except Exception:  # graftlint: disable=EXC-SWALLOW (failed probe submit IS the unhealthy verdict)
                    ref = None
                probes.append((name, aid, ref, True))
        ready_ids: set = set()
        refs = [ref for (_n, _a, ref, _s) in probes if ref is not None]
        if refs:
            try:
                ready, _pending = ray_tpu_torch.wait(
                    refs, num_returns=len(refs), timeout=probe_timeout)
                ready_ids = {r.id.binary() for r in ready}
            except Exception as e:
                # Every probe reads as unready this tick → strikes for all
                # replicas at once. That mass-unhealthy signal needs a why.
                logger.warning("health probe wait failed (all replicas "
                               "strike this tick): %s", e)
        # name → (gen, drop_serving, promote, drop_starting, stats) where
        # stats is a list of (actor_id, stats-dict) pairs from serving
        # replicas (starting replicas answer health() only).
        probed: dict[str, tuple] = {
            name: (gen, set(), set(), set(), [])
            for name, gen, _r, _st in snapshot
        }
        for name, aid, ref, is_starting in probes:
            gen, drop, promote, drop_start, stats = probed[name]
            ok = False
            died = False
            if ref is not None and ref.id.binary() in ready_ids:
                try:
                    s = ray_tpu_torch.get(ref, timeout=5)
                    ok = True
                    if not is_starting:
                        # Probe wall time rides into the pushed load
                        # table so routers can staleness-decay it.
                        s["ts"] = time.time()
                        stats.append((aid, s))
                except ActorDiedError:
                    died = True
                except Exception:  # graftlint: disable=EXC-SWALLOW (failed probe read = unhealthy verdict; strike accrues)
                    pass
            if is_starting:
                # STARTING replicas: no strikes — unready is their normal
                # state. Ready → promote into the routing table; dead →
                # drop (the capacity loop respawns); else keep waiting
                # (the start timeout is enforced under the lock below).
                if ok:
                    promote.add(aid)
                elif died:
                    drop_start.add(aid)
                continue
            if died:
                with self._health_lock:
                    self._health_fails.pop(aid, None)  # definitively dead
                drop.add(aid)
            elif ok:
                with self._health_lock:
                    self._health_fails.pop(aid, None)
            else:
                # Timeout / transient: strike, but keep the replica in
                # rotation until the consecutive-failure threshold — it
                # contributes no stats this tick. At most one strike per
                # probe window (overlapping reconciles share the window —
                # the lock makes the get→store below atomic against them).
                now = time.monotonic()
                with self._health_lock:
                    n, last = self._health_fails.get(aid, (0, 0.0))
                    if now - last >= probe_timeout * 0.5:
                        n += 1
                        self._health_fails[aid] = (n, now)
                    if n >= fail_limit:
                        self._health_fails.pop(aid, None)
                if n >= fail_limit:
                    drop.add(aid)
        # Drop strike bookkeeping for replicas no longer tracked anywhere.
        if only is None:
            seen_aids = {aid for (_n, aid, _r, _s) in probes}
            with self._health_lock:
                for aid in list(self._health_fails):
                    if aid not in seen_aids:
                        del self._health_fails[aid]
        start_timeout = getattr(
            self._cfg, "serve_replica_start_timeout_s", 180.0)
        load_refreshed = False
        with self._lock:
            for name, (gen, drop, promote, drop_start, stats) in \
                    probed.items():
                d = self.deployments.get(name)
                if d is None or d["generation"] != gen:
                    continue  # redeployed/deleted mid-probe
                d.setdefault("starting", [])
                changed = bool(drop)
                if drop:
                    d["replicas"] = [
                        (aid, h) for (aid, h) in d["replicas"]
                        if aid not in drop
                    ]
                now = time.monotonic()
                keep_starting = []
                for aid, h, spawned in d["starting"]:
                    if aid in promote:
                        d["replicas"].append((aid, h))
                        changed = True
                    elif aid in drop_start:
                        changed = True
                    elif now - spawned > start_timeout:
                        # Stuck boot: replace it (capacity loop below).
                        try:
                            ray_tpu_torch.kill(h)
                        except Exception:  # graftlint: disable=EXC-SWALLOW (kill target may already be dead)
                            pass
                        changed = True
                    else:
                        keep_starting.append((aid, h, spawned))
                d["starting"] = keep_starting
                # Refresh the per-replica load table: new probe results
                # win; a replica that merely missed this probe window
                # keeps its last payload (a blank load view on one
                # timeout would whipsaw the router); removed replicas
                # drop out.
                live = {aid for aid, _h in d["replicas"]}
                merged = {aid: s
                          for aid, s in (d.get("replica_load") or {}).items()
                          if aid in live}
                merged.update(
                    {aid: s for aid, s in stats if aid in live})
                d["replica_load"] = merged
                self._record_load_history(name, d)
                self._autoscale_decision(d, [s for _aid, s in stats])
                total = len(d["replicas"]) + len(d["starting"])
                while total > d["num_replicas"]:
                    if d["starting"]:
                        # Shed unrouted capacity first — killing a booting
                        # replica cancels work no client is waiting on.
                        _aid, h, _t = d["starting"].pop()
                        try:
                            ray_tpu_torch.kill(h)
                        except Exception:  # graftlint: disable=EXC-SWALLOW (kill target may already be dead)
                            pass
                    else:
                        self._drain_replicas(d, keep=d["num_replicas"])
                    total = len(d["replicas"]) + len(d["starting"])
                    changed = True
                while total < d["num_replicas"]:
                    opts = {"max_concurrency": max(2, d["max_concurrent_queries"])}
                    if d["resources"]:
                        opts["resources"] = d["resources"]
                    replica_cls = ray_tpu_torch.remote(Replica).options(**opts)
                    h = replica_cls.remote(
                        d["cls_blob"], d["init_args"], d["init_kwargs"],
                        d["user_config"], name,
                    )
                    d["starting"].append(
                        (h._actor_id.hex(), h, time.monotonic()))
                    total += 1
                    changed = True
                if changed:
                    self._bump_version_locked()
                    self._checkpoint_locked()
                elif stats:
                    load_refreshed = True
            if load_refreshed:
                # Load-only refresh: ONE push for the whole probe round
                # (same pubsub bump the routing table uses) WITHOUT a
                # checkpoint write — load is runtime-only state a
                # restarted controller re-probes anyway.
                self._bump_version_locked()
        if only is None:
            # Full passes own the cross-deployment bookkeeping: retire
            # history series of replicas that left, then let the shadow
            # autoscaler evaluate (it RPCs the series store — never under
            # the lock, never on deploy/scale-scoped passes).
            self._retire_load_series()
            self._run_autoscale()

    def _kv_sweep_loop(self) -> None:
        interval = getattr(self._cfg, "serve_kv_sweep_interval_s", 10.0)
        while not self._stop:
            time.sleep(min(interval, 1.0))
            try:
                self._sweep_kv_orphans()
            except Exception:
                logger.exception("kv orphan sweep failed")

    def _sweep_kv_orphans(self) -> None:
        """Orphan-page sweep (serve/kv_objects.py): free donated KV
        page-set objects whose donor replica is no longer a member of
        any deployment — a SIGKILLed donor never releases its owned
        refs, so without this its pages leak the node store — plus
        anything past `serve_kv_object_ttl_s`. Cadence-gated; never
        under the lock (GCS index scan + frees are RPCs)."""
        now = time.monotonic()
        interval = getattr(self._cfg, "serve_kv_sweep_interval_s", 10.0)
        if now - self._kv_sweep_last < interval:
            return
        self._kv_sweep_last = now
        with self._lock:
            live = {aid
                    for d in self.deployments.values()
                    for aid, _h in d["replicas"]}
            live |= {aid
                     for d in self.deployments.values()
                     for aid, _h, _t in d.get("starting", [])}
            live |= {ent["aid"]
                     for d in self.deployments.values()
                     for ent in d.get("draining", [])}
        try:
            from ray_tpu_torch import api as _api
            from ray_tpu_torch.serve import kv_objects

            kv_objects.sweep_cluster(
                _api._ensure_client(), live,
                getattr(self._cfg, "serve_kv_object_ttl_s", 120.0))
        except Exception as e:  # noqa: BLE001 — next pass retries
            logger.debug("kv orphan sweep failed: %s", e)

    # ------------------------------------------- decision-plane history

    def _record_load_history(self, name: str, d: dict) -> None:
        """Re-export this reconcile's per-replica load view as
        deployment-tagged gauges (called under the lock; gauge sets are
        local dict writes). The worker flush loop ships them to the GCS,
        whose series store keeps the rolling history."""
        for aid, _h in d["replicas"]:
            s = d.get("replica_load", {}).get(aid)
            if s is None:
                continue
            # Same extraction as the routing-table push: the gauge
            # history and the router's pushed load must never diverge.
            vals = self._load_row(s)
            tags = {"deployment": name, "replica": aid[-8:]}
            for key, gauge in _REPLICA_LOAD_GAUGES.items():
                gauge.set(vals[key], tags=tags)
            self._load_series.add((name, aid[-8:]))

    def _retire_load_series(self) -> None:
        """Drop history gauges of replicas (or whole deployments) no
        longer present: the next flush omits them, so the GCS series
        store tombstones their history instead of freezing a stale last
        value forever."""
        with self._lock:
            live = {(name, aid[-8:])
                    for name, d in self.deployments.items()
                    for aid, _h in d["replicas"]}
            stale = self._load_series - live
            self._load_series &= live
        for name, rid in stale:
            tags = {"deployment": name, "replica": rid}
            for gauge in _REPLICA_LOAD_GAUGES.values():
                gauge.remove(tags=tags)

    def _run_autoscale(self) -> None:
        """Shadow-autoscaler tick (cadence-gated): evaluate every
        deployment against the series store, publish the recommendation
        gauge + decision record, and in `enact` mode apply it to
        num_replicas so the normal reconcile scale paths (spawn / drain)
        carry it out."""
        if self._shadow is None:
            return
        now = time.monotonic()
        interval = getattr(self._cfg, "serve_autoscale_interval_s", 2.0)
        if now - self._autoscale_last < interval:
            return
        self._autoscale_last = now
        with self._lock:
            targets = [(name, d["num_replicas"], d.get("autoscaling"))
                       for name, d in self.deployments.items()]
        import dataclasses

        for name, cur, ac in targets:
            try:
                policy = self._shadow.policy
                if ac:
                    # A deployment's own autoscaling_config wins for
                    # bounds and target load; the policy's windows/
                    # hysteresis stay. Inside the try: an inconsistent
                    # config (min > max) must fail THIS deployment's
                    # evaluation, not abort the rest each tick.
                    policy = dataclasses.replace(
                        policy,
                        min_replicas=int(ac["min_replicas"]),
                        max_replicas=max(1, int(ac["max_replicas"])),
                        target_ongoing=float(ac.get(
                            "target_ongoing_requests",
                            policy.target_ongoing)))
                record = self._shadow.evaluate(name, cur, policy=policy)
            except Exception:
                # One deployment's bad evaluation must not silence the
                # rest (or the reconcile loop hosting this).
                logger.exception("shadow autoscale failed for %s", name)
                continue
            with self._lock:
                d = self.deployments.get(name)
                if d is not None:
                    # Overload-shed gate input (routing table push):
                    # the recommendation is pinned at max_replicas AND
                    # scaling is genuinely exhausted — in enact mode the
                    # recommendation IS the count; in shadow mode
                    # nothing enacts it, so the count itself must
                    # already sit at the policy max. Without that gate a
                    # shadow-mode deployment far below max would shed
                    # queued-but-servable traffic on an observe-only
                    # recommendation.
                    d["overload_pinned"] = bool(
                        record.get("pinned_at_max")
                        and (self._shadow.mode == "enact"
                             or cur >= policy.max_replicas))
            if self._shadow.mode != "enact" or not record["changed"]:
                continue
            rec = record["recommended_replicas"]
            # Blast-radius guard: one enactment moves num_replicas at
            # most max_enact_step — a single bad decision window can't
            # mass-kill (or mass-spawn) a fleet. The autoscaler
            # re-anchors on the actual count each evaluation, so a
            # clamped move converges over cooldown-spaced steps.
            step = max(1, int(getattr(
                self._cfg, "serve_autoscale_max_enact_step", 8)))
            with self._lock:
                d = self.deployments.get(name)
                if rec < 1 and d is not None:
                    # Scale-to-zero gate (mirrors _autoscale_decision): a
                    # recent handle-side wake-up means a request is still
                    # landing — enacting 0 now would kill the replica it
                    # is waiting on.
                    grace = getattr(self._cfg,
                                    "serve_cold_start_grace_s", 10.0)
                    cold = d.get("cold_ts")
                    if cold is not None and \
                            time.monotonic() - cold < grace:
                        continue
                if d is not None and d["num_replicas"] != rec:
                    cur_n = d["num_replicas"]
                    target = max(cur_n - step, min(cur_n + step, rec))
                    # Chaos fault point: a "kill" rule here dies BETWEEN
                    # the decision record (already retained/published by
                    # evaluate()) and the scale apply — the restarted
                    # controller must RE-DERIVE the recommendation from
                    # the series store against its checkpointed
                    # (pre-enact) num_replicas, never double-apply.
                    _chaos.hit("serve.controller.enact")
                    logger.info("autoscale enact: %s %d -> %d (%s%s)",
                                name, cur_n, target, record["rule"],
                                "" if target == rec
                                else f", clamped from {rec}")
                    d["num_replicas"] = target
                    d["over_since"] = None
                    d["under_since"] = None
                    self._checkpoint_locked()

    def get_autoscale(self) -> dict:
        """Decision-plane read model (dashboard /api/autoscale): mode +
        per-deployment current/recommended replicas and the retained
        decision records (oldest → newest), each carrying its inputs,
        window aggregates, rule fired, and hysteresis state."""
        mode = "off" if self._shadow is None else self._shadow.mode
        out: dict = {"mode": mode, "deployments": {}}
        if self._shadow is None:
            return out
        with self._lock:
            targets = [(name, d["num_replicas"])
                       for name, d in self.deployments.items()]
        for name, cur in targets:
            out["deployments"][name] = {
                "current_replicas": cur,
                "recommended_replicas": self._shadow.recommended(name),
                "decisions": self._shadow.decisions(name),
            }
        return out
