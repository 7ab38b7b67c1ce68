"""Shadow autoscaler: explainable replica-count recommendations over
metric history.

Ray Serve's autoscaler (autoscaling_policy.py BasicAutoscalingPolicy)
decides replica counts from a rolling window of per-replica metrics.
This module reproduces that decision plane *observably first*: a
declarative `AutoscalePolicy` consumes queue-depth / TTFT / SLO-burn-rate
series (from the GCS series store via `state.query_series`, or any
injected `series_fn` with the same shape — the ramp bench feeds a local
`obs_series.SeriesStore`) through a hysteresis + cooldown state machine,
and every evaluation produces a full **decision record** — inputs,
window aggregates, the rule that fired, hysteresis state — so a scale
decision can be explained after the fact, not just observed.

Modes (`serve_autoscale_mode`):
- ``shadow`` (default): recommendations only. Each evaluation sets the
  `serve_autoscale_recommended_replicas{deployment}` gauge (whose history
  lands back in the series store — the recommendation trail is itself a
  series); a recommendation *change* additionally emits an
  `autoscale.recommend` cluster event carrying the decision record.
- ``enact``: the controller applies recommendations to
  `num_replicas`, which drives the existing scale paths (replica spawn /
  drain on scale-down). The shadow trace IS the dry run of this.
- ``off``: nothing runs.

Rules, in precedence order (the fired rule is named in the record):
1. ``scale_up_queue``   — windowed mean of summed per-replica ongoing
   (inflight + queued) exceeds target_ongoing × current replicas.
2. ``scale_up_burn``    — TTFT SLO burn rate over the window exceeds
   burn_threshold: latency says capacity is short even if queues don't.
3. ``scale_up_ttft``    — windowed max replica TTFT EWMA exceeds the
   target TTFT p95 (same intent as 2, engine-side signal).
4. ``scale_down_idle``  — windowed demand supports fewer replicas.
A raw desire must SUSTAIN (up_sustain_s / down_sustain_s) before the
recommendation moves, and after a move further moves wait out a
cooldown — the anti-flap contract the ramp bench pins.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import threading
import time
from collections import deque

from ray_tpu_torch import profiling as _profiling

logger = logging.getLogger(__name__)

_RECOMMENDED = _profiling.Gauge(
    "serve_autoscale_recommended_replicas",
    description="Shadow-autoscaler recommended replica count",
    tag_keys=("deployment",))

# The SLO whose burn rate gates scale_up_burn (slo.py default objective).
TTFT_SLO = "llm_ttft_p95"


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Declarative scaling policy; all fields have serve_autoscale_*
    config-knob counterparts and deployment autoscaling_config
    (min/max/target_ongoing_requests) overrides the bounds/target."""

    min_replicas: int = 1
    max_replicas: int = 8
    window_s: float = 30.0
    target_ongoing: float = 4.0
    target_ttft_p95_ms: float = 2000.0
    burn_threshold: float = 1.0
    up_sustain_s: float = 2.0
    down_sustain_s: float = 10.0
    up_cooldown_s: float = 5.0
    down_cooldown_s: float = 20.0

    def __post_init__(self):
        if self.min_replicas < 0:
            raise ValueError("min_replicas must be >= 0")
        if self.max_replicas < max(1, self.min_replicas):
            raise ValueError("max_replicas must be >= max(1, min_replicas)")
        if self.target_ongoing <= 0:
            raise ValueError("target_ongoing must be > 0")

    @classmethod
    def from_config(cls, cfg=None, **overrides) -> "AutoscalePolicy":
        if cfg is None:
            from ray_tpu_torch.core.config import runtime_config

            cfg = runtime_config()
        ttft_ms = getattr(cfg, "serve_autoscale_ttft_p95_ms", 0.0)
        if not ttft_ms:
            ttft_ms = getattr(cfg, "slo_ttft_p95_s", 2.0) * 1000.0
        kw = dict(
            min_replicas=int(getattr(cfg, "serve_autoscale_min_replicas", 1)),
            max_replicas=int(getattr(cfg, "serve_autoscale_max_replicas", 8)),
            window_s=getattr(cfg, "serve_autoscale_window_s", 30.0),
            target_ongoing=getattr(
                cfg, "serve_autoscale_target_ongoing", 4.0),
            target_ttft_p95_ms=ttft_ms,
            burn_threshold=getattr(
                cfg, "serve_autoscale_burn_threshold", 1.0),
            up_sustain_s=getattr(cfg, "serve_autoscale_up_sustain_s", 2.0),
            down_sustain_s=getattr(
                cfg, "serve_autoscale_down_sustain_s", 10.0),
            up_cooldown_s=getattr(
                cfg, "serve_autoscale_up_cooldown_s", 5.0),
            down_cooldown_s=getattr(
                cfg, "serve_autoscale_down_cooldown_s", 20.0),
        )
        kw.update(overrides)
        return cls(**kw)


def window_stats(series_list: list[dict]) -> dict:
    """Aggregate scalar series for the policy: per-series mean/latest/max
    over its in-window points, then summed (means, latests) and maxed
    across series — "mean total queue depth" = sum of per-replica means;
    `latest_max` (max of per-series newest points) is the "now" view the
    latency rules gate on, vs `max` over the whole window."""
    means, latests = [], []
    vmax = None
    samples = 0
    for s in series_list:
        pts = [float(v) for _ts, v in s.get("points", ())
               if isinstance(v, (int, float))]
        if not pts:
            continue
        samples += len(pts)
        means.append(sum(pts) / len(pts))
        latests.append(pts[-1])
        m = max(pts)
        vmax = m if vmax is None else max(vmax, m)
    return {"mean_sum": sum(means), "latest_sum": sum(latests),
            "latest_max": max(latests, default=None),
            "max": vmax, "samples": samples, "series": len(means)}


class ShadowAutoscaler:
    """Per-deployment recommendation state machine over metric series.

    `series_fn(name, tags, window_s) -> list[series-dict]` defaults to
    `state.query_series` (the GCS store); the ramp bench and tests inject
    a local store's `.query`. Thread-safe: the controller's reconcile
    thread evaluates while dashboard threads read decisions()."""

    def __init__(self, policy: AutoscalePolicy | None = None,
                 mode: str = "shadow", series_fn=None,
                 emit_events: bool = True, history: int = 256):
        if mode not in ("shadow", "enact"):
            raise ValueError(f"mode must be 'shadow' or 'enact', got {mode!r}")
        self.policy = policy or AutoscalePolicy()
        self.mode = mode
        self._series_fn = series_fn
        self._emit = emit_events
        self._history = max(1, int(history))
        # deployment → hysteresis state (monotonic clocks).
        self._state: dict[str, dict] = {}
        # deployment → ring of decision records (oldest → newest).
        self._decisions: dict[str, deque] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------ inputs

    def _series(self, name: str, tags: dict, window_s: float) -> list[dict]:
        if self._series_fn is not None:
            return self._series_fn(name, tags, window_s)
        from ray_tpu_torch import state

        return state.query_series(name, tags=tags, window_s=window_s)

    def _gather(self, deployment: str, policy: AutoscalePolicy) -> dict:
        w = policy.window_s
        dep = {"deployment": deployment}
        # Tombstoned series are removed replicas' trailing history: real
        # for post-mortems, PHANTOM load for capacity math — right after
        # a scale-down their in-window points would re-inflate demand
        # and bounce the recommendation straight back up.
        live = lambda rows: [s for s in rows if not s.get("tombstoned")]
        try:
            ongoing = window_stats(live(
                self._series("serve_replica_ongoing", dep, w)))
            queue = window_stats(live(
                self._series("serve_replica_queue_depth", dep, w)))
            ttft = window_stats(live(
                self._series("serve_replica_ttft_ewma_ms", dep, w)))
            burn = window_stats(live(
                self._series("slo_burn_rate", {"slo": TTFT_SLO}, w)))
        except Exception as e:
            # A degraded GCS must stall recommendations, not the
            # controller: record the outage as a no_data decision.
            logger.debug("autoscale series query failed for %s: %s",
                         deployment, e)
            return {"error": str(e), "samples": 0}
        return {
            "window_s": w,
            "samples": ongoing["samples"],
            "ongoing_mean": round(ongoing["mean_sum"], 4),
            "ongoing_latest": round(ongoing["latest_sum"], 4),
            "queue_depth_mean": round(queue["mean_sum"], 4),
            "queue_depth_max": queue["max"],
            "ttft_ewma_ms_max": ttft["max"],
            "ttft_ewma_ms_latest": ttft["latest_max"],
            "burn_rate_max": burn["max"],
            "burn_rate_latest": burn["latest_max"],
            "burn_samples": burn["samples"],
        }

    # ---------------------------------------------------------- evaluate

    def evaluate(self, deployment: str, current_replicas: int,
                 policy: AutoscalePolicy | None = None,
                 now: float | None = None) -> dict:
        """One evaluation → the decision record (also retained in the
        per-deployment ring and, on a recommendation change, emitted as
        an `autoscale.recommend` cluster event)."""
        policy = policy or self.policy
        mono = time.monotonic() if now is None else now
        wall = time.time()
        inputs = self._gather(deployment, policy)
        with self._lock:
            st = self._state.setdefault(deployment, {
                "over_since": None, "under_since": None,
                "last_up": None, "last_down": None, "recommended": None,
            })
            rec_prev = (st["recommended"] if st["recommended"] is not None
                        else current_replicas)
            if self.mode == "enact":
                # Enacted recommendations ARE the replica count; an
                # external num_replicas change (cold-start wake, manual
                # scale) re-anchors the state machine to reality instead
                # of leaving it comparing against a stale trail — e.g. a
                # woken scale-to-zero deployment must read as 1, not as
                # the 0 the autoscaler last recommended.
                rec_prev = current_replicas
            record = self._decide_locked(deployment, policy, st, inputs,
                                         current_replicas, rec_prev, mono)
            record["ts"] = wall
            record["mode"] = self.mode
            ring = self._decisions.setdefault(
                deployment, deque(maxlen=self._history))
            ring.append(record)
        _RECOMMENDED.set(float(record["recommended_replicas"]),
                         tags={"deployment": deployment})
        if record["changed"] and self._emit:
            self._emit_event(record)
        return record

    def _decide_locked(self, deployment: str, policy: AutoscalePolicy,
                       st: dict, inputs: dict, cur: int, rec_prev: int,
                       now: float) -> dict:
        base = {
            "deployment": deployment,
            "current_replicas": cur,
            "prev_recommended": rec_prev,
            "inputs": inputs,
            "policy": dataclasses.asdict(policy),
        }
        clamp = lambda n: max(policy.min_replicas,
                              min(int(n), policy.max_replicas))
        if not inputs.get("samples"):
            # No demand signal in the window (cold store, query outage):
            # hold the previous recommendation, never fabricate one.
            st["over_since"] = st["under_since"] = None
            return {**base, "rule": "no_data", "changed": False,
                    "recommended_replicas": rec_prev,
                    "pinned_at_max": False,
                    "hysteresis": self._hyst(st, now)}
        # Raw desire: capacity for the windowed mean demand...
        desired = clamp(math.ceil(
            inputs["ongoing_mean"] / policy.target_ongoing))
        rule = ("scale_up_queue" if desired > rec_prev
                else "scale_down_idle" if desired < rec_prev else "hold")
        # ...bumped one replica past current when latency says capacity
        # is short even though queues look fine. Gated on the LATEST
        # in-window point, not the window max: after a ramp-down the
        # burn gauge's stale tail stays in the window for window_s and a
        # max-gate would override scale_down and ratchet the
        # recommendation up on load that no longer exists (the sustain
        # timer, which needs the gate to hold across evaluations, is
        # what debounces single-point noise).
        if desired <= rec_prev:
            burn = inputs.get("burn_rate_latest")
            ttft = inputs.get("ttft_ewma_ms_latest")
            if burn is not None and burn > policy.burn_threshold:
                desired, rule = clamp(rec_prev + 1), "scale_up_burn"
            elif (ttft is not None
                    and ttft > policy.target_ttft_p95_ms):
                desired, rule = clamp(rec_prev + 1), "scale_up_ttft"
            if desired == rec_prev and rule != "hold":
                rule = "hold"           # clamp ate the bump (at max)
        recommended = rec_prev
        changed = False
        if desired > rec_prev:
            st["under_since"] = None
            if st["over_since"] is None:
                st["over_since"] = now
            if now - st["over_since"] < policy.up_sustain_s:
                rule = f"{rule}:sustain"
            elif (st["last_up"] is not None
                    and now - st["last_up"] < policy.up_cooldown_s):
                rule = f"{rule}:cooldown"
            else:
                recommended, changed = desired, True
                st["over_since"] = None
                st["last_up"] = now
        elif desired < rec_prev:
            st["over_since"] = None
            if st["under_since"] is None:
                st["under_since"] = now
            if now - st["under_since"] < policy.down_sustain_s:
                rule = f"{rule}:sustain"
            elif (st["last_down"] is not None
                    and now - st["last_down"] < policy.down_cooldown_s):
                rule = f"{rule}:cooldown"
            else:
                recommended, changed = desired, True
                st["under_since"] = None
                st["last_down"] = now
        else:
            st["over_since"] = st["under_since"] = None
        st["recommended"] = recommended
        return {**base, "rule": rule, "desired_raw": desired,
                "recommended_replicas": recommended, "changed": changed,
                # Demand at/above the clamp with the recommendation
                # already there: scaling can't help any further — the
                # overload-shedding gate (proxy 503 + Retry-After)
                # reads this off the routing table.
                "pinned_at_max": (recommended >= policy.max_replicas
                                  and desired >= policy.max_replicas),
                "hysteresis": self._hyst(st, now)}

    @staticmethod
    def _hyst(st: dict, now: float) -> dict:
        """Hysteresis state snapshot, as ages (portable across clocks)."""
        age = lambda t: None if t is None else round(now - t, 3)
        return {"over_for_s": age(st["over_since"]),
                "under_for_s": age(st["under_since"]),
                "since_last_up_s": age(st["last_up"]),
                "since_last_down_s": age(st["last_down"])}

    def _emit_event(self, record: dict) -> None:
        from ray_tpu_torch import state as _state

        _state.emit_cluster_event(
            "autoscale.recommend",
            f"{record['deployment']}: recommend "
            f"{record['prev_recommended']} -> "
            f"{record['recommended_replicas']} replicas "
            f"({record['rule']}, mode={record['mode']})",
            severity="INFO", source="autoscale", **record)

    # ------------------------------------------------------------- reads

    def recommended(self, deployment: str) -> int | None:
        with self._lock:
            st = self._state.get(deployment)
            return None if st is None else st["recommended"]

    def latest(self) -> dict[str, dict]:
        """Newest decision record per deployment — the O(deployments)
        read status surfaces use (decisions() copies whole rings)."""
        with self._lock:
            return {dep: ring[-1]
                    for dep, ring in self._decisions.items() if ring}

    def decisions(self, deployment: str | None = None,
                  limit: int | None = None) -> list[dict]:
        """Retained decision records, oldest → newest."""
        with self._lock:
            if deployment is not None:
                out = list(self._decisions.get(deployment, ()))
            else:
                out = [r for ring in self._decisions.values()
                       for r in ring]
                out.sort(key=lambda r: r["ts"])
        return out[-limit:] if limit else out

    def forget(self, deployment: str) -> None:
        """Drop a deleted deployment's state + records (its gauge series
        is removed so the store tombstones the recommendation trail)."""
        with self._lock:
            self._state.pop(deployment, None)
            self._decisions.pop(deployment, None)
        _RECOMMENDED.remove(tags={"deployment": deployment})


__all__ = ["AutoscalePolicy", "ShadowAutoscaler", "window_stats",
           "TTFT_SLO"]
