"""SLO monitor: declarative latency objectives over the serve histograms.

The roadmap's SLO-driven autoscaler needs "are we violating?" as a live,
queryable number, not a post-hoc bench read. This module evaluates
declarative objectives ("p95 of `serve_llm_ttft_s` ≤ 2 s over 5 min")
against the cluster's existing Prometheus-style histogram rows
(state.metrics_rows — the same rows /metrics renders) and exposes the
standard SRE framing:

- **burn rate** = bad-fraction / error-budget, where an objective of
  quantile q leaves an error budget of (1 - q). Burn 1.0 = consuming the
  budget exactly; > 1.0 = violating.
- Rolling windows are built by differencing cumulative histogram
  snapshots between evaluations: a persistent monitor (the dashboard's
  /api/slo) sees true windowed rates after its first poll; a one-shot
  caller (the CLI) sees lifetime totals — the right read for "how is it
  doing overall", labeled `baseline: lifetime` in the status. Alarms
  (events + burn gauges) only arm once a real prior snapshot exists:
  a freshly restarted monitor must not re-litigate a morning incident
  from hours-old cumulative data.
- Bucket math is conservative: observations in the bucket containing the
  threshold count as bad (an SLO monitor must not under-report).

Each evaluation sets `slo_burn_rate{slo}` gauges; an ok→violating
transition emits a structured `slo.violation` cluster event
(state.emit_cluster_event), mirrored in `SloMonitor.events` for
clusterless readers.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time

from ray_tpu_torch import profiling as _profiling

logger = logging.getLogger(__name__)

_BURN_RATE = _profiling.Gauge(
    "slo_burn_rate",
    description="SLO error-budget burn rate (>1 = violating)",
    tag_keys=("slo",))


@dataclasses.dataclass(frozen=True)
class Objective:
    """`quantile` of histogram `metric` must be ≤ `threshold_s` over a
    rolling `window_s`. `tags` subset-filters the metric's series (e.g.
    {"route": "/llm"}); empty = all series merged."""

    name: str
    metric: str
    quantile: float
    threshold_s: float
    window_s: float = 300.0
    tags: dict = dataclasses.field(default_factory=dict)


def default_objectives() -> list[Objective]:
    """The serving-tier defaults, thresholds from the slo_* config knobs:
    LLM TTFT p95 and ingress request-latency p95."""
    from ray_tpu_torch.core.config import runtime_config

    cfg = runtime_config()
    w = getattr(cfg, "slo_window_s", 300.0)
    return [
        Objective("llm_ttft_p95", "serve_llm_ttft_s", 0.95,
                  getattr(cfg, "slo_ttft_p95_s", 2.0), window_s=w),
        Objective("http_request_p95", "serve_request_latency_s", 0.95,
                  getattr(cfg, "slo_request_p95_s", 5.0), window_s=w),
    ]


class SloMonitor:
    """Evaluate objectives against aggregated metric rows.

    `rows_fn` defaults to state.metrics_rows (the cluster hub view);
    tests inject synthetic rows. evaluate() is safe to call from
    concurrent dashboard handler threads.

    `export=False` makes the monitor passive: no `slo_burn_rate` gauges,
    no `slo.violation` cluster events — for one-shot readers (the CLI)
    whose first evaluation is lifetime totals, not a rolling window; a
    read-only command must not file alarms or overwrite live gauges.

    Cold start: a fresh monitor (controller/dashboard restart) seeds its
    rolling window from the GCS series store — the cumulative histogram
    snapshot ~window_s ago becomes the baseline, so the first evaluation
    is already windowed and alarms re-arm immediately instead of waiting
    out a second poll. `seed=False` (or no history: empty store,
    clusterless process) falls back to the lifetime-first behavior.
    `history_fn(metric, tags, window_s) -> series rows` injects a store
    for tests / the ramp bench; default is state.query_series, guarded
    so seeding never auto-starts a cluster."""

    def __init__(self, objectives: list[Objective] | None = None,
                 rows_fn=None, export: bool = True, seed: bool = True,
                 history_fn=None):
        self.objectives = (list(objectives) if objectives is not None
                           else default_objectives())
        self._rows_fn = rows_fn
        self._export = export
        self._seed = seed
        self._history_fn = history_fn
        self._seed_attempted: set[str] = set()
        # objective name → deque[(monotonic ts, per-bucket counts)]
        self._snaps: dict[str, collections.deque] = {
            o.name: collections.deque() for o in self.objectives}
        self._violating: dict[str, bool] = {
            o.name: False for o in self.objectives}
        self._lock = threading.Lock()
        self.events: list[dict] = []    # local mirror of emitted violations

    def _rows(self) -> list[dict]:
        if self._rows_fn is not None:
            return self._rows_fn()
        from ray_tpu_torch import state

        return state.metrics_rows()

    def evaluate(self, rows: list[dict] | None = None,
                 now: float | None = None) -> list[dict]:
        """One evaluation pass → a status dict per objective."""
        if rows is None:
            rows = self._rows()
        if now is None:
            now = time.monotonic()
        out = []
        pending: list[tuple[str, dict]] = []
        with self._lock:
            for obj in self.objectives:
                out.append(self._evaluate_one(obj, rows, now, pending))
        # Emit AFTER the lock drops: emit_cluster_event is an RPC, and a
        # slow GCS under the lock would stall every concurrent evaluate().
        if self._export:
            from ray_tpu_torch import state as _state

            for msg, ev in pending:
                _state.emit_cluster_event("slo.violation", msg,
                                          severity="WARNING", source="slo",
                                          **ev)
        return out

    # ------------------------------------------------------------ internals

    @staticmethod
    def _merge(obj: Objective, rows: list[dict]):
        """Merge the objective's matching histogram rows bucket-wise.
        → (boundaries, per-bucket counts) or None when nothing matches.
        Rows whose boundaries disagree with the first match are skipped
        (prometheus_text accounts for that conflict in the exposition)."""
        boundaries = None
        buckets: list[float] | None = None
        for r in rows:
            if r.get("kind") != "histogram" or r.get("name") != obj.metric:
                continue
            tags = r.get("tags", {})
            if any(tags.get(k) != v for k, v in obj.tags.items()):
                continue
            b = r.get("buckets")
            if b is None:
                continue
            bounds = tuple(r.get("boundaries", ()))
            if boundaries is None:
                boundaries = bounds
                buckets = [0.0] * (len(bounds) + 1)
            if bounds != boundaries or len(b) != len(buckets):
                continue
            buckets = [a + x for a, x in zip(buckets, b)]
        if boundaries is None:
            return None
        return boundaries, buckets

    def _evaluate_one(self, obj: Objective, rows: list[dict],
                      now: float, pending: list | None = None) -> dict:
        base = {"name": obj.name, "metric": obj.metric,
                "quantile": obj.quantile, "threshold_s": obj.threshold_s,
                "window_s": obj.window_s}
        merged = self._merge(obj, rows)
        if merged is None:
            self._set_burn(obj.name, 0.0)
            self._violating[obj.name] = False
            return {**base, "status": "no_data", "samples": 0,
                    "burn_rate": 0.0, "violating": False}
        boundaries, cur = merged
        ring = self._snaps[obj.name]
        if (not ring and self._seed
                and obj.name not in self._seed_attempted):
            self._try_seed(obj, boundaries, now)
        ring.append((now, cur))
        # Keep the newest snapshot at least window_s old as the baseline;
        # drop anything older. A single-snapshot ring (first evaluation)
        # baselines at zero — i.e. lifetime totals.
        while len(ring) >= 2 and now - ring[1][0] >= obj.window_s:
            ring.popleft()
        baselined = len(ring) >= 2
        prev = ring[0][1] if baselined else [0.0] * len(cur)
        if len(prev) != len(cur):   # metric redefined across evaluations
            prev = [0.0] * len(cur)
        # Clamp per-bucket: a source retiring from the hub can shrink the
        # aggregate; a negative delta is a reset, not negative traffic.
        delta = [max(0.0, a - b) for a, b in zip(cur, prev)]
        total = sum(delta)
        if total <= 0:
            self._set_burn(obj.name, 0.0)
            self._violating[obj.name] = False
            return {**base, "status": "no_data", "samples": 0,
                    "burn_rate": 0.0, "violating": False}
        good = sum(n for bound, n in zip(boundaries, delta)
                   if bound <= obj.threshold_s)
        bad_fraction = 1.0 - good / total
        error_budget = max(1.0 - obj.quantile, 1e-9)
        burn = bad_fraction / error_budget
        violating = burn > 1.0
        status = {
            **base,
            "status": "violating" if violating else "ok",
            # An unbaselined evaluation (fresh monitor, e.g. a dashboard
            # restart or the CLI) scores LIFETIME totals — informative to
            # display, labeled as such below, but not alarm-worthy: a
            # morning incident must not re-fire slo.violation or set a
            # burn gauge hours later from a process that just started.
            # Alarms arm once a real prior snapshot exists.
            "baseline": "window" if baselined else "lifetime",
            "samples": int(total),
            "good_fraction": round(1.0 - bad_fraction, 6),
            "burn_rate": round(burn, 4),
            "quantile_est_s": round(
                self._quantile(boundaries, delta, obj.quantile), 6),
            "violating": violating,
        }
        if not baselined:
            return status
        self._set_burn(obj.name, burn)
        if violating and not self._violating[obj.name]:
            ev = {"slo": obj.name, "metric": obj.metric,
                  "burn_rate": status["burn_rate"],
                  "quantile": obj.quantile,
                  "quantile_est_s": status["quantile_est_s"],
                  "threshold_s": obj.threshold_s,
                  "window_s": obj.window_s, "samples": status["samples"]}
            self.events.append(ev)
            if pending is not None:
                # Queued for the caller to emit outside self._lock (the
                # event push is an RPC; see evaluate()).
                pending.append((
                    f"SLO {obj.name} violating: p{int(obj.quantile * 100)}"
                    f"≈{status['quantile_est_s']:g}s > {obj.threshold_s:g}s "
                    f"target (burn {status['burn_rate']:g})", ev))
        self._violating[obj.name] = violating
        return status

    def _try_seed(self, obj: Objective, boundaries, now: float) -> None:
        """Cold-start baseline from the series store: per matching
        histogram series, take the newest point at least window_s old
        (else its earliest point — a partial window, exactly what a
        continuously-running monitor would hold mid-warmup), sum the
        bucket vectors, and plant the result in the ring at its true
        age. One attempt per objective; any failure = no history =
        current (lifetime-first) behavior."""
        self._seed_attempted.add(obj.name)
        try:
            if self._history_fn is not None:
                series = self._history_fn(obj.metric, dict(obj.tags),
                                          obj.window_s * 2)
            else:
                import os

                from ray_tpu_torch import api as _api
                from ray_tpu_torch import state as _state

                # Same attach contract as emit_cluster_event: a seeding
                # read must never auto-START a cluster.
                if _api._client is None and not (
                        os.environ.get("RAY_TPU_TORCH_GCS_ADDRESS")
                        and os.environ.get("RAY_TPU_TORCH_RAYLET_ADDRESS")):
                    return
                series = _state.query_series(
                    obj.metric, tags=dict(obj.tags) or None,
                    window_s=obj.window_s * 2)
        except Exception as e:
            logger.debug("slo %s: history seed unavailable: %s",
                         obj.name, e)
            return
        wall = time.time()
        target = wall - obj.window_s
        n = len(boundaries) + 1
        chosen: list[tuple[float, list]] = []
        for s in series:
            if s.get("kind") != "histogram":
                continue
            if tuple(s.get("boundaries") or ()) != tuple(boundaries):
                continue
            pts = [(ts, v) for ts, v in (s.get("points") or ())
                   if isinstance(v, (list, tuple)) and len(v) == n]
            if not pts:
                continue
            if s.get("tombstoned"):
                # A dead source's series no longer grows, but its FINAL
                # counts live on in the hub's retired rows (part of the
                # current merged snapshot forever). Baseline at its
                # newest point so it cancels out of the window delta —
                # baselining it window_s ago would book the dead
                # source's tail as fresh traffic on every restart.
                chosen.append(pts[-1])
                continue
            best = None
            for ts, v in pts:
                if ts <= target or best is None:
                    best = (ts, v)
                if ts > target:
                    break
            chosen.append(best)
        if not chosen:
            return
        agg = [float(sum(vs)) for vs in zip(*(v for _ts, v in chosen))]
        age = wall - min(ts for ts, _v in chosen)
        self._snaps[obj.name].append((now - age, agg))
        logger.debug("slo %s: seeded %.1fs-old baseline from the series "
                     "store (%d series)", obj.name, age, len(chosen))

    def _set_burn(self, name: str, burn: float) -> None:
        if self._export:
            _BURN_RATE.set(burn, tags={"slo": name})

    @staticmethod
    def _quantile(boundaries, delta, q: float) -> float:
        """histogram_quantile-style estimate: linear interpolation inside
        the bucket holding rank q·total; the +Inf bucket reports the
        highest finite boundary (there is no upper edge to interpolate
        toward)."""
        total = sum(delta)
        rank = q * total
        cum = 0.0
        lower = 0.0
        for bound, n in zip(boundaries, delta):
            if cum + n >= rank and n > 0:
                frac = (rank - cum) / n
                return lower + (bound - lower) * frac
            cum += n
            lower = bound
        return float(boundaries[-1]) if boundaries else 0.0


__all__ = ["Objective", "SloMonitor", "default_objectives"]
