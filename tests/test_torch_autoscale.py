"""Decision-plane observability of the port: series store, shadow
autoscaler, SLO cold-start seeding, and their live query surfaces.

Mirrors ``tests/test_autoscale.py`` on the port's modules and cluster:
`TestSeriesStore`, `TestRendering`, `TestShadowPolicy`, `TestSloSeeding`
and `TestGcsSeriesSweep` case for case; `TestLiveDecisionPlane` reads
the controller's `get_autoscale` and `get_load` and
`state.query_series`, and then, as the JAX tests do, the port's
dashboard (``/api/series``, ``/api/autoscale``) and the CLI's
``render_serve_status``. Then ``tests/test_flight_recorder.py``'s
`TestSloMonitor` (its cluster cases on the port's cluster) and
`TestServeLoadSurface`, which reads `get_load`,
`slo.default_objectives` and the state API, and then the dashboard's
``/api/serve/load``, ``/api/slo``, ``/api/traces`` and ``/api/timeline``
and the CLI. Tolerance: exact, except where the JAX tests use
``pytest.approx`` (its default, 1e-6 relative).
"""

import asyncio
import json
import time
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch import profiling, serve, state
from ray_tpu_torch.obs_series import SeriesStore, resample, sparkline
from ray_tpu_torch.serve.autoscale import (AutoscalePolicy, ShadowAutoscaler,
                                     TTFT_SLO, window_stats)
from ray_tpu_torch.serve.api import _get_controller
from ray_tpu_torch.slo import Objective, SloMonitor, default_objectives


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    serve.shutdown()
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def dash(cluster):
    from ray_tpu_torch.dashboard import start_dashboard

    d = start_dashboard(port=0)
    yield d
    d.stop()


def _get_json(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read().decode())


# ---------------------------------------------------------- series store


class TestSeriesStore:
    def test_ring_bounds_and_coalescing(self):
        st = SeriesStore(max_points=5, resolution_s=0.5)
        t0 = 1000.0
        for i in range(20):
            st.record("m", float(i), {"a": "x"}, source="s1", ts=t0 + i)
        (s,) = st.query("m")
        assert len(s["points"]) == 5                 # ring, not growth
        assert s["points"][-1] == [t0 + 19, 19.0]
        # Within-resolution points coalesce (last write wins) instead of
        # consuming ring slots.
        st.record("m", 99.0, {"a": "x"}, source="s1", ts=t0 + 19.2)
        (s,) = st.query("m")
        assert len(s["points"]) == 5
        assert s["points"][-1][1] == 99.0

    def test_query_windowing_and_tag_filter(self):
        st = SeriesStore(max_points=64)
        t0 = 1000.0
        for i in range(10):
            st.record("m", float(i), {"a": "x", "b": "y"}, ts=t0 + i)
        (s,) = st.query("m", window_s=2.5, now=t0 + 9)
        assert [p[1] for p in s["points"]] == [7.0, 8.0, 9.0]
        assert st.query("m", tags={"a": "x"})        # subset match
        assert st.query("m", tags={"a": "z"}) == []
        assert st.query("other") == []

    def test_full_snapshot_push_tombstones_missing_series(self):
        """Sources push FULL snapshots: a series absent from its
        source's latest push (a removed replica's gauge) tombstones, and
        a later point revives it."""
        st = SeriesStore(max_points=8, tombstone_ttl_s=60.0)
        row = lambda n: {"name": n, "kind": "gauge", "value": 1.0,
                         "tags": {}}
        st.record_rows("w1", [row("g1"), row("g2")], ts=1000.0)
        st.record_rows("w1", [row("g2")], ts=1001.0)
        q = {r["name"]: r for r in st.query()}
        assert q["g1"]["tombstoned"] and not q["g2"]["tombstoned"]
        st.record_rows("w1", [row("g1"), row("g2")], ts=1002.0)
        assert not st.query("g1")[0]["tombstoned"]   # revived

    def test_tombstone_source_then_sweep_deletes_after_ttl(self):
        st = SeriesStore(max_points=8, tombstone_ttl_s=5.0)
        st.record("g", 1.0, {}, source="dead", ts=1000.0)
        assert st.tombstone_source("dead", now=1001.0) == 1
        assert st.query("g")[0]["tombstoned"]        # readable in the TTL
        assert st.sweep(now=1003.0) == 0             # not yet expired
        assert st.sweep(now=1007.0) == 1
        assert st.query("g") == []
        assert st.stats()["series"] == 0

    def test_histogram_rows_store_bucket_vectors(self):
        st = SeriesStore(max_points=8)
        st.record_rows("w1", [{
            "name": "lat_s", "kind": "histogram", "tags": {},
            "value": 3.0, "buckets": [2, 1, 0], "sum": 0.5,
            "boundaries": [0.1, 1.0]}], ts=1000.0)
        (s,) = st.query("lat_s")
        assert s["kind"] == "histogram"
        assert s["boundaries"] == [0.1, 1.0]
        assert s["points"][0][1] == [2.0, 1.0, 0.0]

    def test_memory_bounded_under_churn(self):
        """The acceptance bound: points <= max_series × max_points no
        matter how many sources/pushes churn through."""
        st = SeriesStore(max_points=4, max_series=10, tombstone_ttl_s=0.0)
        for src in range(50):
            for i in range(20):
                st.record(f"m{src % 15}", float(i), {"s": str(src)},
                          source=f"w{src}", ts=1000.0 + i)
        stats = st.stats()
        assert stats["series"] <= 10
        assert stats["points_max_per_series"] <= 4
        assert stats["points_total"] <= 40

    def test_eviction_prefers_tombstoned_then_stalest(self):
        st = SeriesStore(max_points=4, max_series=2, tombstone_ttl_s=1e9)
        st.record("a", 1.0, {}, source="s", ts=1000.0)
        st.record("b", 1.0, {}, source="s", ts=2000.0)
        st.tombstone_source("s", now=2000.0)
        st.record("b", 2.0, {}, source="s", ts=2001.0)   # revives b
        st.record("c", 1.0, {}, source="s", ts=2002.0)   # evicts: a (tomb)
        names = {r["name"] for r in st.query()}
        assert names == {"b", "c"}
        st.record("d", 1.0, {}, source="s", ts=2003.0)   # evicts stalest: b
        names = {r["name"] for r in st.query()}
        assert names == {"c", "d"}

    def test_validation(self):
        with pytest.raises(ValueError):
            SeriesStore(max_points=0)
        with pytest.raises(ValueError):
            SeriesStore(max_series=0)


class TestRendering:
    def test_sparkline(self):
        line = sparkline([0, 1, 2, 3, 8])
        assert len(line) == 5
        assert line[0] == "▁" and line[-1] == "█"
        assert sparkline([]) == ""
        assert sparkline([2, 2, 2]) == "▁▁▁"        # flat, no div-by-zero

    def test_resample_carry_forward_and_agg(self):
        mk = lambda pts: {"points": pts}
        a = mk([[1001.0, 1.0], [1005.0, 3.0]])
        b = mk([[1002.0, 10.0]])
        vals = resample([a, b], window_s=10, buckets=10, agg="sum",
                        now=1010.0)
        # a starts at t=1, b at t=2 (carry-forward after), a steps to 3
        assert vals[0] == 1.0
        assert vals[-1] == 13.0
        assert resample([a], window_s=10, buckets=10, agg="max",
                        now=1010.0)[-1] == 3.0
        assert resample([], window_s=10, buckets=5) == []


# ------------------------------------------------------ shadow autoscaler


def _series_fn(values: dict):
    """Synthetic store: values maps series name -> current scalar (None =
    absent); every query returns a single fresh point."""
    def fn(name, tags, window_s):
        v = values.get(name)
        if v is None:
            return []
        return [{"name": name, "tags": dict(tags), "source": "t",
                 "kind": "gauge", "points": [[time.time(), float(v)]]}]
    return fn


_POLICY = AutoscalePolicy(
    min_replicas=1, max_replicas=8, window_s=10.0, target_ongoing=4.0,
    target_ttft_p95_ms=500.0, burn_threshold=1.0,
    up_sustain_s=2.0, down_sustain_s=5.0,
    up_cooldown_s=3.0, down_cooldown_s=6.0)


class TestShadowPolicy:
    def test_scale_up_requires_sustain_then_fires(self):
        vals = {"serve_replica_ongoing": 0.0}
        a = ShadowAutoscaler(_POLICY, series_fn=_series_fn(vals),
                             emit_events=False)
        assert a.evaluate("d", 1, now=0.0)["rule"] == "hold"
        vals["serve_replica_ongoing"] = 40.0        # desired 10 → clamp 8
        r = a.evaluate("d", 1, now=0.5)
        assert r["rule"] == "scale_up_queue:sustain" and not r["changed"]
        assert r["recommended_replicas"] == 1       # unchanged while gated
        r = a.evaluate("d", 1, now=3.0)
        assert r["changed"] and r["rule"] == "scale_up_queue"
        assert r["recommended_replicas"] == 8
        assert r["desired_raw"] == 8
        assert a.recommended("d") == 8

    def test_scale_down_slow_and_cooldown_blocks_flapping(self):
        vals = {"serve_replica_ongoing": 40.0}
        a = ShadowAutoscaler(_POLICY, series_fn=_series_fn(vals),
                             emit_events=False)
        a.evaluate("d", 1, now=0.0)
        r = a.evaluate("d", 1, now=2.5)
        assert r["recommended_replicas"] == 8
        # Demand collapses: down waits out down_sustain_s...
        vals["serve_replica_ongoing"] = 2.0
        r = a.evaluate("d", 1, now=3.0)
        assert r["rule"] == "scale_down_idle:sustain"
        r = a.evaluate("d", 1, now=8.5)
        assert r["changed"] and r["recommended_replicas"] == 1
        # ...and a fresh up right after must re-sustain (timers cleared),
        # so an oscillating signal can't flap the recommendation.
        vals["serve_replica_ongoing"] = 40.0
        r = a.evaluate("d", 1, now=9.0)
        assert not r["changed"] and r["rule"].endswith(":sustain")

    def test_up_cooldown_spaces_consecutive_ups(self):
        vals = {"serve_replica_ongoing": 8.0}       # desired 2
        a = ShadowAutoscaler(_POLICY, series_fn=_series_fn(vals),
                             emit_events=False)
        a.evaluate("d", 1, now=0.0)
        r = a.evaluate("d", 1, now=2.5)
        assert r["changed"] and r["recommended_replicas"] == 2
        vals["serve_replica_ongoing"] = 16.0        # desired 4
        a.evaluate("d", 1, now=3.0)
        r = a.evaluate("d", 1, now=5.2)             # sustained, cooling
        assert not r["changed"] and r["rule"] == "scale_up_queue:cooldown"
        r = a.evaluate("d", 1, now=6.0)             # cooldown over
        assert r["changed"] and r["recommended_replicas"] == 4

    def test_burn_rate_rule_fires_without_queue_pressure(self):
        vals = {"serve_replica_ongoing": 1.0, "slo_burn_rate": 3.0}
        a = ShadowAutoscaler(_POLICY, series_fn=_series_fn(vals),
                             emit_events=False)
        a.evaluate("d", 2, now=0.0)
        r = a.evaluate("d", 2, now=2.5)
        assert r["changed"] and r["rule"] == "scale_up_burn"
        assert r["recommended_replicas"] == 3       # current + 1
        assert r["inputs"]["burn_rate_max"] == 3.0

    def test_ttft_rule_fires_on_latency_target(self):
        vals = {"serve_replica_ongoing": 1.0,
                "serve_replica_ttft_ewma_ms": 900.0}
        a = ShadowAutoscaler(_POLICY, series_fn=_series_fn(vals),
                             emit_events=False)
        a.evaluate("d", 2, now=0.0)
        r = a.evaluate("d", 2, now=2.5)
        assert r["changed"] and r["rule"] == "scale_up_ttft"
        assert r["recommended_replicas"] == 3

    def test_no_data_holds_previous_recommendation(self):
        vals = {"serve_replica_ongoing": 40.0}
        a = ShadowAutoscaler(_POLICY, series_fn=_series_fn(vals),
                             emit_events=False)
        a.evaluate("d", 1, now=0.0)
        a.evaluate("d", 1, now=2.5)
        assert a.recommended("d") == 8
        vals["serve_replica_ongoing"] = None        # store outage
        r = a.evaluate("d", 1, now=3.0)
        assert r["rule"] == "no_data" and not r["changed"]
        assert r["recommended_replicas"] == 8       # held, not fabricated

    def test_decision_record_completeness(self):
        """Every record must explain itself post-hoc: inputs, window
        aggregates, rule, hysteresis state, policy, mode, timestamps."""
        vals = {"serve_replica_ongoing": 40.0, "slo_burn_rate": 0.2,
                "serve_replica_queue_depth": 30.0,
                "serve_replica_ttft_ewma_ms": 10.0}
        a = ShadowAutoscaler(_POLICY, series_fn=_series_fn(vals),
                             emit_events=False)
        a.evaluate("d", 1, now=0.0)
        r = a.evaluate("d", 1, now=2.5)
        for key in ("deployment", "ts", "mode", "rule", "changed",
                    "current_replicas", "prev_recommended",
                    "recommended_replicas", "desired_raw", "inputs",
                    "policy", "hysteresis"):
            assert key in r, key
        for key in ("window_s", "samples", "ongoing_mean",
                    "queue_depth_mean", "ttft_ewma_ms_max",
                    "ttft_ewma_ms_latest", "burn_rate_max",
                    "burn_rate_latest"):
            assert key in r["inputs"], key
        for key in ("over_for_s", "under_for_s", "since_last_up_s",
                    "since_last_down_s"):
            assert key in r["hysteresis"], key
        assert r["mode"] == "shadow"
        assert json.loads(json.dumps(r)) == r       # wire-serializable
        # ...and the ring retains it for post-hoc reads.
        assert a.decisions("d")[-1] == r

    def test_recommendation_gauge_set(self):
        vals = {"serve_replica_ongoing": 4.0}
        a = ShadowAutoscaler(_POLICY, series_fn=_series_fn(vals),
                             emit_events=False)
        a.evaluate("gauge_dep", 3, now=0.0)
        rows = [r for r in profiling.metrics_snapshot()
                if r["name"] == "serve_autoscale_recommended_replicas"
                and r["tags"].get("deployment") == "gauge_dep"]
        assert rows and rows[0]["value"] == 3.0
        a.forget("gauge_dep")
        rows = [r for r in profiling.metrics_snapshot()
                if r["name"] == "serve_autoscale_recommended_replicas"
                and r["tags"].get("deployment") == "gauge_dep"]
        assert not rows                              # series retired

    def test_policy_validation(self):
        with pytest.raises(ValueError):
            AutoscalePolicy(min_replicas=-1)
        with pytest.raises(ValueError):
            AutoscalePolicy(min_replicas=4, max_replicas=2)
        with pytest.raises(ValueError):
            AutoscalePolicy(target_ongoing=0)
        with pytest.raises(ValueError):
            ShadowAutoscaler(mode="yolo")

    def test_stale_burn_tail_does_not_ratchet_recommendation_up(self):
        """The burn/ttft rules gate on the LATEST in-window point: after
        a ramp-down the burn gauge's stale tail stays in the window for
        window_s, and a max-gate would override scale_down and ratchet
        the recommendation up on load that no longer exists."""
        def fn(name, tags, w):
            if name == "serve_replica_ongoing":
                return [{"name": name, "tags": dict(tags), "kind": "gauge",
                         "points": [[time.time(), 2.0]]}]
            if name == "slo_burn_rate":
                # Window max 20 (the tail), latest 0 (load is gone).
                return [{"name": name, "tags": dict(tags), "kind": "gauge",
                         "points": [[time.time() - 5, 20.0],
                                    [time.time(), 0.0]]}]
            return []
        a = ShadowAutoscaler(_POLICY, series_fn=fn, emit_events=False)
        a.evaluate("d", 8, now=0.0)
        r = a.evaluate("d", 8, now=6.0)
        assert r["inputs"]["burn_rate_max"] == 20.0
        assert r["inputs"]["burn_rate_latest"] == 0.0
        assert r["changed"] and r["rule"] == "scale_down_idle"
        assert r["recommended_replicas"] == 1

    def test_tombstoned_series_are_phantom_load_not_demand(self):
        """Removed replicas' trailing history must not bounce the
        recommendation back up right after a scale-down."""
        def fn(name, tags, w):
            if name != "serve_replica_ongoing":
                return []
            mk = lambda v, dead: {"name": name, "tags": dict(tags),
                                  "kind": "gauge", "tombstoned": dead,
                                  "points": [[time.time(), v]]}
            return [mk(2.0, False), mk(30.0, True), mk(30.0, True)]
        a = ShadowAutoscaler(_POLICY, series_fn=fn, emit_events=False)
        a.evaluate("d", 2, now=0.0)
        r = a.evaluate("d", 2, now=2.5)
        assert r["inputs"]["ongoing_mean"] == 2.0   # live series only
        assert r["rule"].startswith("scale_down")

    def test_enact_mode_reanchors_on_external_replica_change(self):
        """Enact compares against the ACTUAL replica count: an external
        num_replicas change (cold-start wake, manual scale) must not
        leave the state machine holding a stale recommendation that
        suppresses every future enactment."""
        vals = {"serve_replica_ongoing": 2.0}    # desired 1
        a = ShadowAutoscaler(_POLICY, mode="enact",
                             series_fn=_series_fn(vals),
                             emit_events=False)
        a.evaluate("d", 2, now=0.0)
        r = a.evaluate("d", 2, now=6.0)
        assert r["changed"] and r["recommended_replicas"] == 1
        # The deployment is still at 2 (external wake / manual scale):
        # the next evaluation must anchor on 2 (reality), not on the 1
        # it last recommended — and re-run the down hysteresis.
        r = a.evaluate("d", 2, now=7.0)
        assert r["prev_recommended"] == 2
        assert r["rule"] == "scale_down_idle:sustain"

    def test_window_stats_sums_means_across_series(self):
        s = lambda vals: {"points": [[1000.0 + i, v]
                                     for i, v in enumerate(vals)]}
        out = window_stats([s([2.0, 4.0]), s([10.0]), {"points": []}])
        assert out["mean_sum"] == 13.0              # 3 + 10
        assert out["latest_sum"] == 14.0            # 4 + 10
        assert out["max"] == 10.0
        assert out["samples"] == 3 and out["series"] == 2


# --------------------------------------------------- SLO restart seeding


class TestSloSeeding:
    BOUNDS = (0.1, 1.0, 10.0)

    def _rows(self, buckets):
        return [{"name": "seed_lat_s", "kind": "histogram", "tags": {},
                 "buckets": list(buckets),
                 "boundaries": list(self.BOUNDS), "sum": 1.0,
                 "value": float(sum(buckets))}]

    def _obj(self):
        return Objective("seeded", "seed_lat_s", 0.95, 0.1, window_s=30.0)

    def test_seeded_monitor_windows_and_alarms_on_first_evaluation(self):
        """A restarted monitor seeds its baseline from the series store:
        the first evaluation is already `baseline: window` and re-arms —
        the cold-start gap that previously needed a second snapshot."""
        hist = [{"name": "seed_lat_s", "kind": "histogram", "tags": {},
                 "source": "w1", "boundaries": list(self.BOUNDS),
                 "points": [[time.time() - 40, [10.0, 0.0, 0.0, 0.0]],
                            [time.time() - 5, [10.0, 5.0, 0.0, 0.0]]]}]
        m = SloMonitor([self._obj()],
                       rows_fn=lambda: self._rows([10, 20, 0, 0]),
                       export=False, history_fn=lambda n, t, w: hist)
        st = m.evaluate()[0]
        assert st["baseline"] == "window"
        assert st["samples"] == 20          # delta vs the 40s-old point
        assert st["violating"]
        assert m.events and m.events[0]["slo"] == "seeded"

    def test_no_history_falls_back_to_lifetime(self):
        m = SloMonitor([self._obj()],
                       rows_fn=lambda: self._rows([10, 20, 0, 0]),
                       export=False, history_fn=lambda n, t, w: [])
        st = m.evaluate()[0]
        assert st["baseline"] == "lifetime"
        assert not m.events                 # lifetime never alarms

    def test_seed_skips_mismatched_boundaries_and_bad_points(self):
        hist = [{"name": "seed_lat_s", "kind": "histogram", "tags": {},
                 "source": "w1", "boundaries": [0.5, 5.0],
                 "points": [[time.time() - 40, [1.0, 0.0, 0.0]]]},
                {"name": "seed_lat_s", "kind": "gauge", "tags": {},
                 "source": "w2", "points": [[time.time() - 40, 3.0]]}]
        m = SloMonitor([self._obj()],
                       rows_fn=lambda: self._rows([10, 20, 0, 0]),
                       export=False, history_fn=lambda n, t, w: hist)
        assert m.evaluate()[0]["baseline"] == "lifetime"

    def test_seed_baselines_tombstoned_sources_at_final_counts(self):
        """A dead source's lifetime totals live on in the hub's retired
        rows; seeding its series window_s ago would book its tail as
        fresh traffic — it must baseline at its FINAL point instead, so
        it cancels out of the first window delta."""
        now = time.time()
        hist = [
            # Live source: 40s ago all-good, grew 20 bad since.
            {"name": "seed_lat_s", "kind": "histogram", "tags": {},
             "source": "w1", "boundaries": list(self.BOUNDS),
             "tombstoned": False,
             "points": [[now - 40, [10.0, 0.0, 0.0, 0.0]]]},
            # Dead source: final counts 30 bad, frozen in retired rows.
            {"name": "seed_lat_s", "kind": "histogram", "tags": {},
             "source": "dead", "boundaries": list(self.BOUNDS),
             "tombstoned": True,
             "points": [[now - 40, [0.0, 10.0, 0.0, 0.0]],
                        [now - 35, [0.0, 30.0, 0.0, 0.0]]]}]
        # Current hub view = live source grown + dead source retired.
        cur = self._rows([10, 20 + 30, 0, 0])
        m = SloMonitor([self._obj()], rows_fn=lambda: cur,
                       export=False, history_fn=lambda n, t, w: hist)
        st = m.evaluate()[0]
        assert st["baseline"] == "window"
        # Only the live source's 20 new bad count — the dead source's
        # 30 canceled against its final-point baseline.
        assert st["samples"] == 20, st

    def test_seed_disabled_keeps_legacy_behavior(self):
        hist = [{"name": "seed_lat_s", "kind": "histogram", "tags": {},
                 "source": "w1", "boundaries": list(self.BOUNDS),
                 "points": [[time.time() - 40, [10.0, 0.0, 0.0, 0.0]]]}]
        m = SloMonitor([self._obj()],
                       rows_fn=lambda: self._rows([10, 20, 0, 0]),
                       export=False, seed=False,
                       history_fn=lambda n, t, w: hist)
        assert m.evaluate()[0]["baseline"] == "lifetime"


# ------------------------------------------ GCS sweep → series tombstone


class TestGcsSeriesSweep:
    def _gcs(self, **cfg_kw):
        from ray_tpu_torch.core.config import Config
        from ray_tpu_torch.core.gcs import GcsServer

        return GcsServer(Config(**cfg_kw))

    def test_metrics_push_lands_in_series_store(self):
        gcs = self._gcs()
        rows = [{"name": "g", "kind": "gauge", "value": 7.0,
                 "tags": {"replica": "r1"}}]
        asyncio.run(gcs._metrics_push(None, {"source": "w1", "rows": rows}))
        out = asyncio.run(gcs._series_query(None, {"name": "g"}))
        assert out and out[0]["points"][0][1] == 7.0
        assert out[0]["source"] == "w1"
        assert out[0]["tags"] == {"replica": "r1"}

    def test_stale_source_sweep_tombstones_then_deletes_series(self):
        """The stale-source TTL sweep must clear series-store keys
        too: expired source → series tombstoned (still readable) → gone
        after the series TTL — a churny bench can't grow GCS memory."""
        gcs = self._gcs(obs_series_tombstone_ttl_s=0.05)
        gcs.METRICS_SOURCE_TTL_S = 0.05
        rows = [{"name": "g", "kind": "gauge", "value": 1.0, "tags": {}}]
        asyncio.run(gcs._metrics_push(None, {"source": "w1", "rows": rows}))
        time.sleep(0.1)
        out = asyncio.run(gcs._series_query(None, {"name": "g"}))
        assert "w1" not in gcs.metrics_by_source    # source expired
        assert out and out[0]["tombstoned"]         # readable in the TTL
        time.sleep(0.1)
        out = asyncio.run(gcs._series_query(None, {"name": "g"}))
        assert out == []                            # swept
        assert gcs.series.stats()["series"] == 0

    def test_churny_sources_stay_bounded(self):
        gcs = self._gcs(obs_series_max_series=16,
                        obs_series_tombstone_ttl_s=0.0)
        gcs.METRICS_SOURCE_TTL_S = 0.0
        for i in range(100):
            rows = [{"name": f"g{i}", "kind": "gauge", "value": 1.0,
                     "tags": {}}]
            asyncio.run(gcs._metrics_push(
                None, {"source": f"w{i}", "rows": rows}))
            asyncio.run(gcs._metrics_get(None, {}))
        assert gcs.series.stats()["series"] <= 16


# --------------------------------------------------- live query surfaces


class TestLiveDecisionPlane:
    @pytest.fixture(scope="class")
    def loaded_serve(self, cluster):
        """One deployment whose load_snapshot reports sustained queue
        pressure (ongoing 12 ≫ target 4): drives the full chain
        controller-probe → history gauges → worker flush → GCS series
        store → shadow autoscaler → query surfaces."""

        @serve.deployment(name="auto_lb", num_replicas=1)
        class Loady:
            def __call__(self, req):
                return {"ok": True}

            def load_snapshot(self):
                return {"queue_depth": 12, "active_slots": 0,
                        "ttft_ewma_ms": 37.5, "pool_pages_free": 5,
                        "pool_pages_total": 8,
                        "prefix_cache_hit_rate": 0.5}

        handle = serve.run(Loady.bind())
        assert ray_tpu_torch.get(handle.remote({}), timeout=60) == {"ok": True}
        yield handle

    def _wait(self, fn, what, timeout=60):
        deadline = time.monotonic() + timeout
        last = None
        while time.monotonic() < deadline:
            last = fn()
            if last:
                return last
            time.sleep(0.5)
        pytest.fail(f"{what} never appeared (last={last!r})")

    def test_api_series_carries_replica_history(self, loaded_serve, dash):
        def probe():
            rows = state.query_series("serve_replica_queue_depth",
                                      tags={"deployment": "auto_lb"},
                                      window_s=120)
            return [s for s in rows if s["points"]]
        rows = self._wait(probe, "queue-depth series")
        (s,) = rows
        assert s["tags"]["deployment"] == "auto_lb"
        assert s["points"][-1][1] == 12.0
        assert s["kind"] == "gauge"
        # Multiple reconciles accumulate HISTORY, not a snapshot.
        self._wait(lambda: len(probe()[0]["points"]) >= 2,
                   "second history point")
        # The bounded-retention contract holds live.
        from ray_tpu_torch.core.config import runtime_config

        assert (len(probe()[0]["points"])
                <= runtime_config().obs_series_points)
        # The same series through the dashboard.
        rows = [s for s in _get_json(
            dash.url + "/api/series?name=serve_replica_queue_depth"
            '&window_s=120&tags={"deployment":"auto_lb"}')["series"]
            if s["points"]]
        (s,) = rows
        assert s["tags"]["deployment"] == "auto_lb"
        assert s["points"][-1][1] == 12.0 and s["kind"] == "gauge"
        assert 2 <= len(s["points"]) <= runtime_config().obs_series_points

    def test_api_autoscale_serves_full_decision_records(self, loaded_serve,
                                                        dash):
        def probe():
            doc = ray_tpu_torch.get(_get_controller().get_autoscale.remote(),
                                    timeout=30)
            dep = doc.get("deployments", {}).get("auto_lb") or {}
            decs = dep.get("decisions") or []
            return [d for d in decs if d.get("changed")] and doc
        doc = self._wait(probe, "autoscale recommendation change")
        assert doc["mode"] == "shadow"
        dep = doc["deployments"]["auto_lb"]
        # ongoing 12 / target 4 → 3 replicas recommended, never enacted.
        assert dep["recommended_replicas"] == 3
        assert dep["current_replicas"] == 1
        changed = [d for d in dep["decisions"] if d["changed"]][-1]
        assert changed["rule"] == "scale_up_queue"
        for key in ("inputs", "hysteresis", "policy", "ts", "mode"):
            assert key in changed, key
        assert changed["inputs"]["samples"] > 0
        # The same decision plane through the dashboard.
        doc = _get_json(dash.url + "/api/autoscale")
        assert doc["mode"] == "shadow"
        dep = doc["deployments"]["auto_lb"]
        assert (dep["recommended_replicas"], dep["current_replicas"]) == (3, 1)
        changed = [d for d in dep["decisions"] if d["changed"]][-1]
        assert changed["rule"] == "scale_up_queue"
        for key in ("inputs", "hysteresis", "policy", "ts", "mode"):
            assert key in changed, key

    def test_recommendation_never_enacted_in_shadow(self, loaded_serve):
        # Shadow is observe-only: the deployment must still be at 1.
        st = serve.status()["auto_lb"]
        assert st["num_replicas"] == 1
        assert st["live_replicas"] == 1

    def test_serve_status_carries_autoscale_summary(self, loaded_serve):
        def probe():
            a = serve.status()["auto_lb"].get("autoscale")
            return a if a and a.get("recommended_replicas") == 3 else None
        a = self._wait(probe, "serve.status autoscale summary")
        assert a["mode"] == "shadow"
        assert "rule" in a and "ts" in a

    def test_autoscale_recommend_event_emitted(self, loaded_serve):
        def probe():
            evs = state.list_cluster_events(limit=1000, tail=True)
            return [e for e in evs if e["type"] == "autoscale.recommend"
                    and e.get("deployment") == "auto_lb"]
        evs = self._wait(probe, "autoscale.recommend cluster event")
        ev = evs[-1]
        assert ev["recommended_replicas"] == 3
        assert ev["rule"] == "scale_up_queue"
        assert "inputs" in ev and "hysteresis" in ev

    def test_cli_history_renders_sparklines(self, loaded_serve):
        """The history the CLI renders: the queue-depth series resampled
        and drawn as a sparkline, and the autoscale summary it prints
        beside it, from serve.status(); then the CLI's own rendering."""
        rows = self._wait(lambda: [
            s for s in state.query_series(
                "serve_replica_queue_depth",
                tags={"deployment": "auto_lb"}, window_s=120)
            if s["points"]], "series for the history")
        line = sparkline(resample(rows, window_s=120.0, buckets=24))
        assert 1 <= len(line) <= 24
        assert set(line) <= set("▁▂▃▄▅▆▇█")
        a = self._wait(lambda: serve.status()["auto_lb"].get("autoscale"),
                       "autoscale summary")
        assert a["mode"] == "shadow" and "recommended_replicas" in a
        from ray_tpu_torch.scripts.cli import render_serve_status

        def rendered():
            text = render_serve_status(history=True, history_window_s=120.0)
            return text if "recommended=" in text else None
        text = self._wait(rendered, "the CLI's autoscale line")
        assert "auto_lb" in text
        assert "history (120s):" in text
        assert "queue_depth" in text
        assert any(c in text for c in "▁▂▃▄▅▆▇█")
        assert "autoscale[shadow]: recommended=" in text

    def test_state_query_series_driver_roundtrip(self, loaded_serve):
        """Driver-set gauges flow through the driver flush loop into the
        store — the series surface is cluster-wide, not serve-only."""
        g = profiling.Gauge("autoscale_test_roundtrip",
                            tag_keys=("k",))
        g.set(41.0, tags={"k": "v"})
        # One flush tick: poll for the first value, then move it.
        self._wait(lambda: state.query_series(
            "autoscale_test_roundtrip", tags={"k": "v"}, window_s=60),
            "first driver gauge point")
        g.set(42.0, tags={"k": "v"})

        def probe():
            rows = state.query_series("autoscale_test_roundtrip",
                                      tags={"k": "v"}, window_s=60)
            return [s for s in rows
                    if s["points"] and s["points"][-1][1] == 42.0]
        assert self._wait(probe, "driver gauge series")


# ---------------------------------------- flight recorder: SLO and load


def _hist_rows(name: str, buckets, boundaries=(0.5, 2.0)):
    return [{"name": name, "kind": "histogram", "tags": {"route": "/x"},
             "value": float(sum(buckets)), "sum": 1.0,
             "buckets": list(buckets), "boundaries": list(boundaries)}]


class TestSloMonitor:
    def test_burn_rate_math_and_violation_event(self, cluster):
        """10% of requests over a p95 threshold burns budget at 2x."""
        obj = Objective("flight_ttft_p95", "flight_slo_s", 0.95, 2.0,
                        window_s=60.0)
        mon = SloMonitor([obj], rows_fn=lambda: [])
        _, latest = state.list_cluster_events(return_latest_seq=True)
        # First evaluation = lifetime view: informative, never an alarm.
        st0, = mon.evaluate(rows=_hist_rows("flight_slo_s", (10, 0, 0)))
        assert st0["baseline"] == "lifetime" and not mon.events
        # Windowed: delta (85, 5, 10) → 10% bad of a 5% budget = 2x burn.
        st, = mon.evaluate(rows=_hist_rows("flight_slo_s", (95, 5, 10)))
        assert st["status"] == "violating" and st["violating"]
        assert st["baseline"] == "window"
        assert st["samples"] == 100
        assert st["burn_rate"] == pytest.approx(0.10 / 0.05)
        assert mon.events and mon.events[0]["slo"] == "flight_ttft_p95"
        events = state.list_cluster_events(after_seq=latest)
        viol = [e for e in events if e["type"] == "slo.violation"]
        assert viol and viol[0]["slo"] == "flight_ttft_p95"
        assert viol[0]["severity"] == "WARNING"
        # burn-rate gauge exported for scrapers
        rows = [r for r in profiling.metrics_snapshot()
                if r["name"] == "slo_burn_rate"
                and r["tags"].get("slo") == "flight_ttft_p95"]
        assert rows and rows[0]["value"] == pytest.approx(2.0)
        # Same cumulative snapshot again: the in-window baseline is still
        # the first snapshot, so the delta (and verdict) are unchanged —
        # and the ok→violating edge does not re-fire the event.
        st2, = mon.evaluate(rows=_hist_rows("flight_slo_s", (95, 5, 10)))
        assert st2["status"] == "violating"
        assert len(mon.events) == 1

    def test_windowed_delta_not_lifetime(self):
        """A violating past must not condemn a healthy present: the
        second evaluation scores only the delta since the first."""
        obj = Objective("flight_win", "flight_win_s", 0.95, 2.0,
                        window_s=60.0)
        mon = SloMonitor([obj], rows_fn=lambda: [])
        st, = mon.evaluate(rows=_hist_rows("flight_win_s", (0, 0, 50)))
        assert st["violating"]                  # lifetime READ still honest
        assert st["baseline"] == "lifetime"     # ...but labeled, no alarm
        assert not mon.events
        st, = mon.evaluate(rows=_hist_rows("flight_win_s", (1000, 0, 50)))
        assert not st["violating"]      # delta = 1000 good, 0 bad
        assert st["baseline"] == "window"
        assert st["samples"] == 1000

    def test_threshold_inside_bucket_counts_bad(self):
        """Conservative bucket math: a threshold strictly inside a bucket
        must not credit that bucket as good."""
        obj = Objective("flight_cons", "flight_cons_s", 0.5, 1.5,
                        window_s=60.0)
        mon = SloMonitor([obj], rows_fn=lambda: [])
        # boundaries (0.5, 2.0): threshold 1.5 lands inside (0.5, 2.0].
        st, = mon.evaluate(rows=_hist_rows("flight_cons_s", (50, 50, 0)))
        assert st["good_fraction"] == pytest.approx(0.5)

    def test_passive_monitor_reads_without_alarming(self, cluster):
        """export=False (the CLI's one-shot read): full evaluation, but
        no slo.violation cluster event and no slo_burn_rate gauge — a
        read-only command must not file alarms off lifetime totals."""
        obj = Objective("flight_passive", "flight_passive_s", 0.95, 2.0,
                        window_s=60.0)
        mon = SloMonitor([obj], rows_fn=lambda: [], export=False)
        _, latest = state.list_cluster_events(return_latest_seq=True)
        mon.evaluate(rows=_hist_rows("flight_passive_s", (10, 0, 0)))
        st, = mon.evaluate(rows=_hist_rows("flight_passive_s", (10, 0, 50)))
        assert st["violating"]                    # the READ still works
        assert mon.events                         # local mirror kept
        assert not [e for e in state.list_cluster_events(after_seq=latest)
                    if e["type"] == "slo.violation"
                    and e.get("slo") == "flight_passive"]
        assert not [r for r in profiling.metrics_snapshot()
                    if r["name"] == "slo_burn_rate"
                    and r["tags"].get("slo") == "flight_passive"]

    def test_tag_filter_and_no_data(self):
        obj = Objective("flight_tagged", "flight_tag_s", 0.95, 2.0,
                        tags={"route": "/other"})
        mon = SloMonitor([obj], rows_fn=lambda: [])
        st, = mon.evaluate(rows=_hist_rows("flight_tag_s", (10, 0, 0)))
        assert st["status"] == "no_data" and not st["violating"]

    def test_quantile_estimate_interpolates(self):
        obj = Objective("flight_q", "flight_q_s", 0.5, 10.0, window_s=60.0)
        mon = SloMonitor([obj], rows_fn=lambda: [])
        # All 100 obs in (0.5, 2.0]: p50 interpolates to the bucket middle.
        st, = mon.evaluate(rows=_hist_rows("flight_q_s", (0, 100, 0)))
        assert 0.5 < st["quantile_est_s"] < 2.0


class TestServeLoadSurface:
    @pytest.fixture(scope="class")
    def loaded_serve(self, cluster):
        """A deployment whose callable exposes load_snapshot(): the
        replica→controller propagation path the dashboard serves."""

        @serve.deployment(name="flight_lb", num_replicas=2)
        class Loady:
            def __call__(self, req):
                return {"ok": True}

            def load_snapshot(self):
                return {"queue_depth": 1, "active_slots": 2,
                        "pool_pages_free": 7, "pool_pages_total": 8}

        handle = serve.run(Loady.bind())
        assert ray_tpu_torch.get(handle.remote({}), timeout=60) == {"ok": True}
        yield handle

    def _wait_load(self, _handle):
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            deps = ray_tpu_torch.get(_get_controller().get_load.remote(),
                                     timeout=30)
            reps = deps.get("flight_lb", {}).get("replicas", [])
            if reps and all(r.get("load") for r in reps):
                return deps
            time.sleep(0.5)
        pytest.fail(f"replica load never reached /api/serve/load: {deps}")

    def test_api_serve_load_propagates_engine_load(self, loaded_serve,
                                                   dash):
        deps = self._wait_load(loaded_serve)
        for deps in (deps, _get_json(dash.url + "/api/serve/load")[
                "deployments"]):
            info = deps["flight_lb"]
            assert info["num_replicas"] == 2
            assert len(info["replicas"]) == 2
            for rep in info["replicas"]:
                assert rep["load"]["queue_depth"] == 1
                assert rep["load"]["pool_pages_free"] == 7
                assert "inflight" in rep and "processed" in rep

    def test_serve_status_carries_replica_load(self, loaded_serve):
        self._wait_load(loaded_serve)
        st = serve.status()["flight_lb"]
        assert len(st["replica_load"]) == 2
        for stats in st["replica_load"].values():
            assert stats["load"]["active_slots"] == 2

    def test_cli_status_serve_renders_load_and_slo(self, loaded_serve):
        """What the CLI renders: serve.status()'s replica counts and each
        replica's load fields, then the CLI's own rendering of them."""
        self._wait_load(loaded_serve)
        st = serve.status()["flight_lb"]
        assert (st["live_replicas"], st["num_replicas"]) == (2, 2)
        for stats in st["replica_load"].values():
            assert stats["load"]["queue_depth"] == 1
            assert stats["load"]["pool_pages_free"] == 7
        from ray_tpu_torch.scripts.cli import render_serve_status

        text = render_serve_status()
        assert "flight_lb" in text
        assert "2/2 replicas" in text
        assert "queue_depth=1" in text
        assert "pool_pages_free=7" in text
        assert "slo:" in text    # SLO table renders even with no traffic

    def test_api_slo_serves_objectives(self, loaded_serve, dash):
        for objs in (SloMonitor(default_objectives(), export=False).evaluate(),
                     _get_json(dash.url + "/api/slo")["objectives"]):
            names = {o["name"] for o in objs}
            assert {"llm_ttft_p95", "http_request_p95"} <= names
            for o in objs:
                assert o["status"] in ("ok", "violating", "no_data")
                assert "burn_rate" in o

    def test_traces_and_timeline_still_serve(self, loaded_serve, dash):
        """Smoke: the trace and timeline surfaces still serve, through
        the state API and the dashboard."""
        assert isinstance(state.list_traces(), list)
        assert isinstance(state.timeline(), list)
        assert isinstance(_get_json(dash.url + "/api/traces"), list)
        assert isinstance(_get_json(dash.url + "/api/timeline"), list)
