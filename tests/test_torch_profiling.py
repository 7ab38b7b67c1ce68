"""PyTorch port vs the JAX package: the profiling ring and the metrics
registry (``ray_tpu_torch/profiling.py``, ``ray_tpu_torch/metrics.py``
against ``ray_tpu/profiling.py``, ``ray_tpu/metrics.py``).

The same scripted sequence on both registries gives equal
`metrics_snapshot` rows (filtered to this file's metric names) and a
byte-equal `prometheus_text`; the event ring evicts and counts the same
drops past ``MAX_BUFFER``; `chrome_trace` renders the same events to the
same JSON. Host code only: exact equality throughout.
"""

import collections

import pytest

from ray_tpu import metrics as jmetrics
from ray_tpu import profiling as jprof
from ray_tpu_torch import metrics as tmetrics
from ray_tpu_torch import profiling as tprof

PACKAGES = [(jprof, jmetrics), (tprof, tmetrics)]


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
    """Each package's ring, drop count and merge-conflict tally start
    empty here (other tests of this process may have used them)."""
    for prof, _m in PACKAGES:
        monkeypatch.setattr(prof, "_events", collections.deque())
        monkeypatch.setattr(prof, "_dropped_total", 0)
        monkeypatch.setattr(prof, "_merge_conflicts_total", {})


def _script(prof, metrics, prefix):
    """Counter with default and call-site tags, a rejected negative inc,
    a gauge, histograms at and between their boundaries, a removed series,
    label values that need escaping, and a histogram name flushed with
    two boundary sets (a merge conflict)."""
    c = metrics.Counter(f"{prefix}_requests_total", description="reqs",
                        tag_keys=("route",), default_tags={"app": "demo"})
    c.inc(tags={"route": "/gen"})
    c.inc(2.5, tags={"route": "/gen"})
    c.inc(1.0, tags={"route": "/chat", "app": "other"})
    c.inc(3.0, tags={"route": 'say "hi"\\\n'})
    with pytest.raises(ValueError, match="non-negative"):
        c.inc(-1.0, tags={"route": "/gen"})
    g = metrics.Gauge(f"{prefix}_depth", description="", tag_keys=("q",))
    g.set(3, tags={"q": "a"})
    g.set(7.25, tags={"q": "a"})
    g.set(1, tags={"q": "b"})
    assert g.remove(tags={"q": "b"}) and not g.remove(tags={"q": "b"})
    h = metrics.Histogram(f"{prefix}_latency_s", description="lat",
                          boundaries=(0.01, 0.1, 1.0), tag_keys=("impl",))
    for v in (0.01, 0.005, 0.1, 0.5, 1.0, 7.0, 0.0999):
        h.observe(v, tags={"impl": "paged"})
    h.observe(0.2, tags={"impl": "gone"})
    assert h.remove(tags={"impl": "gone"})
    names = {c.name, g.name, h.name}
    rows = [r for r in prof.metrics_snapshot() if r["name"] in names]
    return rows, dict(next(r for r in rows if r["kind"] == "histogram"))


def test_registry_rows_and_exposition_equal():
    (jrows, jc), (trows, tc) = (_script(p, m, "t9prof") for p, m in PACKAGES)
    key = lambda r: (r["name"], sorted(r["tags"].items()))
    assert sorted(trows, key=key) == sorted(jrows, key=key)
    jtext, ttext = jprof.prometheus_text(jrows), tprof.prometheus_text(trows)
    assert ttext == jtext
    assert 'route="say \\"hi\\"\\\\\\n"' in ttext
    assert 't9prof_latency_s_bucket{impl="paged",le="+Inf"} 7' in ttext
    # A conflicting histogram row (other boundaries) is dropped and
    # counted the same way.
    for c in (jc, tc):
        c["boundaries"] = [1.0]
        c["buckets"] = [1, 0]
    jtext = jprof.prometheus_text(jrows + [jc])
    assert tprof.prometheus_text(trows + [tc]) == jtext
    assert 'metrics_merge_conflicts_total{metric="t9prof_latency_s"} 1' in (
        jtext)


def test_metrics_module_reexports_the_registry():
    assert (tmetrics.Counter, tmetrics.Gauge, tmetrics.Histogram) == (
        tprof.Counter, tprof.Gauge, tprof.Histogram)
    assert tmetrics.__all__ == jmetrics.__all__
    assert tprof.LATENCY_BUCKETS_S == jprof.LATENCY_BUCKETS_S


def _dropped(prof):
    return {tuple(r["tags"].items()): r["value"]
            for r in prof.metrics_snapshot()
            if r["name"] == "profile_events_dropped_total"}


@pytest.mark.parametrize("n", [3, 5, 9])
def test_ring_evicts_oldest_and_counts_drops(monkeypatch, n):
    outs = []
    for prof, _m in PACKAGES:
        monkeypatch.setattr(prof, "MAX_BUFFER", 5)
        before = sum(_dropped(prof).values())
        for i in range(n):
            prof.record_event(f"e{i}", "cat", 100.0 + i, 0.5, pid="p",
                              tid="t", args={"i": i} if i % 2 else None)
        with prof.span("last", cat="custom"):
            pass
        peek = prof.peek_events()
        ev = prof.drain_events()
        assert peek == ev and prof.peek_events() == []
        last = ev.pop()
        assert last["name"] == "last" and last["ph"] == "X"
        outs.append((ev, prof.events_dropped_total(),
                     sum(_dropped(prof).values()) - before))
    assert outs[1] == outs[0]
    ev, dropped, counted = outs[1]
    assert dropped == counted == max(0, n + 1 - 5)
    assert [e["name"] for e in ev] == [f"e{i}" for i in range(n)][-(5 - 1):]


def test_chrome_trace_equal():
    events = [{"name": "a", "cat": "c", "ph": "X", "ts": 1.5, "dur": 2.0,
               "pid": "p", "tid": "t", "args": {"trace_id": "x" * 32}},
              {"name": "b", "cat": "c", "ph": "X", "ts": 3.0, "dur": 0.0,
               "pid": "p", "tid": "t"}]
    for meta in (None, {"host": "h", "n": 2}):
        assert tprof.chrome_trace(events, meta) == jprof.chrome_trace(
            events, meta)
