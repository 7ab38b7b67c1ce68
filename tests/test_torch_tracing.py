"""PyTorch port vs the JAX package: the tracing context
(``ray_tpu_torch/tracing.py`` against ``ray_tpu/tracing.py``).

The traceparent header formats and parses to the same context in both,
and a malformed header gives None in both; nested `start_span` records
the same span names with the same parent linkage (ids are random, so the
linkage is compared by name); carriers carry the same fields; and
`group_traces`, `build_trace_tree` and `flow_events` on one fixed event
list give equal results. Host code only: exact equality.

Then ``tests/test_tracing.py``'s `test_dashboard_traces_api_and_metrics`
on the port's cluster: a served request with a traceparent reaches the
port's dashboard as a trace of at least four spans (``/api/traces``,
``/api/traces/<id>``, 404 for an unknown id), and the serve latency
histograms reach its ``/metrics``.
"""

import collections
import dataclasses
import json
import time
import urllib.error
import urllib.request

import pytest

from ray_tpu import profiling as jprof
from ray_tpu import tracing as jtr
from ray_tpu_torch import profiling as tprof
from ray_tpu_torch import tracing as ttr

PACKAGES = [(jprof, jtr), (tprof, ttr)]


@pytest.fixture(autouse=True)
def _fresh_rings(monkeypatch):
    for prof, _tr in PACKAGES:
        monkeypatch.setattr(prof, "_events", collections.deque())


@pytest.mark.parametrize("header", [
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "  00-0AF7651916CD43DD8448EB211C80319C-B7AD6B7169203331-00 ",
    None, "", "garbage", "00-abc-def-01",
    "00-" + "0" * 32 + "-b7ad6b7169203331-01",
    "00-0af7651916cd43dd8448eb211c80319c-" + "0" * 16 + "-01",
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331",
    "00-+af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
])
def test_traceparent_parse_and_format(header):
    j, t = jtr.parse_traceparent(header), ttr.parse_traceparent(header)
    if j is None:
        assert t is None
        return
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert ttr.format_traceparent(t) == jtr.format_traceparent(j)
    assert ttr.parse_traceparent(ttr.format_traceparent(t)) == t
    jc = jtr.start_http_context(header, {"route": "/gen"})
    tc = ttr.start_http_context(header, {"route": "/gen"})
    assert (tc.trace_id, tc.parent_span_id, tc.baggage) == (
        jc.trace_id, jc.parent_span_id, jc.baggage)


def _linkage(events):
    """(name, parent name or None, trace shared with the first span) per
    span, in recording order: the structure without the random ids."""
    by_id = {e["args"]["span_id"]: e["name"] for e in events}
    first = events[0]["args"]["trace_id"]
    return [(e["name"], by_id.get(e["args"].get("parent_span_id")),
             e["args"]["trace_id"] == first) for e in events]


def _nested(prof, tr):
    with tr.start_span("root", cat="t", baggage={"route": "/r"}) as root:
        assert tr.get_current() is root
        with tr.span("child_a"):
            with tr.start_span("grandchild", baggage={"k": "v"}) as g:
                assert g.baggage == {"route": "/r", "k": "v"}
                carrier = tr.capture_for_submission()
        with tr.start_span("child_b"):
            pass
    assert tr.get_current() is None and tr.capture_for_submission() is None
    token = tr.enter_task(carrier)
    ctx = tr.get_current()
    tr.exit_task(token)
    args = tr.carrier_event_args(carrier, extra=1)
    return (_linkage(prof.drain_events()), sorted(carrier), ctx.baggage,
            ctx.parent_span_id == carrier["parent_span_id"], sorted(args))


def test_nested_spans_same_names_and_linkage():
    assert _nested(tprof, ttr) == _nested(jprof, jtr)
    links = _nested(tprof, ttr)[0]
    assert links == [("grandchild", "child_a", True),
                     ("child_a", "root", True), ("child_b", "root", True),
                     ("root", None, True)]


def _events():
    """Two traces: one of four spans over two pids (one a root with two
    children, one a grandchild carrying the hop breakdown), one of a
    single orphan whose parent never arrived; plus an untraced event."""
    ev = lambda name, ts, dur, tid, sid, parent=None, pid="p1", **a: {
        "name": name, "cat": "c", "ph": "X", "ts": ts, "dur": dur,
        "pid": pid, "tid": "t",
        "args": {"trace_id": tid, "span_id": sid,
                 **({"parent_span_id": parent} if parent else {}), **a}}
    a, b = "a" * 32, "b" * 32
    return [
        ev("req", 100.0, 500.0, a, "s1", route="/gen", status=200),
        ev("task", 150.0, 100.0, a, "s2", "s1", pid="p2",
           queue_wait_s=0.01, exec_s=0.02),
        ev("inner", 160.0, 50.0, a, "s3", "s2", pid="p2", transfer_s=0.001),
        ev("task2", 300.0, 250.0, a, "s4", "s1"),
        ev("orphan", 900.0, 10.0, b, "s9", "missing"),
        {"name": "plain", "cat": "c", "ph": "X", "ts": 1.0, "dur": 1.0,
         "pid": "p1", "tid": "t"},
    ]


def test_group_traces_tree_and_flows_equal():
    events = _events()
    assert ttr.group_traces(events) == jtr.group_traces(events)
    assert [r["num_spans"] for r in ttr.group_traces(events)] == [1, 4]
    for trace_id in ("a" * 32, "b" * 32, "c" * 32):
        assert ttr.build_trace_tree(events, trace_id) == (
            jtr.build_trace_tree(events, trace_id))
    tree = ttr.build_trace_tree(events, "a" * 32)
    assert tree["num_spans"] == 4 and len(tree["spans"]) == 1
    assert [c["name"] for c in tree["spans"][0]["children"]] == [
        "task", "task2"]
    assert ttr.flow_events(events) == jtr.flow_events(events)
    assert len(ttr.flow_events(events)) == 6


def _post(url, payload, headers=None, timeout=30):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    return urllib.request.urlopen(req, timeout=timeout)


@pytest.fixture(scope="module")
def traced_app():
    import ray_tpu_torch
    from ray_tpu_torch import serve

    ray_tpu_torch.init(num_cpus=4)

    @ray_tpu_torch.remote
    def traced_fanout(x):
        return x * 2

    @serve.deployment(name="traced_fan", route_prefix="/traced_fan")
    class Fan:
        def __call__(self, payload):
            return {"y": ray_tpu_torch.get(
                traced_fanout.remote(payload.get("x", 1)))}

    try:
        serve.run(Fan.bind())
        _proxy, port = serve.start_proxy()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            try:
                _post(f"http://127.0.0.1:{port}/traced_fan", {"x": 0})
                break
            except (urllib.error.URLError, ConnectionError):
                time.sleep(0.5)
        yield port
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()


def test_dashboard_traces_api_and_metrics(traced_app):
    from ray_tpu_torch.dashboard import start_dashboard

    port = traced_app
    trace_id = ttr.new_trace_id()
    resp = _post(f"http://127.0.0.1:{port}/traced_fan", {"x": 3},
                 headers={"traceparent":
                          f"00-{trace_id}-{ttr.new_span_id()}-01"})
    assert json.loads(resp.read()) == {"result": {"y": 6}}

    dash = start_dashboard(port=0)
    try:
        deadline = time.monotonic() + 30
        tree = None
        while time.monotonic() < deadline:
            rows = json.loads(urllib.request.urlopen(
                dash.url + "/api/traces", timeout=30).read())
            if any(r["trace_id"] == trace_id and r["num_spans"] >= 4
                   for r in rows):
                tree = json.loads(urllib.request.urlopen(
                    dash.url + f"/api/traces/{trace_id}",
                    timeout=30).read())
                break
            time.sleep(0.5)
        assert tree is not None and tree["trace_id"] == trace_id
        assert tree["num_spans"] >= 4

        # unknown trace -> 404
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(
                dash.url + "/api/traces/" + "f" * 32, timeout=30)
        assert err.value.code == 404

        # Serve latency breakdown histograms reach /metrics in proper
        # histogram exposition (cumulative le buckets, _sum, _count).
        deadline = time.monotonic() + 30
        text = ""
        while time.monotonic() < deadline:
            text = urllib.request.urlopen(
                dash.url + "/metrics", timeout=30).read().decode()
            if ("serve_request_latency_s_bucket" in text
                    and "serve_queue_wait_s_bucket" in text
                    and "serve_replica_execute_s_bucket" in text):
                break
            time.sleep(0.5)
        assert "# TYPE serve_request_latency_s histogram" in text
        assert 'le="+Inf"' in text
        assert "serve_request_latency_s_sum" in text
        assert "serve_request_latency_s_count" in text
        assert "serve_queue_wait_s_bucket" in text, text[:2000]
        assert "serve_replica_execute_s_bucket" in text
    finally:
        dash.stop()
