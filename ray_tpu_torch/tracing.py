"""Distributed tracing context of the PyTorch port.

The port's own copy of ``ray_tpu/tracing.py``, on the port's profiling
ring (`ray_tpu_torch.profiling`): the W3C-style trace context
(trace_id, span_id, parent_span_id, baggage) in a ContextVar,
`start_span`/`span` that record a span into the ring on exit, the
``args`` that make an event a span (`span_event_args`), submission
carriers, the ``traceparent`` header, and the analysis that groups
spans into traces (`group_traces`) and rebuilds one trace's tree
(`build_trace_tree`). A span is an ordinary Chrome-trace "X" event whose
``args`` carry the ids, so `profiling.chrome_trace` renders it and
`flow_events` adds the parent-to-child arrows.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import re
import threading
import time
import uuid

from ray_tpu_torch import profiling

# ---------------------------------------------------------------- context


@dataclasses.dataclass
class TraceContext:
    """One span's identity + the request baggage it carries downstream."""

    trace_id: str                      # 32 hex chars, shared by the request
    span_id: str                       # 16 hex chars, this span
    parent_span_id: str | None = None
    baggage: dict = dataclasses.field(default_factory=dict)

    def child(self) -> "TraceContext":
        return TraceContext(self.trace_id, new_span_id(), self.span_id,
                            dict(self.baggage))


_current: contextvars.ContextVar[TraceContext | None] = (
    contextvars.ContextVar("ray_tpu_torch_trace_context",
                           default=None)
)


def new_trace_id() -> str:
    return uuid.uuid4().hex


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def get_current() -> TraceContext | None:
    """The ambient trace context of the calling task/thread, or None."""
    return _current.get()


def set_current(ctx: TraceContext | None):
    """Install `ctx` as the ambient context; returns a reset token."""
    return _current.set(ctx)


def reset_current(token) -> None:
    _current.reset(token)


# ---------------------------------------------------------------- spans

@contextlib.contextmanager
def start_span(name: str, cat: str = "custom", baggage: dict | None = None):
    """Run a block under a new span (child of the ambient one, else a new
    root trace). The span records into the profiling buffer on exit and is
    the ambient parent for any submission inside the block."""
    parent = _current.get()
    if parent is not None:
        ctx = parent.child()
        if baggage:
            ctx.baggage.update(baggage)
    else:
        ctx = TraceContext(new_trace_id(), new_span_id(), None,
                           dict(baggage or {}))
    token = _current.set(ctx)
    t0 = time.time()
    try:
        yield ctx
    finally:
        _current.reset(token)
        profiling.record_event(
            name, cat, t0, time.time() - t0,
            pid=f"pid:{os.getpid()}",
            tid=threading.current_thread().name,
            args=span_event_args(ctx))


# A convenient alias mirroring profiling.span.
span = start_span


def span_event_args(ctx: TraceContext, **extra) -> dict:
    """The `args` dict that makes a profiling event a trace span."""
    out = {"trace_id": ctx.trace_id, "span_id": ctx.span_id}
    if ctx.parent_span_id:
        out["parent_span_id"] = ctx.parent_span_id
    out.update(extra)
    return out


# ---------------------------------------------------------------- carriers

def capture_for_submission() -> dict | None:
    """Snapshot the ambient context into a wire carrier.

    Called in the submitting thread at submission time. The carrier
    pre-allocates the CHILD span id (the submitted task's span), so the
    executing worker only restores it — no cross-thread handshake. Returns
    None outside any trace (untraced submissions stay zero-overhead)."""
    cur = _current.get()
    if cur is None:
        return None
    return {
        "trace_id": cur.trace_id,
        "span_id": new_span_id(),
        "parent_span_id": cur.span_id,
        "baggage": dict(cur.baggage),
        "submitted_at": time.time(),
    }


def context_from_carrier(carrier: dict) -> TraceContext:
    return TraceContext(
        carrier["trace_id"], carrier["span_id"],
        carrier.get("parent_span_id"), dict(carrier.get("baggage") or {}),
    )


def enter_task(carrier: dict | None):
    """Restore a carrier as the ambient context at task execution start.

    Always sets the ContextVar — pooled worker threads would otherwise leak
    the previous task's context into unrelated submissions. Also stamps the
    carrier's queue wait (submission -> execution start). Returns the reset
    token for exit_task()."""
    ctx = None
    if carrier is not None:
        if "submitted_at" in carrier:
            carrier["queue_wait_s"] = max(
                0.0, time.time() - carrier["submitted_at"])
        ctx = context_from_carrier(carrier)
    return _current.set(ctx)


def exit_task(token) -> None:
    _current.reset(token)


def carrier_event_args(carrier: dict, **extra) -> dict:
    """Span args for the worker's per-task profiling event, including the
    per-hop breakdown the executing side stamped into the carrier."""
    out = {"trace_id": carrier["trace_id"], "span_id": carrier["span_id"]}
    if carrier.get("parent_span_id"):
        out["parent_span_id"] = carrier["parent_span_id"]
    for k in ("queue_wait_s", "transfer_s", "exec_s"):
        if k in carrier:
            out[k] = round(float(carrier[k]), 6)
    out.update(extra)
    return out


# ---------------------------------------------------------------- W3C header

def format_traceparent(ctx: TraceContext) -> str:
    """`00-<trace_id>-<span_id>-01` (W3C trace-context, sampled flag on)."""
    return f"00-{ctx.trace_id}-{ctx.span_id}-01"


_HEX32 = re.compile(r"[0-9a-f]{32}")
_HEX16 = re.compile(r"[0-9a-f]{16}")


def parse_traceparent(header: str | None) -> TraceContext | None:
    """Parse an incoming traceparent header into the REMOTE parent context
    (its span_id is the caller's span). Returns None on any malformation —
    a bad header must never fail the request. Uppercase hex is accepted
    leniently but canonicalized to the W3C lowercase form (int() parsing
    would also admit '+'/'_' prefixes that break downstream id routing)."""
    if not header:
        return None
    parts = header.strip().lower().split("-")
    if len(parts) != 4:
        return None
    _version, trace_id, span_id, _flags = parts
    if not _HEX32.fullmatch(trace_id) or not _HEX16.fullmatch(span_id):
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return TraceContext(trace_id, span_id)


def start_http_context(traceparent: str | None = None,
                       baggage: dict | None = None) -> TraceContext:
    """Root span context for one ingress HTTP request: a child of the
    incoming traceparent when present, else a brand-new trace."""
    remote_parent = parse_traceparent(traceparent)
    if remote_parent is not None:
        return TraceContext(remote_parent.trace_id, new_span_id(),
                            remote_parent.span_id, dict(baggage or {}))
    return TraceContext(new_trace_id(), new_span_id(), None,
                        dict(baggage or {}))


# ---------------------------------------------------------------- analysis

def _span_events(events: list[dict]) -> list[dict]:
    return [e for e in events
            if e.get("ph") == "X" and (e.get("args") or {}).get("trace_id")]


def flow_events(events: list[dict]) -> list[dict]:
    """Chrome-trace flow arrows (`ph: "s"`/`"f"`) connecting each child
    span to its parent across pids/tids, so chrome://tracing / Perfetto
    draw one request's causal path through every process."""
    spans = _span_events(events)
    by_span_id = {e["args"]["span_id"]: e for e in spans
                  if e["args"].get("span_id")}
    out = []
    for child in spans:
        parent_id = child["args"].get("parent_span_id")
        parent = by_span_id.get(parent_id)
        if parent is None:
            continue
        fid = f"{child['args']['trace_id'][:8]}:{child['args']['span_id']}"
        out.append({"name": "trace", "cat": "trace", "ph": "s", "id": fid,
                    "ts": parent["ts"], "pid": parent["pid"],
                    "tid": parent["tid"]})
        out.append({"name": "trace", "cat": "trace", "ph": "f", "bp": "e",
                    "id": fid, "ts": child["ts"], "pid": child["pid"],
                    "tid": child["tid"]})
    return out


def group_traces(events: list[dict]) -> list[dict]:
    """One summary row per trace_id (newest first): span count, root name,
    start, end-to-end duration."""
    by_trace: dict[str, list[dict]] = {}
    for e in _span_events(events):
        by_trace.setdefault(e["args"]["trace_id"], []).append(e)
    rows = []
    for trace_id, spans in by_trace.items():
        spans.sort(key=lambda e: e["ts"])
        end = max(e["ts"] + e.get("dur", 0) for e in spans)
        roots = [e for e in spans if not e["args"].get("parent_span_id")]
        root = (roots or spans)[0]
        rows.append({
            "trace_id": trace_id,
            "num_spans": len(spans),
            "root": root["name"],
            "start_ts_us": spans[0]["ts"],
            "duration_s": round((end - spans[0]["ts"]) / 1e6, 6),
        })
    rows.sort(key=lambda r: -r["start_ts_us"])
    return rows


def build_trace_tree(events: list[dict], trace_id: str) -> dict | None:
    """Reconstruct one trace's span tree with per-hop durations.

    Returns {"trace_id", "num_spans", "duration_s", "spans": [roots]} where
    each span node carries name/cat/pid/tid, start + duration, the
    queue-wait / transfer / execute breakdown the worker stamped, and its
    children. None when no span of that trace exists (yet)."""
    spans = [e for e in _span_events(events)
             if e["args"]["trace_id"] == trace_id]
    if not spans:
        return None
    spans.sort(key=lambda e: e["ts"])
    nodes: dict[str, dict] = {}
    for e in spans:
        a = e["args"]
        node = {
            "span_id": a.get("span_id"),
            "parent_span_id": a.get("parent_span_id"),
            "name": e["name"], "cat": e.get("cat"),
            "pid": e.get("pid"), "tid": e.get("tid"),
            "start_ts_us": e["ts"],
            "duration_s": round(e.get("dur", 0) / 1e6, 6),
            "children": [],
        }
        for k in ("queue_wait_s", "transfer_s", "exec_s", "route", "status"):
            if k in a:
                node[k] = a[k]
        if node["span_id"]:
            nodes[node["span_id"]] = node
    roots = []
    for node in nodes.values():
        parent = nodes.get(node["parent_span_id"])
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    for node in nodes.values():
        node["children"].sort(key=lambda n: n["start_ts_us"])
    roots.sort(key=lambda n: n["start_ts_us"])
    start = min(e["ts"] for e in spans)
    end = max(e["ts"] + e.get("dur", 0) for e in spans)
    return {
        "trace_id": trace_id,
        "num_spans": len(nodes),
        "duration_s": round((end - start) / 1e6, 6),
        "spans": roots,
    }
