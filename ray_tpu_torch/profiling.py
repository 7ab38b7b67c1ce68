"""Profiling events and the metrics registry of the PyTorch port.

The port's own copy of ``ray_tpu/profiling.py``: the same event ring
(``record_event``, ``span``, ``drain_events``, ``peek_events``, the drop
count and ``MAX_BUFFER``), the same registry (``Counter``, ``Gauge``,
``Histogram``, ``metrics_snapshot``), the same Prometheus exposition and
Chrome-trace rendering, so a port replica's ``/metrics`` rows and trace
events read like a JAX replica's. The registry and the ring are this
module's, per process; a caller reads them with `metrics_snapshot` and
`peek_events`. Inside the port's runtime (`ray_tpu_torch.core`), every
worker and driver also ships them to the GCS with `run_obs_flush_loop`
(events at most once through `ObsFlusher`, metrics as whole snapshots),
as the reference's processes do.
"""

from __future__ import annotations

import collections
import json
import logging
import threading
import time

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------- events

_events: "collections.deque[dict]" = collections.deque()
_events_lock = threading.Lock()
MAX_BUFFER = 10_000
# Overflow is a ring: the oldest event is evicted and counted, so a
# process that never drains keeps its most recent spans. _dropped_total is
# the lifetime count; _dropped_reported is the share a flush loop has
# already shipped to the GCS.
_dropped_total = 0
_dropped_reported = 0


def record_event(name: str, cat: str, start_s: float, dur_s: float,
                 pid: str = "driver", tid: str = "main",
                 args: dict | None = None) -> None:
    """Record one complete ("X") span. Timestamps: time.time() seconds."""
    global _dropped_total
    ev = {
        "name": name, "cat": cat, "ph": "X",
        "ts": start_s * 1e6, "dur": dur_s * 1e6,
        "pid": pid, "tid": tid,
    }
    if args:
        ev["args"] = args
    with _events_lock:
        _events.append(ev)
        if len(_events) <= MAX_BUFFER:
            return
        _events.popleft()
        _dropped_total += 1
    _DROPPED_METRIC.inc(1.0)


class span:
    """with profiling.span("name", cat="custom"): ..."""

    def __init__(self, name: str, cat: str = "custom", pid: str = "driver",
                 tid: str = "main"):
        self.name, self.cat, self.pid, self.tid = name, cat, pid, tid

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        record_event(self.name, self.cat, self.t0, time.time() - self.t0,
                     self.pid, self.tid)
        return False


def drain_events() -> list[dict]:
    with _events_lock:
        out = list(_events)
        _events.clear()
    return out


def peek_events() -> list[dict]:
    """Non-destructive snapshot of the ring."""
    with _events_lock:
        return list(_events)


def mark_dropped_reported(n: int) -> None:
    """Commit `n` drops as shipped to the GCS — called AFTER the flush RPC
    succeeds, so a failed flush retries the same count next tick."""
    global _dropped_reported
    with _events_lock:
        _dropped_reported = min(_dropped_total, _dropped_reported + n)


class ObsFlusher:
    """One-batch-at-a-time shipper of this process's profile events to the
    GCS with at-most-once delivery: each batch carries a per-source seq,
    and a failed flush retries the SAME batch (same seq) next tick, so the
    GCS can discard the duplicate after a timed-out-but-applied call.
    Drops are marked reported only after the RPC succeeds."""

    def __init__(self, source: str):
        self.source = source
        self.seq = 0
        self.pending: dict | None = None

    async def flush(self, call) -> None:
        """`call(payload) -> awaitable` ships one batch; raises on failure
        (the caller decides whether to log/ignore; state stays retryable)."""
        if self.pending is None:
            events = drain_events()
            dropped = events_dropped_unreported()
            if events or dropped:
                self.seq += 1
                self.pending = {"events": events, "dropped": dropped,
                                "seq": self.seq}
        if self.pending is None:
            return
        await call({"source": self.source, **self.pending})
        mark_dropped_reported(self.pending["dropped"])
        self.pending = None


async def run_obs_flush_loop(source: str, gcs_call, interval_s: float,
                             should_stop) -> None:
    """The per-process observability flush loop of workers and drivers:
    every `interval_s`, ship the profile-event batch (at-most-once via
    ObsFlusher) and the metrics snapshot (idempotent last-snapshot-wins)
    to the GCS. `gcs_call(method, payload)` -> awaitable; `should_stop()`
    -> bool."""
    import asyncio

    flusher = ObsFlusher(source)
    while not should_stop():
        await asyncio.sleep(interval_s)
        try:
            await flusher.flush(lambda p: gcs_call("profile_add", p))
        except Exception:
            pass  # batch kept; same seq retries next tick
        try:
            rows = metrics_snapshot()
            if rows:
                await gcs_call("metrics_push",
                               {"source": source, "rows": rows})
        except Exception:
            pass


def events_dropped_total() -> int:
    """This process's lifetime drop count."""
    with _events_lock:
        return _dropped_total


def events_dropped_unreported() -> int:
    """Drops the GCS doesn't know about yet."""
    with _events_lock:
        return _dropped_total - _dropped_reported


# ---------------------------------------------------------------- metrics

# Shared latency histogram boundaries (seconds) for the serving path, the
# reference's, so the port's histograms stay bucket-comparable with it.
LATENCY_BUCKETS_S = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                     5.0, 10.0, 30.0)


class _Metric:
    def __init__(self, name: str, description: str = "",
                 tag_keys: tuple = (), default_tags: dict | None = None):
        self.name = name
        self.description = description
        self.default_tags = dict(default_tags or {})
        # default_tags introduce their keys implicitly: every series
        # carries the defaults unless a call-site tag overrides them.
        self.tag_keys = tuple(tag_keys) + tuple(
            k for k in self.default_tags if k not in tag_keys)
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()
        _registry[name] = self

    def _key(self, tags: dict | None) -> tuple:
        merged = {**self.default_tags, **(tags or {})}
        return tuple(str(merged.get(k, "")) for k in self.tag_keys)

    def snapshot(self) -> list[tuple[tuple, float]]:
        with self._lock:
            return list(self._values.items())

    def remove(self, tags: dict | None = None) -> bool:
        """Drop one tagged series from this metric (a retired replica's
        gauge must not export its last value forever)."""
        k = self._key(tags)
        with self._lock:
            return self._values.pop(k, None) is not None

    kind = "gauge"


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, tags: dict | None = None) -> None:
        if value < 0:
            raise ValueError(
                f"Counter.inc() requires a non-negative value, got {value}")
        k = self._key(tags)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, tags: dict | None = None) -> None:
        with self._lock:
            self._values[self._key(tags)] = float(value)


class Histogram(_Metric):
    """Prometheus-style cumulative buckets."""

    kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: tuple = (0.01, 0.1, 1, 10, 100),
                 tag_keys: tuple = (), default_tags: dict | None = None):
        super().__init__(name, description, tag_keys, default_tags)
        self.boundaries = tuple(boundaries)
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}

    def observe(self, value: float, tags: dict | None = None) -> None:
        k = self._key(tags)
        with self._lock:
            counts = self._counts.setdefault(
                k, [0] * (len(self.boundaries) + 1))
            for i, b in enumerate(self.boundaries):
                if value <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._sums[k] = self._sums.get(k, 0.0) + value
            self._values[k] = sum(counts)  # observation count

    def snapshot_hist(self):
        with self._lock:
            return ({k: list(v) for k, v in self._counts.items()},
                    dict(self._sums))

    def remove(self, tags: dict | None = None) -> bool:
        k = self._key(tags)
        with self._lock:
            self._counts.pop(k, None)
            self._sums.pop(k, None)
            return self._values.pop(k, None) is not None


_registry: dict[str, _Metric] = {}

# Created once per process (a metric has no series until its first inc,
# so a process that never overflows exports nothing).
_DROPPED_METRIC = Counter(
    "profile_events_dropped_total",
    description="Profile events dropped at a full process buffer")


def metrics_snapshot() -> list[dict]:
    """This process's metrics as rows. Histogram rows carry their
    per-bucket counts and sum so `prometheus_text` can render cumulative
    `le` buckets."""
    out = []
    for m in list(_registry.values()):
        if m.kind == "histogram":
            counts, sums = m.snapshot_hist()
            for key, buckets in counts.items():
                out.append({
                    "name": m.name, "kind": m.kind,
                    "description": m.description,
                    "tags": dict(zip(m.tag_keys, key)),
                    "value": float(sum(buckets)),
                    "buckets": list(buckets),
                    "sum": sums.get(key, 0.0),
                    "boundaries": list(m.boundaries),
                })
            continue
        for key, value in m.snapshot():
            out.append({
                "name": m.name, "kind": m.kind, "description": m.description,
                "tags": dict(zip(m.tag_keys, key)), "value": value,
            })
    return out


# Cumulative histogram-merge-conflict tally per metric name (rendered as
# metrics_merge_conflicts_total). Module state, not a registered Counter:
# it counts renders of conflicting rows without feeding back into them.
_merge_conflicts_total: dict[str, int] = {}
_merge_conflicts_lock = threading.Lock()


def prometheus_text(rows: list[dict]) -> str:
    """Render metric rows in Prometheus exposition format. Counter rows
    with identical (name, tags) are summed; gauges keep the last value;
    histogram rows merge bucket-wise into `_bucket`/`_sum`/`_count`
    series with cumulative `le` labels."""
    scalars: dict[tuple, float] = {}
    hists: dict[tuple, dict] = {}
    meta: dict[str, tuple[str, str]] = {}
    conflicts: dict[str, int] = {}
    for r in rows:
        name = r["name"]
        tags = tuple(sorted(r.get("tags", {}).items()))
        key = (name, tags)
        meta[name] = (r["kind"], r.get("description", ""))
        if r["kind"] == "histogram" and r.get("buckets") is not None:
            bounds = tuple(r.get("boundaries", ()))
            h = hists.setdefault(key, {
                "boundaries": bounds,
                "buckets": [0] * (len(bounds) + 1), "sum": 0.0,
            })
            if (h["boundaries"] == bounds
                    and len(h["buckets"]) == len(r["buckets"])):
                h["buckets"] = [a + b for a, b in zip(h["buckets"],
                                                      r["buckets"])]
                h["sum"] += float(r.get("sum", 0.0))
            else:
                # One name with two boundary sets cannot merge bucket-
                # wise: the row is dropped and counted in the exposition.
                conflicts[name] = conflicts.get(name, 0) + 1
                logger.warning(
                    "histogram %s: boundary mismatch across sources "
                    "(%s vs %s); dropping a conflicting row from exposition",
                    name, h["boundaries"], bounds)
        elif r["kind"] == "counter":
            scalars[key] = scalars.get(key, 0.0) + r["value"]
        else:
            scalars[key] = r["value"]

    with _merge_conflicts_lock:
        for name, n in conflicts.items():
            _merge_conflicts_total[name] = (
                _merge_conflicts_total.get(name, 0) + n)
        snapshot_conflicts = dict(_merge_conflicts_total)
    if snapshot_conflicts:
        meta["metrics_merge_conflicts_total"] = (
            "counter", "Histogram rows dropped from exposition due to "
            "bucket-boundary mismatch across sources")
        for name, n in snapshot_conflicts.items():
            key = ("metrics_merge_conflicts_total", (("metric", name),))
            scalars[key] = scalars.get(key, 0.0) + n

    lines: list[str] = []
    emitted: set[str] = set()

    def escape(value) -> str:
        # Label-value escaping: a backslash, double quote or newline in a
        # tag value would otherwise corrupt the whole scrape page.
        return (str(value).replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))

    def labels(tags, extra=()) -> str:
        return ",".join(f'{k}="{escape(v)}"' for k, v in (*tags, *extra))

    def emit_meta(name: str) -> None:
        if name in emitted:
            return
        kind, desc = meta[name]
        if desc:
            lines.append(f"# HELP {name} {desc}")
        lines.append(f"# TYPE {name} {kind}")
        emitted.add(name)

    def sample(name: str, tags, value, extra=()) -> None:
        label = labels(tags, extra)
        lines.append(f"{name}{{{label}}} {value}" if label
                     else f"{name} {value}")

    for (name, tags), value in sorted(scalars.items()):
        emit_meta(name)
        sample(name, tags, value)
    for (name, tags), h in sorted(hists.items()):
        emit_meta(name)
        cum = 0
        for bound, count in zip(h["boundaries"], h["buckets"][:-1]):
            cum += count
            sample(f"{name}_bucket", tags, cum, extra=(("le", bound),))
        cum += h["buckets"][-1]
        sample(f"{name}_bucket", tags, cum, extra=(("le", "+Inf"),))
        sample(f"{name}_sum", tags, h["sum"])
        sample(f"{name}_count", tags, cum)
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------- timeline

def chrome_trace(events: list[dict], metadata: dict | None = None) -> str:
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if metadata:
        doc["metadata"] = metadata
    return json.dumps(doc)
