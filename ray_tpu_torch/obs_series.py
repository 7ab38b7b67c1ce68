"""Bounded rolling time-series store for cluster metrics.

The decision plane (shadow autoscaler, SLO monitor restarts, `status
--serve --history` sparklines) needs metric *history*, not snapshots:
Ray's Serve autoscaler decides from a rolling window of per-replica
metrics, and every signal this repo already exports (`slo_burn_rate`,
`llm_queue_depth`, prefix-cache hit rate) was point-in-time until now.

`SeriesStore` is the shared ring-buffer engine behind that history:

- The GCS folds every `metrics_push` snapshot into per-key rings
  (key = metric name + tags + source), queryable via the `series_query`
  RPC → `state.query_series()` → `GET /api/series`.
- `bench_serve.py --ramp` and tests run a local store with the same
  semantics, so the shadow autoscaler's series interface is identical
  in-process and against a live cluster.

Memory is fixed by construction: at most `max_series` rings of at most
`max_points` points each. Scalar rows store floats; histogram rows store
their per-bucket count vector (what the SLO monitor seeds its rolling
window from after a restart). Sources push *full* snapshots, so a series
absent from its source's latest push (a removed replica's gauge, a
retired source) is tombstoned and deleted after `tombstone_ttl_s` —
post-mortems can still read it during the TTL, but a churny bench can't
grow the GCS unboundedly.
"""

from __future__ import annotations

import collections
import threading
import time

__all__ = ["SeriesStore", "sparkline", "resample"]


def _tags_key(tags: dict | None) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in (tags or {}).items()))


class SeriesStore:
    """Per-(name, tags, source) rolling rings of (ts, value) points."""

    def __init__(self, max_points: int = 512, resolution_s: float = 1.0,
                 max_series: int = 4096, tombstone_ttl_s: float = 120.0):
        if max_points < 1:
            raise ValueError(f"max_points must be >= 1, got {max_points}")
        if max_series < 1:
            raise ValueError(f"max_series must be >= 1, got {max_series}")
        self.max_points = int(max_points)
        self.resolution_s = float(resolution_s)
        self.max_series = int(max_series)
        self.tombstone_ttl_s = float(tombstone_ttl_s)
        # key → series record. Insertion order doubles as the eviction
        # scan order fallback; recency is tracked per-record (last_ts).
        self._series: dict[tuple, dict] = {}
        # source → set of keys it feeds (tombstone-on-expiry index).
        self._by_source: dict[str, set[tuple]] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------- write

    def record(self, name: str, value, tags: dict | None = None, *,
               source: str = "local", kind: str = "gauge",
               ts: float | None = None, boundaries=None) -> None:
        """Append one point. Points within `resolution_s` of the series'
        newest point COALESCE (last write wins) — a fast pusher costs one
        ring slot per resolution bucket, not one per push."""
        if ts is None:
            ts = time.time()
        key = (name, _tags_key(tags), source)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                if len(self._series) >= self.max_series:
                    self._evict_locked(ts)
                s = self._series[key] = {
                    "name": name,
                    "tags": {str(k): str(v)
                             for k, v in (tags or {}).items()},
                    "source": source,
                    "kind": kind,
                    "points": collections.deque(maxlen=self.max_points),
                    "tombstoned_at": None,
                    "boundaries": (list(boundaries)
                                   if boundaries is not None else None),
                }
                self._by_source.setdefault(source, set()).add(key)
            # A point on a tombstoned series revives it (a replica tag
            # coming back means the series is live again).
            s["tombstoned_at"] = None
            pts = s["points"]
            if pts and ts - pts[-1][0] < self.resolution_s:
                pts[-1] = (pts[-1][0], value)
            else:
                pts.append((ts, value))

    def record_rows(self, source: str, rows: list[dict],
                    ts: float | None = None) -> None:
        """Fold one metrics_push snapshot. Sources push FULL snapshots,
        so any series of this source missing from `rows` no longer exists
        in the pusher's registry (e.g. a removed replica's gauge) — it is
        tombstoned here and swept after the TTL."""
        if ts is None:
            ts = time.time()
        seen: set[tuple] = set()
        for r in rows:
            kind = r.get("kind", "gauge")
            if kind == "histogram":
                buckets = r.get("buckets")
                if buckets is None:
                    continue
                value = [float(b) for b in buckets]
            else:
                value = float(r.get("value", 0.0))
            tags = r.get("tags") or {}
            self.record(r["name"], value, tags, source=source, kind=kind,
                        ts=ts, boundaries=r.get("boundaries"))
            seen.add((r["name"], _tags_key(tags), source))
        with self._lock:
            for key in self._by_source.get(source, set()) - seen:
                s = self._series.get(key)
                if s is not None and s["tombstoned_at"] is None:
                    s["tombstoned_at"] = ts
        self.sweep(ts)

    def tombstone_source(self, source: str, now: float | None = None) -> int:
        """Mark every series of an expired source for deletion (called by
        the GCS stale-source TTL sweep). Returns how many were marked."""
        if now is None:
            now = time.time()
        n = 0
        with self._lock:
            for key in self._by_source.get(source, ()):
                s = self._series.get(key)
                if s is not None and s["tombstoned_at"] is None:
                    s["tombstoned_at"] = now
                    n += 1
        return n

    def sweep(self, now: float | None = None) -> int:
        """Delete series tombstoned longer than `tombstone_ttl_s` ago."""
        if now is None:
            now = time.time()
        with self._lock:
            dead = [k for k, s in self._series.items()
                    if s["tombstoned_at"] is not None
                    and now - s["tombstoned_at"] > self.tombstone_ttl_s]
            for k in dead:
                self._drop_locked(k)
        return len(dead)

    def _drop_locked(self, key: tuple) -> None:
        s = self._series.pop(key, None)
        if s is None:
            return
        src = self._by_source.get(s["source"])
        if src is not None:
            src.discard(key)
            if not src:
                del self._by_source[s["source"]]

    def _evict_locked(self, now: float) -> None:
        """Make room for one new series: evict a tombstoned one first,
        else the series with the oldest newest-point (stalest signal)."""
        victim = None
        oldest = None
        for k, s in self._series.items():
            if s["tombstoned_at"] is not None:
                victim = k
                break
            last = s["points"][-1][0] if s["points"] else 0.0
            if oldest is None or last < oldest:
                victim, oldest = k, last
        if victim is not None:
            self._drop_locked(victim)

    # -------------------------------------------------------------- read

    def query(self, name: str | None = None, tags: dict | None = None,
              window_s: float | None = None,
              now: float | None = None) -> list[dict]:
        """Matching series, each with its in-window points (oldest
        first). `tags` subset-filters (every given pair must match);
        tombstoned-but-unswept series are included, flagged, so a
        post-mortem can still read a removed replica's tail."""
        if now is None:
            now = time.time()
        cutoff = None if window_s is None else now - window_s
        want = {str(k): str(v) for k, v in (tags or {}).items()}
        out = []
        with self._lock:
            for s in self._series.values():
                if name is not None and s["name"] != name:
                    continue
                if any(s["tags"].get(k) != v for k, v in want.items()):
                    continue
                pts = [[ts, v] for ts, v in s["points"]
                       if cutoff is None or ts >= cutoff]
                row = {"name": s["name"], "tags": dict(s["tags"]),
                       "source": s["source"], "kind": s["kind"],
                       "points": pts,
                       "tombstoned": s["tombstoned_at"] is not None}
                if s["boundaries"] is not None:
                    row["boundaries"] = list(s["boundaries"])
                out.append(row)
        out.sort(key=lambda r: (r["name"], sorted(r["tags"].items())))
        return out

    def stats(self) -> dict:
        """Bounded-memory accounting: series/point counts vs the caps
        (the ramp bench commits these so the bound is checkable from the
        artifact alone)."""
        with self._lock:
            per = [len(s["points"]) for s in self._series.values()]
            return {
                "series": len(per),
                "points_total": sum(per),
                "points_max_per_series": max(per, default=0),
                "max_points": self.max_points,
                "max_series": self.max_series,
                "tombstoned": sum(
                    1 for s in self._series.values()
                    if s["tombstoned_at"] is not None),
            }


# ------------------------------------------------------------- rendering

_SPARK_BARS = "▁▂▃▄▅▆▇█"


def sparkline(values: list[float]) -> str:
    """Unicode block sparkline ("▁▂▅█…") of a value list; "" if empty."""
    vals = [float(v) for v in values]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return _SPARK_BARS[0] * len(vals)
    top = len(_SPARK_BARS) - 1
    return "".join(
        _SPARK_BARS[min(top, int((v - lo) / span * top + 0.5))]
        for v in vals)


def resample(series_list: list[dict], window_s: float, buckets: int = 40,
             agg: str = "sum", now: float | None = None) -> list[float]:
    """Aggregate scalar series into `buckets` equal time slices over the
    trailing window: within each series the newest point per slice wins
    (carry-forward across empty slices once the series has started), then
    slices combine across series by `agg` ("sum" | "max" | "mean").
    Leading slices before any data are dropped, so the result length is
    <= buckets."""
    if buckets < 1 or window_s <= 0:
        return []
    if now is None:
        now = time.time()
    t0 = now - window_s
    step = window_s / buckets
    grids: list[list[float | None]] = []
    for s in series_list:
        grid: list[float | None] = [None] * buckets
        for ts, v in s.get("points", ()):
            if not isinstance(v, (int, float)):
                continue        # histogram series don't resample
            i = int((ts - t0) / step)
            if 0 <= i < buckets:
                grid[i] = float(v)
        last = None
        for i in range(buckets):
            if grid[i] is None:
                grid[i] = last
            else:
                last = grid[i]
        grids.append(grid)
    out: list[float] = []
    started = False
    for i in range(buckets):
        cell = [g[i] for g in grids if g[i] is not None]
        if not cell:
            if started:
                out.append(out[-1])
            continue
        started = True
        if agg == "max":
            out.append(max(cell))
        elif agg == "mean":
            out.append(sum(cell) / len(cell))
        else:
            out.append(sum(cell))
    return out
