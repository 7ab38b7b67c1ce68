"""HTTP ingress.

Parity: `python/ray/serve/_private/http_proxy.py:217,386`
(HTTPProxyActor + LongestPrefixRouter). The default proxy is an asyncio
server running inside a proxy actor: request waits are thread-free (the
client's `get_future` resolves assignment results on its own loop), so
thousands of requests can be in flight without a thread each. Submission-
time work that may block (route refresh, cold starts, non-inline results)
runs on a small fixed dispatch pool. Admission control: beyond
`serve_http_max_inflight` in-flight requests the proxy answers 503 — queued
work is bounded, overload is surfaced to the client, not buffered.

Requests route by longest matching route_prefix to a DeploymentHandle.
Bodies: JSON in → JSON out; `stream: true` (or Accept: text/event-stream)
switches to server-sent events fed by the replica's cursor-stream protocol.

One proxy per node (`start_proxies`) matches the reference's per-node
HTTPProxyActor deployment; `start_proxy` starts the singleton used by tests
and single-node clusters.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ray_tpu_torch import profiling, tracing

logger = logging.getLogger(__name__)

_REASONS = {
    200: b"OK", 400: b"Bad Request", 404: b"Not Found",
    413: b"Payload Too Large", 500: b"Internal Server Error",
    501: b"Not Implemented", 503: b"Service Unavailable",
}

# Per-request Serve latency breakdown, flushed to the GCS by the hosting
# worker's observability loop and exposed at the dashboard's /metrics.
_REQS_TOTAL = profiling.Counter(
    "serve_requests_total", description="Ingress HTTP requests",
    tag_keys=("route", "status"))
_REQ_LATENCY = profiling.Histogram(
    "serve_request_latency_s",
    description="Ingress end-to-end request latency",
    boundaries=profiling.LATENCY_BUCKETS_S, tag_keys=("route",))
_QUEUE_WAIT = profiling.Histogram(
    "serve_queue_wait_s",
    description="Ingress queue wait: request admission to replica dispatch",
    boundaries=profiling.LATENCY_BUCKETS_S, tag_keys=("route",))
# Fault-tolerance accounting (shared by both proxy implementations and
# DeploymentHandle.stream): every failover — a request resubmitted to a
# surviving replica after a death/drain — and every request that reached
# a client as an error, by reason.
_FAILOVERS = profiling.Counter(
    "serve_failovers_total",
    description="Requests failed over to a surviving replica",
    tag_keys=("route", "mode"))
_REQS_FAILED = profiling.Counter(
    "serve_requests_failed_total",
    description="Ingress requests that returned an error to the client",
    tag_keys=("route", "reason"))
# Overload shedding (bounded degradation): requests refused with a typed
# 503 + Retry-After because the deployment's autoscaler is pinned at
# max_replicas and every replica's probed queue depth crossed
# serve_overload_queue_depth — shed, not queued, so in-flight decodes
# keep their latency while the overflow gets an honest retry signal.
_REQS_SHED = profiling.Counter(
    "serve_requests_shed_total",
    description="Ingress requests shed under pinned-at-max overload",
    tag_keys=("route",))
# Disaggregated-pool handoffs (prefill → decode): the NORMAL path of a
# split deployment — counted separately from failovers because a
# handoff is not a failure and never spends the failover budget.
_HANDOFFS = profiling.Counter(
    "serve_handoffs_total",
    description="Streams handed off from a prefill-pool replica to its "
                "decode pool",
    tag_keys=("route",))


def _shed_body(shed: dict) -> bytes:
    return json.dumps({
        "error": "overloaded", "type": "overloaded",
        "retry_after_s": shed["retry_after_s"],
        "queue_depth_min": shed.get("queue_depth_min"),
    }).encode()


# Drain/migration rejections cross the actor boundary as RayTaskError
# text, so classification matches these exact marker phrases (the ones
# Replica.handle_request / LLMEngine.submit / LLMDeployment.generate
# raise with) — NOT loose substrings, which would silently re-run a user
# exception that merely mentions "draining" on another replica.
_DRAIN_MARKERS = ("replica draining:",
                  "request migrated off draining replica")


def failover_mode(e: BaseException) -> str | None:
    """Classify an exception as retriable-on-another-replica.

    → "death" (replica actor died / unreachable), "drain" (replica
    rejected or migrated the request while draining), or None (not a
    failover case — surface to the client)."""
    from ray_tpu_torch.exceptions import ActorDiedError, ActorUnavailableError

    if isinstance(e, (ActorDiedError, ActorUnavailableError)):
        return "death"
    s = str(e)
    if any(m in s for m in _DRAIN_MARKERS):
        return "drain"
    return None


def absorb_handoff(hand: dict | None, carry: dict) -> str | None:
    """THE one copy of the handoff-record field transfer (async proxy
    SSE/unary, threaded proxy, and DeploymentHandle.stream all route
    through it — a fifth hand-rolled copy would drift): fold the donor's
    resume context — KV page-set descriptor + memoized hash chain — into
    `carry`, the dict every subsequent resubmit payload is updated with.
    → the destination deployment for a POOL handoff, else None."""
    hand = hand or {}
    if hand.get("kv"):
        carry["kv"] = hand["kv"]
    if hand.get("prefix_hashes"):
        carry["prefix_hashes"] = hand["prefix_hashes"]
        carry["prefix_chunk"] = hand.get("prefix_chunk", 0)
    return hand.get("deployment")


def confirmed_dead(e: BaseException) -> bool:
    """True only for a DEFINITIVE death (ActorDiedError — the raylet
    watched the worker die). ActorUnavailableError also failovers as
    "death" but can be transient (dial timeout, slow start), so it must
    never seed the process-wide dead set — an entry there outlives
    every routing-table refresh and would permanently blacklist a live
    replica."""
    from ray_tpu_torch.exceptions import ActorDiedError

    return isinstance(e, ActorDiedError)


def _decode_payload(command: str, parsed, headers: dict, body: bytes):
    """JSON body (POST) or query params (GET) → handler payload, plus the
    stream flag ("stream" in payload or Accept: text/event-stream)."""
    if command == "POST":
        try:
            payload = json.loads(body) if body.strip() else {}
        except json.JSONDecodeError:
            payload = {"body": body.decode("utf-8", "replace")}
    else:
        q = parse_qs(parsed.query)
        payload = {k: v[0] if len(v) == 1 else v for k, v in q.items()}
    wants_stream = "text/event-stream" in headers.get("accept", "")
    if isinstance(payload, dict) and "stream" in payload:
        v = payload["stream"]
        # Query params arrive as strings: "false"/"0" disable.
        wants_stream = v not in (False, None, "", "0", "false", "no")
    return payload, wants_stream


class _RouterMixin:
    """Route table + handle cache shared by both proxy implementations."""

    def _init_router(self):
        self._handles: dict = {}
        self._routes: dict[str, str] = {}   # prefix → deployment name
        self._rlock = threading.Lock()
        self._route_dirty = threading.Event()
        self._route_dirty.set()
        self._router_stop = threading.Event()
        try:
            from ray_tpu_torch import api as _api
            from ray_tpu_torch.serve.controller import ROUTES_CHANNEL

            _api._ensure_client().subscribe_channel(
                ROUTES_CHANNEL, lambda _p: self._route_dirty.set())
        except Exception as e:
            logger.debug("routes push subscription failed (proxy falls "
                         "back to interval refresh): %s", e)
        self._refresher = threading.Thread(target=self._refresh_loop,
                                           daemon=True)
        self._refresher.start()

    def _match(self, path: str) -> str | None:
        with self._rlock:
            best = None
            for prefix, name in self._routes.items():
                if prefix and path.startswith(prefix):
                    if best is None or len(prefix) > len(best[0]):
                        best = (prefix, name)
            return best[1] if best else None

    def _handle(self, name: str):
        from ray_tpu_torch.serve.api import DeploymentHandle

        with self._rlock:
            h = self._handles.get(name)
            if h is None:
                h = DeploymentHandle(name)
                self._handles[name] = h
            return h

    def _refresh_loop(self):
        """Route table updates are push-driven (GCS pubsub invalidation, ref
        long_poll.py); the 5s timeout is a lost-notify safety net."""
        import ray_tpu_torch
        from ray_tpu_torch.serve.api import _get_controller

        while not self._router_stop.is_set():
            self._route_dirty.wait(timeout=5.0)
            self._route_dirty.clear()
            if self._router_stop.is_set():
                return
            try:
                ctrl = _get_controller()
                table = ray_tpu_torch.get(ctrl.get_routing.remote(-1), timeout=30)
                if table:
                    with self._rlock:
                        self._routes = {
                            r["route_prefix"]: name
                            for name, r in table["routes"].items()
                            if r["route_prefix"]
                        }
            except Exception as e:
                # Serve from the stale table; refreshed next tick — but a
                # permanently failing refresh must not be invisible.
                logger.debug("route table refresh failed (serving stale "
                             "routes): %s", e)

    def _close_router(self):
        """Stop the refresher thread (graceful proxy shutdown — a killed
        actor process takes the daemon thread with it either way)."""
        self._router_stop.set()
        self._route_dirty.set()   # wake the 5s safety-net wait immediately
        self._refresher.join(timeout=5)


class HTTPProxy(_RouterMixin):
    """Asyncio ingress actor: thread-free in-flight waits + admission cap."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 max_inflight: int | None = None,
                 request_timeout_s: float | None = None):
        from ray_tpu_torch.core.config import runtime_config

        cfg = runtime_config()
        self._max_inflight = (max_inflight if max_inflight is not None
                              else cfg.serve_http_max_inflight)
        self._timeout = (request_timeout_s if request_timeout_s is not None
                         else cfg.serve_http_request_timeout_s)
        self._max_body = cfg.serve_http_max_body_bytes
        self._failover_attempts = max(0, cfg.serve_failover_attempts)
        self._idle_timeout = cfg.serve_http_idle_timeout_s
        self._max_conns = cfg.serve_http_max_connections
        self._conns = 0
        self._inflight = 0
        self.port: int | None = None
        self._ready = threading.Event()
        self._bind_error: BaseException | None = None
        # Submission-time pool only (route refresh, cold starts, rare
        # non-inline results) — NOT one thread per in-flight request.
        self._pool = ThreadPoolExecutor(
            max_workers=16, thread_name_prefix="serve-proxy")
        # Per-deployment single-flight for the SLOW dispatch path: a cold
        # start must occupy one pool thread, not all of them.
        self._dep_locks: dict[str, asyncio.Lock] = {}
        self._loop = asyncio.new_event_loop()
        # Router state must exist before the listener accepts anything — an
        # early connection would otherwise hit missing attributes instead
        # of a clean 404.
        self._init_router()
        self._thread = threading.Thread(
            target=self._serve, args=(host, port), daemon=True)
        self._thread.start()
        if not self._ready.wait(30):
            raise RuntimeError("ingress server failed to start within 30s")
        if self._bind_error is not None:
            raise self._bind_error

    # ------------------------------------------------------------ server

    def _serve(self, host: str, port: int):
        asyncio.set_event_loop(self._loop)

        async def _start():
            server = await asyncio.start_server(self._conn, host, port)
            self.port = server.sockets[0].getsockname()[1]
            self._ready.set()

        try:
            self._loop.run_until_complete(_start())
        except BaseException as e:  # bind failure (port in use, bad host)
            self._bind_error = e
            self._ready.set()
            return
        self._loop.run_forever()

    async def _conn(self, reader: asyncio.StreamReader,
                    writer: asyncio.StreamWriter):
        if self._conns >= self._max_conns:
            try:
                await self._send(writer, 503,
                                 b'{"error": "too many connections"}')
            except Exception:  # graftlint: disable=EXC-SWALLOW (client gone before the 503 landed)
                pass
            finally:
                writer.close()
            return
        self._conns += 1
        try:
            while True:
                try:
                    head = await asyncio.wait_for(
                        reader.readuntil(b"\r\n\r\n"),
                        timeout=self._idle_timeout)
                except (asyncio.IncompleteReadError, asyncio.TimeoutError,
                        ConnectionResetError, asyncio.LimitOverrunError):
                    return
                lines = head.decode("latin1").split("\r\n")
                parts = lines[0].split(" ")
                if len(parts) < 3:
                    return
                command, path, version = parts[0], parts[1], parts[2]
                headers: dict[str, str] = {}
                for ln in lines[1:]:
                    if ":" in ln:
                        k, v = ln.split(":", 1)
                        headers[k.strip().lower()] = v.strip()
                if "chunked" in headers.get("transfer-encoding", "").lower():
                    # Chunked bodies are not parsed; answering with a
                    # wrong-framed payload would desync the connection.
                    await self._send(writer, 501,
                                     b'{"error": "chunked body unsupported"}')
                    return
                try:
                    length = int(headers.get("content-length", 0) or 0)
                except ValueError:
                    await self._send(writer, 400,
                                     b'{"error": "bad content-length"}')
                    return
                if length > self._max_body:
                    # Refuse before buffering: admission control must also
                    # bound ingress memory.
                    await self._send(writer, 413,
                                     b'{"error": "body too large"}')
                    return
                if self._inflight >= self._max_inflight:
                    # Refuse BEFORE buffering the body: under overload the
                    # cap must bound memory, not just dispatch concurrency.
                    await self._send(writer, 503,
                                     b'{"error": "overloaded"}',
                                     extra=((b"Retry-After", b"1"),))
                    return
                try:
                    body = (await asyncio.wait_for(
                        reader.readexactly(length),
                        timeout=self._idle_timeout)
                        if length else b"")
                except (asyncio.IncompleteReadError, asyncio.TimeoutError):
                    return  # client stalled or vanished mid-body
                keep = (version == "HTTP/1.1"
                        and headers.get("connection", "").lower() != "close")
                closed = await self._respond(
                    command, path, headers, body, writer)
                if closed or not keep:
                    return
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            self._conns -= 1
            try:
                writer.close()
            except Exception:  # graftlint: disable=EXC-SWALLOW (teardown: socket may already be torn)
                pass

    async def _send(self, writer, status: int, body: bytes,
                    ctype: bytes = b"application/json",
                    extra: tuple = ()):
        head = (b"HTTP/1.1 " + str(status).encode() + b" "
                + _REASONS.get(status, b"") + b"\r\n"
                + b"Content-Type: " + ctype + b"\r\n"
                + b"Content-Length: " + str(len(body)).encode() + b"\r\n")
        for k, v in extra:
            head += k + b": " + v + b"\r\n"
        writer.write(head + b"\r\n" + body)
        await writer.drain()

    async def _respond(self, command, path, headers, body, writer) -> bool:
        """Handle one request; returns True if the connection must close.

        Every request runs under a root trace span (child of an incoming
        `traceparent` header when present). The context is ambient for the
        dispatch below, so the replica actor call — and anything it fans
        out to — joins the same trace; responses echo the trace id in
        `traceparent` / `x-ray-tpu-trace-id` headers."""
        parsed = urlparse(path)
        t_start = time.time()
        ctx = tracing.start_http_context(headers.get("traceparent"))
        token = tracing.set_current(ctx)
        trace_headers = (
            (b"traceparent", tracing.format_traceparent(ctx).encode()),
            (b"x-ray-tpu-trace-id", ctx.trace_id.encode()),
        )
        name = self._match(parsed.path)
        # Metrics label = matched deployment only: unmatched paths collapse
        # into one sentinel series, so a URL scanner can't mint unbounded
        # per-path label cardinality (the request path stays visible in the
        # span name below).
        route = name or "__unmatched__"
        # Baggage rides the carrier into every downstream hop: replicas /
        # the LLM engine tag their metrics by the ingress route.
        ctx.baggage.setdefault("route", name or parsed.path)
        status = 500
        reason = "error"
        try:
            if name is None:
                status = 404
                reason = "no_route"
                await self._send(writer, 404, b'{"error": "no route"}',
                                 extra=trace_headers)
                return False
            payload, wants_stream = _decode_payload(
                command, parsed, headers, body)
            if self._inflight >= self._max_inflight:
                # Admission control: surface overload instead of queueing
                # unboundedly (ref: http_proxy request backpressure).
                status = 503
                reason = "overloaded"
                await self._send(writer, 503, b'{"error": "overloaded"}',
                                 extra=((b"Retry-After", b"1"),)
                                 + trace_headers)
                return False
            self._inflight += 1
            try:
                handle = self._handle(name)
                shed = handle.shed_verdict()
                if shed is not None:
                    # Pinned at max + queues past the knee: shed with a
                    # typed 503 + Retry-After (an SSE request gets the
                    # typed error event in event-stream framing) instead
                    # of burning TTFT unboundedly.
                    status = 503
                    reason = "shed"
                    _REQS_SHED.inc(1.0, tags={"route": route})
                    retry = (b"Retry-After", str(max(1, round(
                        shed["retry_after_s"]))).encode())
                    if wants_stream:
                        await self._send(
                            writer, 503,
                            b"data: " + _shed_body(shed) + b"\n\n",
                            ctype=b"text/event-stream",
                            extra=(retry,) + trace_headers)
                    else:
                        await self._send(writer, 503, _shed_body(shed),
                                         extra=(retry,) + trace_headers)
                    return False
                if wants_stream and isinstance(payload, dict):
                    status = 200
                    return await self._stream_sse(
                        name, handle, payload, writer, trace_headers)
                result = await self._call_unary(name, handle, payload)
                status = 200
                await self._send(
                    writer, 200, json.dumps({"result": result}).encode(),
                    extra=trace_headers)
                return False
            except (ConnectionResetError, BrokenPipeError):
                status = 499
                reason = "client_disconnect"
                return True
            except Exception as e:  # noqa: BLE001
                status = 500
                from ray_tpu_torch.core.client import GetTimeoutError

                reason = ("timeout" if isinstance(e, GetTimeoutError)
                          else ("replica_death"
                                if failover_mode(e) == "death" else "error"))
                try:
                    await self._send(
                        writer, 500, json.dumps({"error": str(e)}).encode(),
                        extra=trace_headers)
                except Exception:  # graftlint: disable=EXC-SWALLOW (client gone before the 500 landed; original error already bound)
                    return True
                return False
            finally:
                self._inflight -= 1
        finally:
            tracing.reset_current(token)
            dur = time.time() - t_start
            _REQS_TOTAL.inc(1.0, tags={"route": route, "status": str(status)})
            if status >= 400:
                _REQS_FAILED.inc(1.0, tags={"route": route,
                                            "reason": reason})
            _REQ_LATENCY.observe(dur, tags={"route": route})
            profiling.record_event(
                f"HTTP {command} {parsed.path}", "serve", t_start, dur,
                pid=f"serve:{os.getpid()}", tid="proxy",
                args=tracing.span_event_args(ctx, route=route,
                                             status=status))

    async def _pick(self, name: str, handle, affinity_key=None):
        """Pick a replica for one request.

        Fast path (fresh route cache, live replicas): inline on the loop —
        nothing blocks. Slow path (stale cache, no replicas, cold start):
        runs on the dispatch pool under a per-deployment single-flight
        lock, so one cold deployment occupies ONE pool thread while
        requests to warm deployments keep flowing.

        The pick duration IS the request's queue wait (route refresh, cold
        start, replica selection) — observed here, once, for every path
        that dispatches."""
        t0 = time.time()
        replica = handle.try_pick_replica(affinity_key)
        if replica is None:
            lock = self._dep_locks.setdefault(name, asyncio.Lock())
            async with lock:
                # fixed by a prior waiter?
                replica = handle.try_pick_replica(affinity_key)
                if replica is None:
                    loop = asyncio.get_running_loop()
                    replica = await loop.run_in_executor(
                        self._pool,
                        lambda: handle._pick_replica(affinity_key))
        _QUEUE_WAIT.observe(time.time() - t0, tags={"route": name})
        return replica

    async def _call_unary(self, name: str, handle, payload, _hops: int = 0):
        """One request → one replica, with bounded failover: a replica
        death (ActorDiedError out of the dispatch/await) or drain
        rejection retries immediately against a re-picked replica before
        the client sees any error. The unary path delivers nothing until
        completion, so a full re-run is side-effect-safe. Prefix
        affinity steers the FIRST pick only — retries re-pick by load.

        A prefill-pool replica answers with a HANDOFF envelope instead
        of a result ({"handoff": {deployment, kv, ...}, generated_ids,
        ...}): the request continues on the decode pool with the
        already-produced tokens teacher-forced and the page-set
        descriptor attached, so the decode replica adopts the donated
        pages instead of re-prefilling. Bounded hops guard against a
        misconfigured pool ring."""
        key = handle.affinity_key(payload)
        for attempt in range(self._failover_attempts + 1):
            replica = await self._pick(name, handle, key)
            try:
                ref = handle.dispatch(replica, "__call__", (payload,), {})
                result = await self._await_ref(ref)
            except Exception as e:  # noqa: BLE001 — classified below
                mode = failover_mode(e)
                if mode is None or attempt >= self._failover_attempts:
                    raise
                # Drop the dead/draining replica from the route cache NOW
                # — the pubsub death notification / routing bump may lag
                # one pick, and a no-backoff retry that lands on the same
                # replica just burns the failover budget.
                handle.evict_replica(replica, dead=confirmed_dead(e))
                key = None
                _FAILOVERS.inc(1.0, tags={"route": name,
                                          "mode": f"unary_{mode}"})
                continue
            hand = (result.get("handoff")
                    if isinstance(result, dict) else None)
            carry: dict = {}
            peer = absorb_handoff(hand, carry)
            if peer is not None:
                if _hops >= 2:
                    # A pool ring (decode pool misconfigured as another
                    # prefill pool) must fail LOUDLY — returning the
                    # raw handoff envelope would hand the client an
                    # internal protocol record as a 200.
                    raise RuntimeError(
                        "pool handoff loop: request still migrating "
                        f"after {_hops} hops (check pool_role/"
                        "pool_peer wiring)")
                _HANDOFFS.inc(1.0, tags={"route": name})
                payload2 = dict(payload)
                payload2.update(carry)
                payload2["generated_ids"] = result.get(
                    "generated_ids") or []
                payload2["request_id"] = result.get("request_id")
                return await self._call_unary(
                    peer, self._handle(peer), payload2, _hops + 1)
            return result
        raise RuntimeError("unreachable")  # loop always returns or raises

    async def _await_ref(self, ref):
        """Thread-free wait on a result ref; falls back to a pool thread for
        non-inline (plasma/foreign) results."""
        import ray_tpu_torch
        from ray_tpu_torch import api as _api
        from ray_tpu_torch.core.client import NEEDS_BLOCKING_GET

        client = _api._ensure_client()
        val = await asyncio.wrap_future(
            client.get_future(ref, timeout=self._timeout))
        if val is NEEDS_BLOCKING_GET:
            loop = asyncio.get_running_loop()
            val = await loop.run_in_executor(
                self._pool,
                lambda: ray_tpu_torch.get(ref, timeout=self._timeout))
        return val

    async def _stream_sse(self, name, handle, payload, writer,
                          trace_headers: tuple = ()) -> bool:
        """Server-sent events: tokens flush as the replica produces them.
        Every poll wait is thread-free. Body is EOF-terminated
        (Connection: close), so no chunked framing is needed.

        The stream is pinned to one replica (cursor state lives there) —
        until that replica dies or drains. The proxy's emitted-token list
        IS the continuation record: on ActorDiedError (or a drain
        migration/rejection) the request is resubmitted to a surviving
        replica with the already-emitted tokens teacher-forced
        (`generated_ids`), the replica seeds its stream with them, and
        the proxy resumes reading at cursor = len(emitted) — so the
        client-visible stream splices cursor-exactly: no token is ever
        re-streamed or skipped, and the failover is invisible apart from
        one inter-token gap."""
        payload = {k: v for k, v in payload.items() if k != "stream"}
        emitted: list = []       # tokens already sent to the client
        attempts_left = self._failover_attempts
        hops = 0
        headers_sent = False
        replica = None
        sid = None
        # Resume context carried across resubmits (pool handoff, drain
        # migration, death failover): the donor's page-set descriptor +
        # memoized hash chain, so every destination walks the adoption
        # ladder instead of unconditionally re-prefilling.
        carry: dict = {}
        # Affinity steers the first placement only: a resume after
        # death/drain re-picks purely by load (the drain resubmit contract).
        key = handle.affinity_key(payload)

        def _absorb_handoff(out) -> str | None:
            # → destination deployment for a pool handoff, else None;
            # either way the kv descriptor/memo join the carry context
            # (absorb_handoff is THE one copy of the field transfer).
            return absorb_handoff(out.get("handoff"), carry)

        async def _failover(mode: str, victim, dead: bool = False) -> bool:
            nonlocal attempts_left, sid, key
            if attempts_left <= 0:
                return False
            attempts_left -= 1
            if victim is not None:
                # Dead OR draining: either way this replica must not be
                # re-picked by the immediate retry below. Only a
                # CONFIRMED death seeds the process-wide dead set.
                handle.evict_replica(victim, dead=dead)
            _FAILOVERS.inc(1.0, tags={"route": name,
                                      "mode": f"stream_{mode}"})
            sid = None           # re-pick + resubmit on the next loop turn
            key = None
            return True

        try:
            while True:
                try:
                    if sid is None:
                        replica = await self._pick(name, handle, key)
                        req = dict(payload)
                        req.update(carry)
                        if emitted:
                            req["generated_ids"] = list(emitted)
                        sid = await self._await_ref(handle.dispatch(
                            replica, "submit_stream", (req,), {}))
                        cursor = len(emitted)
                    out = await self._await_ref(handle.dispatch(
                        replica, "stream_read", (sid, cursor, 0.25), {}))
                except Exception as e:  # noqa: BLE001 — classified below
                    mode = failover_mode(e)
                    if mode is not None and await _failover(
                            mode, replica, confirmed_dead(e)):
                        continue
                    raise
                if not headers_sent:
                    # Headers only after a successful submit: a total
                    # failure before any byte left still gets a clean 500
                    # from _respond instead of a truncated SSE body.
                    head = (b"HTTP/1.1 200 OK\r\n"
                            b"Content-Type: text/event-stream\r\n"
                            b"Cache-Control: no-cache\r\n"
                            b"Connection: close\r\n")
                    for k, v in trace_headers:
                        head += k + b": " + v + b"\r\n"
                    writer.write(head + b"\r\n")
                    headers_sent = True
                for tok in out["tokens"]:
                    writer.write(
                        b"data: " + json.dumps({"token": tok}).encode()
                        + b"\n\n")
                if out["tokens"]:
                    await writer.drain()
                    emitted.extend(out["tokens"])
                    cursor += len(out["tokens"])
                err = out.get("error")
                if err:
                    # A stream record lost before completion (replica
                    # restarted between polls, drain raced the submit) is
                    # still resumable from the proxy's emitted record.
                    if ("unknown stream" in err
                            and await _failover("death", replica)):
                        continue
                    # Streamed failures bypass the HTTP status (headers
                    # already said 200) — count them here or the failed-
                    # requests counter is blind to every SSE error.
                    _REQS_FAILED.inc(1.0, tags={"route": name,
                                                "reason": "stream_error"})
                    writer.write(
                        b"data: " + json.dumps({"error": err}).encode()
                        + b"\n\n")
                    break
                if out.get("done"):
                    if out.get("migrated"):
                        peer = _absorb_handoff(out)
                        if peer is not None:
                            if hops >= 4:
                                # Pool ring: fail with the TYPED loop
                                # error (like the unary paths) instead
                                # of mislabeling it drain failover —
                                # that would evict healthy replicas and
                                # burn the budget chasing the ring.
                                _REQS_FAILED.inc(1.0, tags={
                                    "route": name,
                                    "reason": "handoff_loop"})
                                writer.write(b"data: " + json.dumps(
                                    {"error": "pool handoff loop: "
                                     "stream still migrating after "
                                     f"{hops} hops (check pool_role/"
                                     "pool_peer wiring)"}).encode()
                                    + b"\n\n")
                                break
                            # Pool handoff (prefill → decode): the
                            # NORMAL path of a split deployment — switch
                            # to the decode pool's handle, no failover
                            # budget spent.
                            hops += 1
                            handle = self._handle(peer)
                            sid = None
                            key = None
                            _HANDOFFS.inc(1.0, tags={"route": name})
                            continue
                        # Drain export: this replica's leg ended with the
                        # request unfinished — resume elsewhere.
                        if await _failover("drain", replica):
                            continue
                        _REQS_FAILED.inc(1.0, tags={
                            "route": name,
                            "reason": "failover_exhausted"})
                        writer.write(b"data: " + json.dumps(
                            {"error": "replica drained; failover budget "
                                      "exhausted"}).encode() + b"\n\n")
                        break
                    writer.write(b"data: [DONE]\n\n")
                    break
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            pass  # client went away mid-stream
        except Exception as e:  # noqa: BLE001 — if headers are out,
            # surface the failure as an SSE error event, never as HTTP
            # bytes injected into the open stream.
            if not headers_sent:
                raise  # _respond turns this into a clean HTTP 500
            _REQS_FAILED.inc(1.0, tags={"route": name,
                                        "reason": "stream_error"})
            try:
                writer.write(b"data: " + json.dumps(
                    {"error": str(e)}).encode() + b"\n\n")
                await writer.drain()
            except Exception:  # graftlint: disable=EXC-SWALLOW (client gone mid-stream; error already surfaced as SSE event)
                pass
        return True

    # ------------------------------------------------------------ actor API

    def get_port(self) -> int:
        return self.port

    def health(self) -> bool:
        return True

    def close(self) -> None:
        """Graceful stop: refresher joined, event loop stopped, server
        thread joined, submission pool drained. Idempotent."""
        self._close_router()
        if self._thread.is_alive():
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=10)
        self._pool.shutdown(wait=False)


class ThreadedHTTPProxy(_RouterMixin):
    """v1 ingress (stdlib ThreadingHTTPServer): one thread per in-flight
    request. Kept as the baseline for the ingress benchmark."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        proxy = self
        self._init_router()

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"   # keep-alive, like the async proxy

            def log_message(self, *a):  # quiet
                pass

            def _json_reply(self, code: int, body: bytes,
                            headers: tuple = ()):
                # HTTP/1.1 keep-alive: the body MUST be delimited by
                # Content-Length or the client blocks waiting for EOF.
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _dispatch(self):
                parsed = urlparse(self.path)
                # Drain the body FIRST: under keep-alive an unread body
                # desyncs the connection for the next pipelined request.
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    if length < 0:  # read(-N) would block until EOF
                        raise ValueError(length)
                except ValueError:
                    self.close_connection = True  # can't locate body end
                    self._json_reply(400, b'{"error": "bad content-length"}')
                    return
                raw = self.rfile.read(length) if length else b""
                name = proxy._match(parsed.path)
                if name is None:
                    _REQS_FAILED.inc(1.0, tags={"route": "__unmatched__",
                                                "reason": "no_route"})
                    self._json_reply(404, b'{"error": "no route"}')
                    return
                payload, wants_stream = _decode_payload(
                    self.command, parsed,
                    {"accept": self.headers.get("Accept", "")}, raw)
                try:
                    handle = proxy._handle(name)
                    import ray_tpu_torch
                    from ray_tpu_torch.core.config import runtime_config

                    shed = handle.shed_verdict()
                    if shed is not None:
                        # Sync mirror of the async proxy's shed path
                        # (typed 503 + Retry-After; the async proxy owns
                        # the canonical semantics — keep in sync). An
                        # SSE request gets the typed error event in
                        # event-stream framing + Connection: close — a
                        # JSON body on a keep-alive socket would leave
                        # an SSE consumer waiting for frames/EOF until
                        # its own timeout.
                        _REQS_SHED.inc(1.0, tags={"route": name})
                        _REQS_FAILED.inc(1.0, tags={"route": name,
                                                    "reason": "shed"})
                        retry = str(max(1, round(shed["retry_after_s"])))
                        if wants_stream:
                            body = b"data: " + _shed_body(shed) + b"\n\n"
                            self.close_connection = True
                            self.send_response(503)
                            self.send_header("Content-Type",
                                             "text/event-stream")
                            self.send_header("Retry-After", retry)
                            self.send_header("Connection", "close")
                            self.end_headers()
                            self.wfile.write(body)
                        else:
                            self._json_reply(
                                503, _shed_body(shed),
                                headers=(("Retry-After", retry),))
                        return
                    if wants_stream and isinstance(payload, dict):
                        # handle.stream resumes across replica death /
                        # drain internally (cursor-exact splice).
                        self._stream_sse(handle, payload)
                        return
                    # Unary failover: a replica death or drain rejection
                    # retries against a re-picked replica before any 500.
                    # Sync mirror of HTTPProxy._call_unary (the async
                    # proxy owns the canonical semantics — keep in sync).
                    attempts = max(
                        0, runtime_config().serve_failover_attempts)
                    key = handle.affinity_key(payload)
                    hops = 0
                    attempt = 0
                    while True:
                        replica = handle._pick_replica(key)
                        try:
                            result = ray_tpu_torch.get(
                                handle.dispatch(
                                    replica, "__call__", (payload,), {}),
                                timeout=120)
                        except Exception as e:  # noqa: BLE001
                            mode = failover_mode(e)
                            if mode is None or attempt >= attempts:
                                raise
                            attempt += 1
                            handle.evict_replica(
                                replica, dead=confirmed_dead(e))
                            key = None
                            _FAILOVERS.inc(1.0, tags={
                                "route": name, "mode": f"unary_{mode}"})
                            continue
                        # Pool handoff envelope: continue on the decode
                        # pool (sync mirror of HTTPProxy._call_unary —
                        # the async proxy owns the canonical semantics).
                        hand = (result.get("handoff")
                                if isinstance(result, dict) else None)
                        hcarry: dict = {}
                        peer = absorb_handoff(hand, hcarry)
                        if peer is not None:
                            if hops >= 2:
                                raise RuntimeError(
                                    "pool handoff loop: request still "
                                    f"migrating after {hops} hops "
                                    "(check pool_role/pool_peer "
                                    "wiring)")
                            hops += 1
                            _HANDOFFS.inc(1.0, tags={"route": name})
                            payload = dict(payload)
                            payload.update(hcarry)
                            payload["generated_ids"] = result.get(
                                "generated_ids") or []
                            payload["request_id"] = result.get(
                                "request_id")
                            handle = proxy._handle(peer)
                            key = None
                            continue
                        break
                    self._json_reply(
                        200, json.dumps({"result": result}).encode())
                except Exception as e:
                    _REQS_FAILED.inc(1.0, tags={
                        "route": name,
                        "reason": ("replica_death"
                                   if failover_mode(e) == "death"
                                   else "error")})
                    self._json_reply(
                        500, json.dumps({"error": str(e)}).encode())

            def _stream_sse(self, handle, payload):
                payload = {k: v for k, v in payload.items() if k != "stream"}
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.end_headers()
                try:
                    for tok in handle.stream(payload):
                        self.wfile.write(
                            b"data: " + json.dumps({"token": tok}).encode()
                            + b"\n\n")
                        self.wfile.flush()
                    self.wfile.write(b"data: [DONE]\n\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    pass  # client went away mid-stream
                except Exception as e:
                    _REQS_FAILED.inc(1.0, tags={
                        "route": handle.deployment_name,
                        "reason": "stream_error"})
                    try:
                        self.wfile.write(
                            b"data: " + json.dumps(
                                {"error": str(e)}).encode() + b"\n\n")
                        self.wfile.flush()
                    except OSError:
                        pass

            do_GET = _dispatch
            do_POST = _dispatch

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    def get_port(self) -> int:
        return self.port

    def health(self) -> bool:
        return True

    def close(self) -> None:
        self._close_router()
        self._server.shutdown()      # serve_forever returns
        self._thread.join(timeout=10)
        self._server.server_close()


def start_proxy(port: int = 0, impl: str = "async"):
    """Start (or fetch) the singleton proxy actor; returns (handle, port)."""
    import ray_tpu_torch

    cls = HTTPProxy if impl == "async" else ThreadedHTTPProxy
    proxy = ray_tpu_torch.remote(cls).options(
        name=f"ray_tpu_serve_proxy_{impl}", get_if_exists=True,
        max_concurrency=32,
    ).remote(port=port)
    actual = ray_tpu_torch.get(proxy.get_port.remote(), timeout=60)
    return proxy, actual


def start_proxies(port: int = 0, host: str = "0.0.0.0"):
    """One ingress proxy per alive node (the reference's per-node
    HTTPProxyActor layout, http_proxy.py:386). Binds every interface by
    default so remote clients can reach each node's ingress. Returns
    {node_id: (handle, (node_ip, port))}."""
    import ray_tpu_torch
    from ray_tpu_torch.utils.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    out = {}
    for n in ray_tpu_torch.nodes():
        if not n["Alive"]:
            continue
        nid = n["NodeID"]
        proxy = ray_tpu_torch.remote(HTTPProxy).options(
            name=f"ray_tpu_serve_proxy_{nid[:12]}", get_if_exists=True,
            max_concurrency=32,
            scheduling_strategy=NodeAffinitySchedulingStrategy(node_id=nid),
        ).remote(host=host, port=port)
        bound = ray_tpu_torch.get(proxy.get_port.remote(), timeout=60)
        node_ip = (n.get("Address") or ("127.0.0.1",))[0]
        out[nid] = (proxy, (node_ip, bound))
    return out
