"""Minimal asyncio RPC: length-prefixed pickled frames over TCP.

Fills the role of the reference's gRPC scaffolding (`src/ray/
rpc/grpc_server.h`, `rpc/client_call.h`) for the host-side control plane.
Data-plane transfers (object chunks) ride the same transport with chunking at
a higher layer. Design goals: zero extra dependencies, reconnecting clients,
bidirectional push (server→client notifications) for pubsub.

Frame format: [u32 length][pickled (kind, seq, method, payload)]
  kind: 0=request, 1=response, 2=error, 3=notify (one-way, either direction)
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import pickle
import struct
from typing import Any, Awaitable, Callable

import cloudpickle

logger = logging.getLogger(__name__)

REQUEST, RESPONSE, ERROR, NOTIFY = 0, 1, 2, 3
_HDR = struct.Struct("<I")
MAX_FRAME = 1 << 31


class RpcError(Exception):
    pass


class ConnectionLost(RpcError):
    pass


async def _read_frame(reader: asyncio.StreamReader) -> Any:
    try:
        hdr = await reader.readexactly(_HDR.size)
    except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError):
        raise ConnectionLost()
    (length,) = _HDR.unpack(hdr)
    if length > MAX_FRAME:
        raise RpcError(f"frame too large: {length}")
    try:
        body = await reader.readexactly(length)
    except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError):
        raise ConnectionLost()
    return pickle.loads(body)


def _write_frame(writer: asyncio.StreamWriter, msg: Any) -> None:
    body = cloudpickle.dumps(msg)
    writer.write(_HDR.pack(len(body)) + body)


class Connection:
    """One live duplex connection. Used by both server (per-peer) and client."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self._seq = itertools.count(1)
        self._pending: dict[int, asyncio.Future] = {}
        self._notify_handler: Callable[[str, Any], None] | None = None
        self._request_handler: (
            Callable[[str, Any], Awaitable[Any]] | None
        ) = None
        self._closed = asyncio.Event()
        self._task: asyncio.Task | None = None
        # In-flight request handlers need strong refs: asyncio tracks tasks
        # weakly, and a GC'd pending handler never sends its reply.
        self._handler_tasks: set = set()
        self.peername = writer.get_extra_info("peername")

    def start(self):
        self._task = asyncio.ensure_future(self._read_loop())

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    async def _read_loop(self):
        try:
            while True:
                msg = await _read_frame(self.reader)
                kind, seq, method, payload = msg
                if kind == RESPONSE or kind == ERROR:
                    fut = self._pending.pop(seq, None)
                    if fut is not None and not fut.done():
                        if kind == RESPONSE:
                            fut.set_result(payload)
                        else:
                            fut.set_exception(
                                payload
                                if isinstance(payload, BaseException)
                                else RpcError(str(payload))
                            )
                elif kind == NOTIFY:
                    if self._notify_handler is not None:
                        try:
                            self._notify_handler(method, payload)
                        except Exception:
                            logger.exception("notify handler failed: %s", method)
                elif kind == REQUEST:
                    t = asyncio.ensure_future(
                        self._serve_one(seq, method, payload))
                    self._handler_tasks.add(t)
                    t.add_done_callback(self._handler_tasks.discard)
        except (ConnectionLost, asyncio.CancelledError):
            pass
        except Exception:
            logger.exception("rpc read loop crashed")
        finally:
            self._closed.set()
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionLost())
            self._pending.clear()
            try:
                self.writer.close()
            except Exception:  # graftlint: disable=EXC-SWALLOW (teardown: transport may already be torn)
                pass

    async def _serve_one(self, seq: int, method: str, payload: Any):
        try:
            assert self._request_handler is not None, f"no handler for {method}"
            result = await self._request_handler(method, payload)
            if not self.closed:
                _write_frame(self.writer, (RESPONSE, seq, method, result))
        except Exception as e:
            if not self.closed:
                try:
                    _write_frame(self.writer, (ERROR, seq, method, e))
                except Exception:  # graftlint: disable=EXC-SWALLOW (unpicklable error degrades to repr, not lost)
                    _write_frame(
                        self.writer, (ERROR, seq, method, RpcError(repr(e)))
                    )
        if not self.closed:
            try:
                await self.writer.drain()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def call(self, method: str, payload: Any = None, timeout: float | None = None) -> Any:
        if self.closed:
            raise ConnectionLost(f"connection to {self.peername} closed")
        seq = next(self._seq)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[seq] = fut
        _write_frame(self.writer, (REQUEST, seq, method, payload))
        await self.writer.drain()
        if timeout is None:
            return await fut
        return await asyncio.wait_for(fut, timeout)

    def notify(self, method: str, payload: Any = None) -> None:
        if self.closed:
            return
        _write_frame(self.writer, (NOTIFY, 0, method, payload))

    async def close(self):
        if self._task is not None:
            self._task.cancel()
        try:
            self.writer.close()
            await self.writer.wait_closed()
        except Exception:  # graftlint: disable=EXC-SWALLOW (teardown: transport may already be torn)
            pass


class Server:
    """RPC server. Handlers: async def handler(conn, payload) registered by
    method name. Unknown methods error back to the caller."""

    MAX_DEDUPE = 20_000

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self._handlers: dict[str, Callable[[Connection, Any], Awaitable[Any]]] = {}
        self._server: asyncio.AbstractServer | None = None
        self.connections: set[Connection] = set()
        self._reap_tasks: set = set()   # strong refs (weak task registry)
        self._on_disconnect: Callable[[Connection], None] | None = None
        # Request-id → result cache: a ReconnectingConnection retrying
        # through a redial cannot know whether its first attempt executed, so
        # it tags dict payloads with "_rid"; replays return the cached result
        # instead of re-running non-idempotent mutations (at-most-once).
        self._dedupe: dict[bytes, Any] = {}
        # Idempotent / heavy-read methods skip result caching.
        self.dedupe_exempt: set[str] = {
            "heartbeat", "get_cluster_view", "kv_get", "kv_keys", "obj_loc_get",
            "store_get", "store_contains", "obj_read_chunk", "obj_info",
            "profile_get", "profile_stats", "profile_traces", "metrics_get",
            "ref_update",
            "ref_register_holder",
            "ref_revive",
            "subscribe", "get_actor", "list_actors", "pg_get", "pg_list",
        }

    def handler(self, name: str):
        def deco(fn):
            self._handlers[name] = fn
            return fn

        return deco

    def register(self, name: str, fn) -> None:
        self._handlers[name] = fn

    def on_disconnect(self, fn: Callable[[Connection], None]) -> None:
        self._on_disconnect = fn

    async def start(self) -> tuple[str, int]:
        self._server = await asyncio.start_server(
            self._accept, self.host, self.port
        )
        sock = self._server.sockets[0]
        self.host, self.port = sock.getsockname()[:2]
        return self.host, self.port

    async def _accept(self, reader, writer):
        conn = Connection(reader, writer)
        self.connections.add(conn)

        async def dispatch(method: str, payload: Any):
            fn = self._handlers.get(method)
            if fn is None:
                raise RpcError(f"unknown method {method!r}")
            rid = payload.pop("_rid", None) if isinstance(payload, dict) else None
            if rid is None or method in self.dedupe_exempt:
                return await fn(conn, payload)
            if rid in self._dedupe:
                return self._dedupe[rid]
            result = await fn(conn, payload)
            self._dedupe[rid] = result
            while len(self._dedupe) > self.MAX_DEDUPE:
                self._dedupe.pop(next(iter(self._dedupe)))
            return result

        conn._request_handler = dispatch
        conn.start()
        t = asyncio.ensure_future(self._reap(conn))
        self._reap_tasks.add(t)
        t.add_done_callback(self._reap_tasks.discard)

    async def _reap(self, conn: Connection):
        await conn._closed.wait()
        self.connections.discard(conn)
        if self._on_disconnect is not None:
            try:
                self._on_disconnect(conn)
            except Exception:
                logger.exception("on_disconnect failed")

    async def stop(self):
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        for conn in list(self.connections):
            await conn.close()


class ReconnectingConnection:
    """Connection facade that redials on loss (GCS failover support).

    Parity: the reference's GCS clients reconnect within
    `gcs_failover_worker_reconnect_timeout` (`ray_config_def.h:70`,
    `gcs_client_reconnection_test.cc`). `call()` retries across redials
    until `reconnect_window_s` elapses; `on_reconnect` runs after each
    successful redial (re-register, re-subscribe, re-announce)."""

    def __init__(self, host: str, port: int, *,
                 dial_timeout: float = 10.0,
                 reconnect_window_s: float = 60.0,
                 notify_handler=None, request_handler=None,
                 on_reconnect=None):
        self.addr = (host, port)
        self.dial_timeout = dial_timeout
        self.reconnect_window_s = reconnect_window_s
        self._notify_handler = notify_handler
        self._request_handler = request_handler
        self._on_reconnect = on_reconnect
        self._conn: Connection | None = None
        self._lock = asyncio.Lock()
        self._closed = False
        self._ever_connected = False

    @property
    def closed(self) -> bool:
        return self._closed

    async def _ensure(self) -> Connection:
        if self._conn is not None and not self._conn.closed:
            return self._conn
        async with self._lock:
            if self._conn is not None and not self._conn.closed:
                return self._conn
            if self._closed:
                raise ConnectionLost("connection explicitly closed")
            conn = await connect(
                *self.addr, timeout=self.dial_timeout,
                notify_handler=self._notify_handler,
                request_handler=self._request_handler,
            )
            self._conn = conn
            if self._ever_connected and self._on_reconnect is not None:
                await self._on_reconnect(conn)
            self._ever_connected = True
            return conn

    async def call(self, method: str, payload: Any = None,
                   timeout: float | None = None) -> Any:
        deadline = (asyncio.get_running_loop().time()
                    + self.reconnect_window_s)
        # Tag the request so a retry through a redial is deduplicated server-
        # side: the first attempt may have executed before the drop, and
        # GCS mutations (next_job_id, register_actor, …) are not idempotent.
        if isinstance(payload, dict) and "_rid" not in payload:
            import os as _os

            payload = {**payload, "_rid": _os.urandom(12)}
        while True:
            try:
                conn = await self._ensure()
                return await conn.call(method, payload, timeout=timeout)
            except ConnectionLost:
                if (self._closed
                        or asyncio.get_running_loop().time() > deadline):
                    raise
                await asyncio.sleep(0.2)

    def notify(self, method: str, payload: Any = None) -> None:
        if self._conn is not None and not self._conn.closed:
            self._conn.notify(method, payload)

    async def close(self):
        self._closed = True
        if self._conn is not None:
            await self._conn.close()


async def connect(
    host: str,
    port: int,
    *,
    timeout: float = 10.0,
    retry_interval: float = 0.1,
    notify_handler: Callable[[str, Any], None] | None = None,
    request_handler: Callable[[str, Any], Awaitable[Any]] | None = None,
) -> Connection:
    """Dial with retries (the peer may still be starting up)."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    last_err: Exception | None = None
    while loop.time() < deadline:
        try:
            reader, writer = await asyncio.open_connection(host, port)
            conn = Connection(reader, writer)
            conn._notify_handler = notify_handler
            if request_handler is not None:
                conn._request_handler = request_handler
            conn.start()
            return conn
        except (ConnectionRefusedError, OSError) as e:
            last_err = e
            await asyncio.sleep(retry_interval)
    raise ConnectionLost(f"could not connect to {host}:{port}: {last_err}")
