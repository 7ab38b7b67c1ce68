"""CoreClient: the submit-side runtime embedded in drivers and workers.

Parity with the reference's CoreWorker submit path (`src/ray/
core_worker/core_worker.cc` SubmitTask/CreateActor/SubmitActorTask +
`direct_task_transport.cc`): lease-based scheduling with spillback, direct
push to leased workers, per-actor ordered pipelines, retries on worker death,
and object put/get/wait against the node store.

Threading: one background asyncio loop; the public API is synchronous and
thread-safe (calls are marshalled with run_coroutine_threadsafe).
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os
import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import Any, Sequence

from ray_tpu_torch import tracing
from ray_tpu_torch.core import rpc, serialization
from ray_tpu_torch.core.config import Config
from ray_tpu_torch.core.ids import ActorID, JobID, ObjectID, TaskID, WorkerID
from ray_tpu_torch.core.object_store import attach_extent
from ray_tpu_torch.core.task_spec import (
    ACTOR_CREATION,
    ACTOR_TASK,
    NORMAL_TASK,
    ArgSpec,
    TaskSpec,
)

logger = logging.getLogger(__name__)

# get_future() resolution for results that are not inline in the memory
# store: the caller must fall back to a blocking get() off the loop.
NEEDS_BLOCKING_GET = object()



def _release_views(entry: tuple) -> bool:
    """Release a got value's extent view, unless a live value still reads
    it (an array built on an out-of-band buffer holds an export of that
    buffer's `serialization.BufferExporter`; views sliced from the
    extent are not exports of it, so the extent's own ``release()``
    cannot tell). False while read: the extent stays pinned."""
    view, exporters = entry
    if any(e.exports for e in exporters):
        return False
    try:
        view.release()
    except BufferError:
        return False
    return True

class GetTimeoutError(TimeoutError):
    pass


class _PlacementRetry(Exception):
    """Placement attempt failed but the actor remains RESTARTING."""


def __getattr__(name):
    # Back-compat import path: the canonical ActorDiedError moved to
    # api.py (it subclasses RayTaskError so typed actor-death results
    # from to_exception() stay catchable by broad RayTaskError handlers).
    # Lazy to avoid an api<->client import cycle at module init.
    if name == "ActorDiedError":
        from ray_tpu_torch.api import ActorDiedError

        return ActorDiedError
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class _PendingTask:
    """A queued normal task awaiting a lease lane."""

    __slots__ = ("spec", "done", "attempts", "key", "state", "worker_conn",
                 "canceled")

    def __init__(self, spec, done, attempts):
        self.spec = spec
        self.done = done
        self.attempts = attempts
        self.key = None
        self.state = "queued"          # queued | running | done
        self.worker_conn = None
        self.canceled = False


class ActorState:
    def __init__(self, actor_id: bytes):
        self.actor_id = actor_id
        self.address: tuple[str, int] | None = None
        self.conn: rpc.Connection | None = None
        self.seq = itertools.count()
        self.dead = False
        self.death_cause: str | None = None
        self.resources: dict[str, float] = {}
        self.ready = asyncio.Event()   # set when ALIVE (or DEAD — check .dead)
        self.restarting = False
        self._restart_driver = None
        # Refs riding the creation spec: held until the actor is DEAD (the
        # spec is replayed on restart, so its args must stay resolvable).
        self.creation_escrow: list[bytes] = []
        # First return id of the creation task — keys the unflushed-acquire
        # deferral when the escrow is finally released.
        self.creation_return_id: bytes | None = None
        # Submissions made on the client's loop whose argument holds are
        # still being published: the last link of their chain (None, or
        # a task that spawns its dispatch once the holds reached the GCS).
        self.submit_tail: asyncio.Future | None = None


def _env_lease_fields(spec) -> dict:
    """Lease-request fields for a spec's pip runtime env: the raylet keys
    its worker pool by env digest and builds the venv from the recipe."""
    pe = (spec.runtime_env or {}).get("pip_env") if spec.runtime_env else None
    if pe:
        return {"runtime_env_key": pe["digest"], "pip_env": pe}
    return {}


class CoreClient:
    def __init__(
        self,
        gcs_address: tuple[str, int],
        raylet_address: tuple[str, int],
        config: Config | None = None,
        job_id: bytes | None = None,
    ):
        self.config = config or Config.from_env()
        self.gcs_address = gcs_address
        self.raylet_address = raylet_address
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever, name="ray_tpu_torch-client", daemon=True
        )
        self._thread.start()
        # set before the GCS connection exists: _notify may fire immediately
        self._channel_subs: dict[str, list] = {}
        self.gcs: rpc.ReconnectingConnection = self._run(
            self._connect_gcs(gcs_address))
        self.raylet: rpc.Connection = self._run(self._connect(raylet_address))
        if job_id is None:
            job_id = self._run(self.gcs.call("next_job_id", {}))
        self.job_id = job_id
        self.task_id_root = TaskID.for_task(JobID(job_id))
        self._put_counter = itertools.count(1)
        self._memory_store: dict[bytes, Any] = {}
        # oid → (the extent view, the BufferExporters a got value reads
        # it through); see _release_views.
        self._mmaps: dict[bytes, tuple] = {}
        # Writes hold _actors_lock: actor_state()'s get-or-create runs on
        # arbitrary submitter threads, and two racing calls for the same id
        # would each install a distinct ActorState (split ready-events).
        self._actors: dict[bytes, ActorState] = {}
        self._actors_lock = threading.Lock()
        self._worker_conns: dict[tuple[str, int], rpc.Connection] = {}
        self._raylet_conns: dict[tuple[str, int], rpc.Connection] = {}
        self._result_events: dict[bytes, threading.Event] = {}
        self._bg_tasks: set = set()   # strong refs, see _spawn_bg
        # asyncio twins of _result_events, used for dependency resolution:
        # a task whose ref args are still being produced BY THIS CLIENT is
        # not enqueued until they land (ref: dependency_resolver.cc) — else
        # bounded worker pools deadlock with consumers blocking on
        # producers that can't get a worker.
        self._return_ready: dict[bytes, asyncio.Event] = {}
        # Lineage (ref: object_recovery_manager.h:41, task_manager.h:86
        # lineage pinning): return id → the TaskSpec that creates it, kept
        # while this process holds a reference, so lost objects can be
        # rebuilt by re-executing their creating task (transitively).
        self._lineage: dict[bytes, TaskSpec] = {}
        self._lineage_lock = threading.Lock()
        self._lineage_budget: dict[bytes, int] = {}      # task_id → retries
        # oid → number of pinned specs consuming it as an argument: keeps an
        # upstream object's lineage alive while downstream lineage needs it
        # (ref: reference_count.h lineage refs).
        self._lineage_deps: dict[bytes, int] = {}
        self._recoveries: dict[bytes, asyncio.Future] = {}  # task_id → done
        # Per-scheduling-key task queues + lease lanes (ref: the submitter's
        # per-SchedulingKey pipeline, direct_task_transport.cc:108-220): one
        # granted lease executes queued same-shape tasks back-to-back, so the
        # lease/release round trip amortizes across a burst instead of
        # costing two raylet RPCs per task.
        self._pending_by_key: dict[tuple, Any] = {}
        self._lanes: dict[tuple, int] = {}
        self._idle_lanes: dict[tuple, int] = {}
        self._key_events: dict[tuple, asyncio.Event] = {}
        # first-return-id → pending record, for ray_tpu_torch.cancel
        self._task_index: dict[bytes, Any] = {}
        # first-return-id → (worker holder_id, acquires the worker could not
        # flush before replying): escrow decrefs for those ids wait until the
        # worker's holder registration is visible in the GCS (release must
        # never overtake acquire, even across a GCS outage).
        self._unflushed_replies: dict[bytes, tuple[bytes, set[bytes]]] = {}
        self._closed = False
        # Distributed ref counting (ref: reference_count.h:61): exact local
        # counts here, batched process-level holds to the GCS.
        from ray_tpu_torch.core.refcount import ReferenceCounter

        self.refcounter = ReferenceCounter(self)
        self._run(self.gcs.call("subscribe", {"channels": ["actor"]}))
        # Drivers (not workers) print streamed task/actor output
        # (ref: worker.py:1672 print_logs — the "(worker ...)" lines).
        if (self.config.log_to_driver
                and not os.environ.get("RAY_TPU_TORCH_WORKER_ID")):
            self.subscribe_channel("logs", self._print_worker_logs)
        if self.config.ref_counting_enabled:
            self._run(self.gcs.call("ref_register_holder", {
                "holder_id": self.refcounter.holder_id, "held": [],
            }))
            self._run(self._start_ref_flusher())
        else:
            self.refcounter._closed = True
        # Drivers ship their profiling spans/metrics to the GCS themselves
        # (a root span recorded with tracing.start_span would otherwise be
        # visible only in this process and every remote reader would see an
        # orphaned trace). Worker processes already run the worker-side
        # flush loop (core/worker.py) over the same buffer — skip there.
        if not os.environ.get("RAY_TPU_TORCH_WORKER_ID"):
            self._spawn_bg(self._obs_flush_loop())

    async def _start_ref_flusher(self):
        self.refcounter.start(self.config.ref_flush_interval_s)

    async def _obs_flush_loop(self) -> None:
        """Driver-side observability flush (shared loop body in
        profiling.run_obs_flush_loop): ships this process's profiling
        spans and metric snapshots to the GCS so driver-rooted traces and
        driver-recorded metrics are visible to every reader, not just
        local ones. The source carries a session nonce — PIDs collide
        across hosts and driver restarts, and the GCS seq dedupe keyed on
        a reused source would silently discard the newcomer's batches."""
        import uuid

        from ray_tpu_torch import profiling

        await profiling.run_obs_flush_loop(
            f"client:{os.getpid()}:{uuid.uuid4().hex[:8]}",
            lambda method, p: self.gcs.call(
                method, p, timeout=self.config.rpc_default_timeout_s),
            self.config.worker_profile_flush_interval_s,
            lambda: self._closed)

    # ------------------------------------------------------------ plumbing

    async def _connect(self, addr) -> rpc.Connection:
        return await rpc.connect(
            *addr,
            timeout=self.config.rpc_connect_timeout_s,
            notify_handler=self._notify,
        )

    async def _connect_gcs(self, addr) -> rpc.ReconnectingConnection:
        async def on_reconnect(conn):
            channels = ["actor", *self._channel_subs]
            await conn.call("subscribe", {"channels": channels})
            # GCS failover: ref tables are runtime state, rebuilt by holders
            # re-announcing everything — holds, owned ids, containment.
            if self.config.ref_counting_enabled and hasattr(self, "refcounter"):
                await conn.call("ref_register_holder",
                                self.refcounter.registration_payload())

        conn = rpc.ReconnectingConnection(
            *addr,
            dial_timeout=self.config.rpc_connect_timeout_s,
            reconnect_window_s=self.config.gcs_reconnect_window_s,
            notify_handler=self._notify,
            on_reconnect=on_reconnect,
        )
        await conn._ensure()
        return conn

    @staticmethod
    def _print_worker_logs(payload) -> None:
        import sys

        prefix = f"({payload['worker'][:8]}, node={payload['node']})"
        for line in payload.get("lines", ()):
            print(f"{prefix} {line}", file=sys.stderr)

    def subscribe_channel(self, channel: str, callback) -> None:
        """Register a pubsub callback for `pub:<channel>` notifies from the
        GCS (long-poll fan-out parity). Callbacks run on the client loop —
        keep them non-blocking."""
        self._channel_subs.setdefault(channel, []).append(callback)
        self._run(self.gcs.call("subscribe", {"channels": [channel]}))

    def publish(self, channel: str, message: Any) -> None:
        self._run(self.gcs.call("publish", {
            "channel": channel, "message": message,
        }), timeout=30)

    def _notify(self, method: str, payload: Any) -> None:
        if method.startswith("pub:"):
            for cb in self._channel_subs.get(method[4:], ()):
                try:
                    cb(payload)
                except Exception:
                    logger.exception("pubsub callback failed")
        if method == "objects_freed":
            # The GCS freed these owned objects cluster-wide: no holder
            # remains anywhere, so their lineage pins can finally drop.
            for oid in payload["object_ids"]:
                self.refcounter.forget_contains(oid)
                self._maybe_evict_lineage(oid)
            return
        if method == "recover_objects":
            # A borrower somewhere failed to pull an object we own: rebuild
            # it (lineage re-execution or owner re-put).
            if self.config.lineage_reconstruction_enabled and not self._closed:
                self._ensure_bg(
                    self._recover_missing(payload["object_ids"]))
            return
        if method == "pub:actor":
            st = self._actors.get(payload["actor_id"])
            if st is None:
                return
            state = payload.get("state")
            if state == "ALIVE":
                st.address = tuple(payload["address"])
                st.restarting = False
                st.ready.set()
            elif state == "RESTARTING":
                st.restarting = True
                st.address = None
                st.conn = None
                st.ready.clear()
            elif state == "DEAD":
                st.dead = True
                st.death_cause = payload.get("cause")
                self._release_creation_escrow(st)
                st.ready.set()

    def _run(self, coro, timeout=None):
        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        return fut.result(timeout)

    # Background coroutines MUST be strongly referenced until done: asyncio
    # tracks tasks weakly, and a pending task with no external reference
    # can be garbage-collected mid-flight — its finally blocks run
    # (GeneratorExit) but no result/failure is recorded, turning a dropped
    # dispatch into a silent caller-side get() hang (observed ~1/600 under
    # load). _spawn_bg marshals from any thread; _ensure_bg is loop-side.

    def _spawn_bg(self, coro):
        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        self._bg_tasks.add(fut)
        fut.add_done_callback(self._bg_tasks.discard)
        return fut

    def _ensure_bg(self, coro):
        t = asyncio.ensure_future(coro)
        self._bg_tasks.add(t)
        t.add_done_callback(self._bg_tasks.discard)
        return t

    def shutdown(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.refcounter.close()
        for entry in self._mmaps.values():
            _release_views(entry)
        async def _close_all():
            conns = [self.gcs, self.raylet,
                     *self._worker_conns.values(),
                     *self._raylet_conns.values()]
            for c in conns:
                try:
                    await c.close()
                except Exception:  # graftlint: disable=EXC-SWALLOW (shutdown: peers may already be gone)
                    pass
            # Retire cancelled read-loop tasks before the loop stops, else
            # interpreter exit logs "Task was destroyed but it is pending".
            tasks = [t for t in asyncio.all_tasks()
                     if t is not asyncio.current_task()]
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

        try:
            self._run(_close_all(), timeout=3)
        except Exception:  # graftlint: disable=EXC-SWALLOW (shutdown: bounded best-effort drain)
            pass
        try:
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=2)
        except Exception:  # graftlint: disable=EXC-SWALLOW (shutdown: loop may already be stopped)
            pass

    # ------------------------------------------------------------ objects

    def _on_local_release(self, oid: bytes) -> None:
        """This process's last ObjectRef to `oid` died: evict the value cache,
        release the zero-copy view, and drop the raylet-side reader pin.
        Called from arbitrary threads (GC); must not block."""
        self._memory_store.pop(oid, None)
        self._result_events.pop(oid, None)
        # NOTE: lineage is NOT evicted here — remote borrowers may still
        # hold the object (only this process's refs died). Lineage drops
        # when the GCS frees the object cluster-wide ("objects_freed").
        if oid in self._mmaps:
            if not self._try_release_mmap(oid):
                # A live value still exports the buffer (zero-copy numpy view)
                # — retried on the flusher tick until the value dies.
                self.refcounter.defer_local(oid)

    def _try_release_mmap(self, oid: bytes) -> bool:
        views = self._mmaps.get(oid)
        if views is None:
            return True
        if not _release_views(views):
            return False
        self._mmaps.pop(oid, None)
        if not self._closed:
            # Fire-and-forget unpin so the store may spill/evict the extent.
            async def _unpin():
                try:
                    await self.raylet.call(
                        "store_release", {"object_ids": [oid]}, timeout=10)
                except Exception as e:
                    # A lost unpin keeps the extent pinned until node GC —
                    # a slow store leak, so it must at least be visible.
                    logger.debug("store_release of %s failed: %s",
                                 oid.hex()[:12], e)

            try:
                self._spawn_bg(_unpin())
            except RuntimeError:
                pass
        return True

    def put(self, value: Any, *, cache_local: bool = True):
        from ray_tpu_torch.api import ObjectRef

        obj = ObjectID.from_put(self.task_id_root, next(self._put_counter))
        self.refcounter.mark_owned(obj.binary())
        with serialization.capture_refs() as nested:
            head, views = serialization.serialize(value)
        if nested:
            # refs-in-refs (ref: reference_count.h:534): the stored object
            # keeps its inner refs alive until it is itself freed.
            self.refcounter.add_contains(obj.binary(), nested)
        self._run(self._store_serialized(obj.binary(), head, views))
        if cache_local:
            self._memory_store[obj.binary()] = value
        # cache_local=False: the node store's extent is the ONLY copy —
        # for bulk donations (KV page sets) the default would pin a full
        # second copy of every donated page in the owner's process RAM
        # for the object's whole lifetime. Reads (owner included) go
        # through the ordinary store path.
        return ObjectRef(obj)

    async def _read_remote_chunks(self, oid: bytes,
                                  size: int) -> bytearray | None:
        """Assemble a large object over chunked reads (remote drivers).
        None if the object vanished mid-read (caller retries the round)."""
        chunk = self.config.remote_object_chunk_bytes
        buf = bytearray(size)
        for off in range(0, size, chunk):
            n = min(chunk, size - off)
            data = await self.raylet.call("obj_read_chunk", {
                "object_id": oid, "offset": off, "length": n,
            }, timeout=self.config.remote_chunk_rpc_timeout_s)
            if data is None:
                return None
            buf[off:off + n] = data
        return buf

    async def _store_serialized(self, oid: bytes, head: bytes, views) -> None:
        """Write a serialized value into the node store under `oid`:
        inline below the cutoff, zero-copy extent write + seal above. Remote
        drivers (ray://) can't mmap the arena — data rides the RPC."""
        size = serialization.serialized_size(head, views)
        if size <= self.config.max_inline_object_size:
            data = bytearray(size)
            serialization.write_to(memoryview(data), head, views)
            await self.raylet.call("store_put_inline", {
                "object_id": oid, "data": bytes(data),
            })
        elif self.config.remote_object_plane:
            data = bytearray(size)
            serialization.write_to(memoryview(data), head, views)
            chunk = self.config.remote_object_chunk_bytes
            if size <= chunk:
                await self.raylet.call("store_put_data", {
                    "object_id": oid, "data": bytes(data),
                })
            else:
                # Stream in chunks: one frame per chunk instead of one
                # giant frame (a 1 GiB+ put from a ray:// driver must not
                # hit the RPC frame cap).
                await self.raylet.call("store_create_remote", {
                    "object_id": oid, "size": size})
                mv = memoryview(data)
                for off in range(0, size, chunk):
                    await self.raylet.call("store_write_chunk", {
                        "object_id": oid, "offset": off,
                        "data": bytes(mv[off:off + chunk]),
                    }, timeout=self.config.remote_chunk_rpc_timeout_s)
                await self.raylet.call("store_seal_remote", {
                    "object_id": oid})
        else:
            resp = await self.raylet.call("store_create", {
                "object_id": oid, "size": size,
            })
            view = attach_extent(resp["arena"], resp["offset"], size)
            serialization.write_to(view, head, views)
            view.release()
            await self.raylet.call("store_seal", {"object_id": oid})

    def get_future(self, ref, timeout: float | None = None):
        """Thread-free get for one ref produced by THIS client's tasks.

        Returns a concurrent.futures.Future resolved on the client loop when
        the creating task's reply lands — no waiter thread per in-flight
        request (the async ingress path; ref: the reference proxy awaits
        assignment results on its ASGI loop, serve/_private/http_proxy.py).
        If the result is not inline in the memory store (plasma extent /
        foreign object), the future resolves to NEEDS_BLOCKING_GET and the
        caller must fall back to get() off-loop.
        """
        import concurrent.futures as _cf

        out: _cf.Future = _cf.Future()
        key = ref.id.binary()

        async def _go():
            try:
                if key not in self._memory_store and key in self._result_events:
                    # Atomic with _record_returns: both run on the client
                    # loop, and there is no await between the check above
                    # and arming the twin event.
                    aev = self._return_ready.setdefault(key, asyncio.Event())
                    if timeout is None:
                        await aev.wait()
                    else:
                        await asyncio.wait_for(aev.wait(), timeout)
                val = self._memory_store.get(key, NEEDS_BLOCKING_GET)
                if isinstance(val, _TaskErrorSentinel):
                    out.set_exception(val.err.to_exception())
                    return
                from ray_tpu_torch.core.task_error import TaskError

                if isinstance(val, TaskError):
                    out.set_exception(val.to_exception())
                    return
                out.set_result(val)
            except (asyncio.TimeoutError, TimeoutError):
                out.set_exception(GetTimeoutError(
                    f"task for object {ref.id.hex()[:16]} "
                    "not finished in time"))
            except Exception as e:  # noqa: BLE001
                out.set_exception(e)

        self._spawn_bg(_go())
        return out

    def get(self, refs: Sequence, timeout: float | None = None) -> list:
        deadline = None if timeout is None else time.monotonic() + timeout
        # First wait for any of our own in-flight tasks to land (their error
        # results only exist in the in-process store, never in the node store).
        for ref in refs:
            ev = self._result_events.get(ref.id.binary())
            if ev is not None:
                remaining = (
                    None if deadline is None else max(0, deadline - time.monotonic())
                )
                if not ev.wait(remaining):
                    raise GetTimeoutError(
                        f"task for object {ref.id.hex()[:16]} not finished in time"
                    )
        out: list[Any] = [None] * len(refs)
        missing: list[tuple[int, bytes]] = []
        for i, ref in enumerate(refs):
            key = ref.id.binary()
            if key in self._memory_store:
                out[i] = self._memory_store[key]
            else:
                missing.append((i, key))
        # Bounded store_get rounds: each probe window the client re-checks
        # cluster liveness of still-missing objects and triggers lineage
        # reconstruction for owned lost ones (ref: object_recovery_manager.h
        # RecoverObject on pull failure), so a node death mid-get heals.
        probe = self.config.get_probe_interval_s
        while missing:
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            chunk = probe if remaining is None else min(probe, remaining)
            try:
                resolved = self._run(self.raylet.call("store_get", {
                    "object_ids": [k for _, k in missing],
                    "timeout": chunk,
                    "want_data": self.config.remote_object_plane,
                }), timeout=chunk + 30)
            except FuturesTimeoutError:
                # A stalled store_get round must surface as the documented
                # exception type, not a raw concurrent.futures error.
                raise GetTimeoutError(
                    f"object {missing[0][1].hex()[:16]} store_get round "
                    "stalled (raylet unresponsive)"
                )
            still: list[tuple[int, bytes]] = []
            for (i, key), (loc, data) in zip(missing, resolved):
                if loc == "missing":
                    still.append((i, key))
                    continue
                if loc == "inline":
                    value = serialization.unpack(data)
                elif loc == "remote_chunked":
                    # ray:// driver streaming a large object: assemble from
                    # chunk reads (each its own RPC frame).
                    buf = self._run(
                        self._read_remote_chunks(key, data),
                        timeout=self.config.remote_object_op_timeout_s)
                    if buf is None:
                        still.append((i, key))
                        continue
                    value = serialization.unpack(buf)
                else:
                    name, offset, size = data
                    view = attach_extent(name, offset, size)
                    exporters: list = []
                    value = serialization.unpack(view, exporters)
                    self._mmaps[key] = (view, exporters)
                # graftlint: disable=GUARDED-BY (idempotent per-key cache refill: a racing free() re-evicts on the next release; a racing get() installs the identical value)
                self._memory_store[key] = value
                out[i] = value
            missing = still
            if not missing:
                break
            if deadline is not None and time.monotonic() >= deadline:
                raise GetTimeoutError(
                    f"object {missing[0][1].hex()[:16]} not available "
                    "within timeout"
                )
            if self.config.lineage_reconstruction_enabled:
                # Bound recovery by the caller's remaining deadline so a
                # get(timeout=X) cannot block through a slow re-execution.
                rem = (None if deadline is None
                       else max(0.1, deadline - time.monotonic()))
                try:
                    self._run(
                        self._recover_missing([k for _, k in missing]),
                        timeout=rem,
                    )
                except FuturesTimeoutError:
                    raise GetTimeoutError(
                        f"object {missing[0][1].hex()[:16]} lost; "
                        "reconstruction exceeded the get() timeout"
                    )
        for i, ref in enumerate(refs):
            if isinstance(out[i], _TaskErrorSentinel):
                raise out[i].err.to_exception()
            from ray_tpu_torch.core.task_error import TaskError

            if isinstance(out[i], TaskError):
                raise out[i].to_exception()
        return out

    # ------------------------------------------------ lineage reconstruction
    # (ref: core_worker/object_recovery_manager.h:41,90 + task_manager.h:86
    #  lineage pinning — owner-scoped: each client can rebuild the objects
    #  whose creating tasks it submitted, transitively through arguments)

    def _maybe_evict_lineage(self, oid: bytes) -> None:
        """Drop a lineage pin once neither this process (refs) nor any
        pinned downstream spec (deps) needs the object; cascades upstream.
        Callers come from GC threads, submitter threads, and the loop — all
        mutations go through _lineage_lock."""
        with self._lineage_lock:
            self._evict_lineage_locked(oid)
            # A freed dynamic ITEM (return index > 0) may have been the
            # last thing pinning its generator's spec under the index-0 id.
            o = ObjectID(oid)
            if not o.is_put and o.return_index > 0:
                self._evict_lineage_locked(
                    ObjectID.for_return(o.task_id, 0).binary())

    def _evict_lineage_locked(self, oid: bytes) -> None:
        if self.refcounter.count(oid) > 0:
            return
        if self._lineage_deps.get(oid, 0) > 0:
            return
        spec = self._lineage.get(oid)
        if spec is None:
            return
        if spec.dynamic_returns and self.refcounter.has_live_with_task_prefix(
                spec.task_id):
            # Dynamic generator: live ITEM refs (same task prefix) must keep
            # the spec pinned — replaying it is the only way to rebuild a
            # lost item (their ids derive from the task id).
            return
        self._lineage.pop(oid, None)
        if any(rid in self._lineage for rid in spec.return_ids):
            return  # sibling returns still pin the spec
        self._lineage_budget.pop(spec.task_id, None)
        for a in spec.args:
            if a.kind != "ref":
                continue
            n = self._lineage_deps.get(a.object_id, 0) - 1
            if n <= 0:
                self._lineage_deps.pop(a.object_id, None)
                self._evict_lineage_locked(a.object_id)
            else:
                self._lineage_deps[a.object_id] = n

    async def _recover_missing(self, oids: list[bytes]) -> None:
        await asyncio.gather(
            *(self._recover_object(oid) for oid in oids),
            return_exceptions=True,
        )

    async def _recover_object(self, oid: bytes) -> bool:
        spec = self._lineage.get(oid)
        if spec is None:
            # Dynamic generator items (return index > 0) aren't individually
            # pinned — their ids are derived from the creating task, so
            # route through the task's index-0 lineage entry: replaying the
            # generator re-stores every item under the SAME deterministic
            # ids (worker._expand_dynamic uses for_return(task, i+1)).
            o = ObjectID(oid)
            if not o.is_put and o.return_index > 0:
                root = ObjectID.for_return(o.task_id, 0).binary()
                root_spec = self._lineage.get(root)
                if root_spec is not None and root_spec.dynamic_returns:
                    spec = root_spec
        if spec is None:
            # put() objects: the owner still holds the value — re-store it
            # (the reference instead fails puts; owning the value lets us
            # do strictly better here).
            if oid in self._memory_store:
                return await self._re_put(oid)
            return False
        tkey = spec.task_id
        fut = self._recoveries.get(tkey)
        if fut is not None:
            return await asyncio.shield(fut)
        if any(rid in self._result_events for rid in spec.return_ids):
            # The creating task (first execution or an earlier recovery) is
            # still in flight — a borrower's pull of the not-yet-sealed
            # output must wait, not duplicate the execution.
            return False
        fut = asyncio.get_running_loop().create_future()
        self._recoveries[tkey] = fut
        try:
            ok = await self._recover_task(spec)
        except Exception as e:
            logger.warning("recovery of %s failed: %s", spec.name, e)
            ok = False
        finally:
            self._recoveries.pop(tkey, None)
        fut.set_result(ok)
        return ok

    async def _recover_task(self, spec: TaskSpec) -> bool:
        with self._lineage_lock:
            budget = self._lineage_budget.get(spec.task_id, 0)
            if budget <= 0:
                return False
            self._lineage_budget[spec.task_id] = budget - 1
        # Rebuild lost arguments first (transitive reconstruction).
        for a in spec.args:
            if a.kind != "ref":
                continue
            locs = await self.gcs.call(
                "obj_loc_get", {"object_id": a.object_id})
            if not locs and not await self._recover_object(a.object_id):
                logger.warning(
                    "cannot reconstruct %s: argument %s lost and not "
                    "recoverable", spec.name, a.object_id.hex()[:12])
                return False
        logger.info("lineage reconstruction: re-executing %s (budget %d)",
                    spec.name, budget - 1)
        import copy

        respec = copy.copy(spec)
        respec.retry_count = 0
        escrow = []
        for a in spec.args:
            if a.kind == "ref":
                self.refcounter.incref(a.object_id)
                escrow.append(a.object_id)
        for rid in spec.return_ids:
            self.refcounter.incref(rid)
            escrow.append(rid)
            self._result_events.setdefault(rid, threading.Event())
        # Clear free-tombstones for ids being re-created, else the GCS
        # frees the rebuilt objects the moment they are sealed.
        await self.gcs.call("ref_revive", {
            "object_ids": escrow, "holder_id": self.refcounter.holder_id,
        })
        await self._drive_task(respec, escrow)
        return True

    async def _re_put(self, oid: bytes) -> bool:
        value = self._memory_store.get(oid)
        if value is None:
            return False
        try:
            head, views = serialization.serialize(value)
            await self._store_serialized(oid, head, views)
            logger.info("re-stored lost put object %s", oid.hex()[:12])
            return True
        except Exception as e:
            logger.warning("re-put of %s failed: %s", oid.hex()[:12], e)
            return False

    def wait(
        self,
        refs: Sequence,
        num_returns: int = 1,
        timeout: float | None = None,
    ) -> tuple[list, list]:
        deadline = None if timeout is None else time.monotonic() + timeout
        pending = list(refs)
        ready: list = []
        while True:
            still = []
            keys = [r.id.binary() for r in pending]
            in_mem = [k in self._memory_store for k in keys]
            to_check = [k for k, m in zip(keys, in_mem) if not m]
            if to_check:
                present = self._run(self.raylet.call("store_contains", {
                    "object_ids": to_check,
                }))
                present_map = dict(zip(to_check, present))
            else:
                present_map = {}
            for r, k, m in zip(pending, keys, in_mem):
                if m or present_map.get(k):
                    ready.append(r)
                else:
                    still.append(r)
            pending = still
            if len(ready) >= num_returns or not pending:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            time.sleep(self.config.wait_poll_interval_s)
        return ready, pending

    def free(self, refs: Sequence) -> None:
        keys = [r.id.binary() for r in refs]
        for k in keys:
            self._memory_store.pop(k, None)
            entry = self._mmaps.pop(k, None)
            if entry is not None:
                _release_views(entry)
        self._run(self.gcs.call("obj_free", {"object_ids": keys}))
        self._run(self.raylet.call("store_free", {"object_ids": keys}))

    # ------------------------------------------------------------ tasks

    def _build_args(
        self, args: tuple, kwargs: dict
    ) -> tuple[list[ArgSpec], list[str], list[bytes]]:
        """Returns (arg specs, kwarg keys, escrowed ids). Escrow: every ref
        riding the spec — top-level args, refs nested in pickled values, and
        refs created here for oversized args — gets +1 held by the submitter
        until the task completes, so in-flight handoffs can't be GC'd
        (ref: reference_count.h submitted_task_ref_count)."""
        from ray_tpu_torch.api import ObjectRef

        specs: list[ArgSpec] = []
        escrow: list[bytes] = []
        labels = ([f"args[{i}]" for i in range(len(args))]
                  + [f"kwargs[{k!r}]" for k in kwargs])
        flat = list(args) + list(kwargs.values())
        try:
            self._build_arg_specs(labels, flat, specs, escrow)
        except BaseException:
            # A later argument failed to serialize: undo the escrow
            # increfs already taken for earlier ones, or their objects
            # stay pinned forever on this designed error path.
            for oid in escrow:
                self.refcounter.decref(oid)
            raise
        return specs, list(kwargs.keys()), escrow

    def _build_arg_specs(self, labels, flat, specs: list[ArgSpec],
                         escrow: list[bytes]) -> None:
        from ray_tpu_torch.api import ObjectRef

        for label, a in zip(labels, flat):
            if isinstance(a, ObjectRef):
                oid = a.id.binary()
                self.refcounter.incref(oid)
                escrow.append(oid)
                specs.append(ArgSpec(kind="ref", object_id=oid))
            else:
                try:
                    with serialization.capture_refs() as nested:
                        head, views = serialization.serialize(a)
                except Exception as e:
                    from ray_tpu_torch.utils.check_serialize import (
                        serialization_error,
                    )

                    raise serialization_error(
                        a, name=label, kind="task argument",
                        cause=e) from e
                for oid in nested:
                    self.refcounter.incref(oid)
                    escrow.append(oid)
                size = serialization.serialized_size(head, views)
                if size > self.config.max_inline_object_size:
                    ref = self.put(a)
                    oid = ref.id.binary()
                    self.refcounter.incref(oid)
                    escrow.append(oid)
                    specs.append(ArgSpec(kind="ref", object_id=oid))
                else:
                    data = bytearray(size)
                    serialization.write_to(memoryview(data), head, views)
                    specs.append(ArgSpec(kind="value", value=bytes(data)))

    def submit_task(
        self,
        fn_blob: bytes,
        name: str,
        args: tuple,
        kwargs: dict,
        *,
        num_returns: int = 1,
        dynamic_returns: bool = False,
        resources: dict[str, float] | None = None,
        max_retries: int | None = None,
        scheduling_strategy: Any = None,
        runtime_env: dict | None = None,
    ) -> list:
        from ray_tpu_torch.api import ObjectRef
        from ray_tpu_torch.core.runtime_env import resolve_runtime_env

        runtime_env = resolve_runtime_env(runtime_env, self)

        task_id = TaskID.for_task(JobID(self.job_id))
        arg_specs, kw_keys, escrow = self._build_args(args, kwargs)
        n = max(num_returns, 0)
        return_ids = [
            ObjectID.for_return(task_id, i).binary() for i in range(max(n, 1))
        ]
        # Hold the return ids while the task is in flight: even if the caller
        # drops its refs immediately, the worker's freshly-stored returns must
        # not race a free broadcast mid-creation.
        for rid in return_ids:
            self.refcounter.mark_owned(rid)
            self.refcounter.incref(rid)
            escrow.append(rid)
        spec = TaskSpec(
            kind=NORMAL_TASK,
            task_id=task_id.binary(),
            job_id=self.job_id,
            name=name,
            fn_blob=fn_blob,
            args=arg_specs,
            kwargs_keys=kw_keys,
            num_returns=n,
            dynamic_returns=dynamic_returns,
            return_ids=return_ids,
            resources=resources or {"CPU": 1},
            max_retries=(
                self.config.default_max_retries
                if max_retries is None else max_retries
            ),
            scheduling_strategy=scheduling_strategy,
            runtime_env=runtime_env,
            # Captured HERE (the submitting thread) so the ambient trace
            # context of the caller — not of the client's event loop —
            # parents this task's span.
            trace_ctx=tracing.capture_for_submission(),
        )
        for rid in return_ids:
            self._result_events[rid] = threading.Event()
            self._return_ready[rid] = asyncio.Event()
        if (self.config.lineage_reconstruction_enabled
                and self.config.ref_counting_enabled  # eviction needs GC
                and spec.max_retries > 0):            # 0 = user said never rerun
            # Pin the creating spec while we hold the returns
            # (ref: task_manager.h:86 lineage pinning).
            with self._lineage_lock:
                for rid in return_ids:
                    self._lineage[rid] = spec
                self._lineage_budget[spec.task_id] = spec.max_retries
                for a in arg_specs:
                    if a.kind == "ref":
                        self._lineage_deps[a.object_id] = (
                            self._lineage_deps.get(a.object_id, 0) + 1)
        refs = [ObjectRef(ObjectID(rid)) for rid in return_ids[:max(n, 1)]]
        self._spawn_bg(self._drive_task(spec, escrow))
        return refs if n != 1 else refs[:1]

    async def _lease_worker(self, spec: TaskSpec) -> tuple[dict, rpc.Connection]:
        """Lease a worker, following spillback redirects
        (ref: direct_task_transport.cc:325 RequestNewWorkerIfNeeded).

        Spillback chains are bounded: past the hop budget (stale cluster
        views can bounce a lease briefly) the task QUEUES at the current
        raylet (`no_spill`) instead of erroring — reference semantics, where
        saturation means waiting, not failure (cluster_task_manager.cc)."""
        raylet = self.raylet
        raylet_addr = self.raylet_address
        env_fields = _env_lease_fields(spec)
        for _hop in range(8):
            grant = await raylet.call("request_lease", {
                "resources": spec.resources,
                "strategy": spec.scheduling_strategy,
                "timeout": self.config.lease_timeout_s,
                "retriable": spec.max_retries > 0,
                **env_fields,
            }, timeout=self.config.lease_timeout_s + 10)
            if "spillback" in grant:
                raylet_addr = tuple(grant["spillback"])
                raylet = await self._raylet_conn(raylet_addr)
                continue
            if "error" in grant:
                raise RuntimeError(f"lease failed: {grant['error']}")
            return grant, raylet
        grant = await raylet.call("request_lease", {
            "resources": spec.resources,
            "strategy": spec.scheduling_strategy,
            "timeout": self.config.lease_timeout_s,
            "retriable": spec.max_retries > 0,
            "no_spill": True,
            **env_fields,
        }, timeout=self.config.lease_timeout_s + 10)
        if "error" in grant:
            raise RuntimeError(f"lease failed: {grant['error']}")
        if "spillback" in grant:
            raise RuntimeError("lease bounced with no_spill set (infeasible "
                               "locally); cluster view inconsistent")
        return grant, raylet

    async def _raylet_conn(self, addr: tuple[str, int]) -> rpc.Connection:
        if addr == self.raylet_address:
            return self.raylet
        conn = self._raylet_conns.get(addr)
        if conn is None or conn.closed:
            conn = await rpc.connect(*addr, timeout=self.config.rpc_connect_timeout_s)
            self._raylet_conns[addr] = conn
        return conn

    async def _worker_conn(self, addr: tuple[str, int]) -> rpc.Connection:
        conn = self._worker_conns.get(addr)
        if conn is None or conn.closed:
            conn = await rpc.connect(*addr, timeout=self.config.rpc_connect_timeout_s)
            self._worker_conns[addr] = conn
        return conn

    async def _drive_task(self, spec: TaskSpec,
                          escrow: list[bytes] | None = None) -> None:
        """Enqueue on the scheduling-key pipeline and await completion
        (lease → push → returns, retries on worker death — ref:
        task_manager.h:86 retry bookkeeping + direct_task_transport.cc
        per-key lease pipeline)."""
        try:
            pt = _PendingTask(spec, asyncio.get_running_loop().create_future(),
                              spec.max_retries + 1)
            if spec.return_ids:
                self._task_index[spec.return_ids[0]] = pt
            await self._await_local_deps(spec)
            if pt.state == "done":   # cancelled while waiting on deps
                return
            await self._publish_arg_holds(spec, escrow)
            key = self._sched_key(spec)
            pt.key = key
            q = self._pending_by_key.get(key)
            if q is None:
                import collections

                q = self._pending_by_key[key] = collections.deque()
            q.append(pt)
            ev = self._key_events.get(key)
            if ev is None:
                ev = self._key_events[key] = asyncio.Event()
            ev.set()
            self._ensure_lanes(key)
            await pt.done
        except Exception as e:  # noqa: BLE001 — see _drive_actor_task:
            # a silently-dropped pipeline coroutine becomes a get() hang.
            from ray_tpu_torch.core.task_error import TaskError

            logger.exception("task dispatch failed: %s", spec.name)
            self._fail_returns(spec, TaskError(
                "TaskUnschedulableError",
                f"dispatch failed internally: {e!r}", ""))
        finally:
            if spec.return_ids:
                self._task_index.pop(spec.return_ids[0], None)
            # Drop the in-flight escrow; if the caller already released its
            # refs this cascades into the batched GCS release → object GC.
            self._release_escrow(spec, escrow)

    async def _publish_arg_holds(self, spec: TaskSpec,
                                 escrow: list[bytes] | None) -> None:
        """Before the spec leaves this process, make sure the GCS holds
        our escrow on its ref arguments: a worker that borrows one and
        releases it after the task must not empty the object's holder set
        while our acquire still waits for the next flush. A failed flush
        is retried by the flusher; the task goes out regardless."""
        args = self._arg_holds(spec, escrow)
        if not args:
            return
        try:
            await self.refcounter.publish(args)
        except Exception as e:  # noqa: BLE001
            logger.debug("publishing %s's argument holds failed: %s",
                         spec.name, e)

    @staticmethod
    def _arg_holds(spec: TaskSpec, escrow: list[bytes] | None) -> list[bytes]:
        """The escrowed ids of a spec's ref arguments (not its returns)."""
        return [o for o in escrow or () if o not in spec.return_ids]

    def cancel_task(self, oid: bytes, force: bool = False) -> bool:
        """ray_tpu_torch.cancel: queued tasks unqueue and fail with
        TaskCancelledError; running tasks get a cooperative async exception
        on their executing thread (or asyncio-task cancel for async actors);
        force=True kills the worker process (ref: _private/worker.py:2389 +
        CoreWorker::HandleCancelTask)."""
        return self._run(self._cancel_async(oid, force))

    async def _cancel_async(self, oid: bytes, force: bool) -> bool:
        from ray_tpu_torch.core.task_error import TaskError

        pt = self._task_index.get(oid)
        if pt is None:
            return False
        cancelled_err = TaskError(
            "TaskCancelledError", "cancelled before execution", "")
        if isinstance(pt, dict):            # actor task entry
            if pt["state"] == "queued":
                pt["canceled"] = True
                return True
            st = pt["st"]
            conn = st.conn
            if conn is not None and not conn.closed:
                try:
                    await conn.call("cancel_task", {
                        "task_id": pt["spec"].task_id, "force": force,
                    }, timeout=10)
                    return True
                except Exception as e:
                    logger.debug("cancel_task rpc to actor worker failed "
                                 "(worker likely dying): %s", e)
                    return False
            return False
        pt.canceled = True
        if pt.state == "queued":
            q = self._pending_by_key.get(pt.key) if pt.key else None
            if q is not None:
                try:
                    q.remove(pt)
                except ValueError:
                    pass
            pt.state = "done"
            self._fail_returns(pt.spec, cancelled_err)
            if not pt.done.done():
                pt.done.set_result(None)
            return True
        if pt.state == "running" and pt.worker_conn is not None:
            try:
                r = await pt.worker_conn.call("cancel_task", {
                    "task_id": pt.spec.task_id, "force": force,
                }, timeout=10)
                return bool(r.get("ok"))
            except Exception:  # graftlint: disable=EXC-SWALLOW
                # force-kill drops the connection before the reply lands;
                # the lane's canceled check finishes the job.
                return force
        return False

    async def _await_local_deps(self, spec: TaskSpec) -> None:
        """Defer dispatch until ref args are known resolvable (ref:
        dependency_resolver.cc LocalDependencyResolver). Without this,
        consumers occupy the bounded worker pool blocking on producers that
        then can't get a worker — a deadlock, not just a slowdown.

        Two tiers: deps this client is still producing wait on the local
        return event; FOREIGN refs (other clients' objects — e.g. a serve
        replica consuming a driver's in-flight task output) wait for the
        object to appear in the GCS directory before dispatch, closing the
        cross-client variant of the same deadlock (r2 known limitation).
        """
        foreign: list[bytes] = []
        for a in spec.args:
            if a.kind != "ref":
                continue
            aev = self._return_ready.get(a.object_id)
            if aev is not None:
                await aev.wait()
            elif (a.object_id not in self._memory_store
                  and not self.refcounter.is_owned(a.object_id)):
                # Not ours and not locally resolvable: gate on the directory.
                foreign.append(a.object_id)
        for oid in foreign:
            while not self._closed:
                try:
                    locs = await self.gcs.call(
                        "obj_loc_get", {"object_id": oid}, timeout=30)
                except Exception as e:
                    # GCS outage mid-resolve: retried on the poll below,
                    # but an invisible retry loop is a debugging hole.
                    logger.debug("obj_loc_get %s failed (retrying): %s",
                                 oid.hex()[:12], e)
                    locs = None
                if locs or oid in self._memory_store:
                    break
                entry = (self._task_index.get(spec.return_ids[0])
                         if spec.return_ids else None)
                if getattr(entry, "state", None) == "done" or (
                        isinstance(entry, dict) and entry.get("canceled")):
                    return  # cancelled while waiting
                await asyncio.sleep(self.config.foreign_dep_poll_interval_s)

    @staticmethod
    def _sched_key(spec: TaskSpec) -> tuple:
        strat = spec.scheduling_strategy
        if isinstance(strat, dict):
            strat = tuple(sorted(
                (k, v if isinstance(v, (str, int, float, bytes, bool,
                                        type(None))) else repr(v))
                for k, v in strat.items()))
        env = _env_lease_fields(spec)
        return (tuple(sorted(spec.resources.items())), strat,
                env.get("runtime_env_key", ""))

    def _ensure_lanes(self, key: tuple) -> None:
        """Spawn lanes so every queued task can run CONCURRENTLY (up to the
        cap): busy lanes don't count — gang-style tasks (collectives) block
        each other if serialized onto one lane. Extra lanes cost one
        unnecessary lease request and exit after the keepalive."""
        q = self._pending_by_key.get(key)
        if not q:
            return
        cap = self.config.max_lease_lanes_per_key
        need = len(q) - self._idle_lanes.get(key, 0)
        while need > 0 and self._lanes.get(key, 0) < cap:
            self._lanes[key] = self._lanes.get(key, 0) + 1
            self._ensure_bg(self._lease_lane(key))
            need -= 1

    async def _keepalive_wait(self, key: tuple) -> bool:
        """Idle-lane wait: up to lease_keepalive_s for a new same-key task.
        True = a task is (probably) queued; False = release the lease.
        Spurious wakeups (N lanes woken for one task) resume waiting within
        the same deadline, keeping the other lanes' leases warm."""
        ev = self._key_events.get(key)
        if ev is None or self._closed:
            return False
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.config.lease_keepalive_s
        self._idle_lanes[key] = self._idle_lanes.get(key, 0) + 1
        try:
            while True:
                if self._pending_by_key.get(key):
                    return True
                remaining = deadline - loop.time()
                if remaining <= 0 or self._closed:
                    return False
                ev.clear()
                if self._pending_by_key.get(key):  # set-before-clear race
                    return True
                try:
                    await asyncio.wait_for(ev.wait(), remaining)
                except asyncio.TimeoutError:
                    return False
        finally:
            self._idle_lanes[key] = self._idle_lanes.get(key, 1) - 1

    async def _lease_lane(self, key: tuple) -> None:
        from ray_tpu_torch.core.task_error import TaskError

        try:
            while not self._closed:
                q = self._pending_by_key.get(key)
                if not q:
                    return
                head = q[0]
                try:
                    grant, lessor = await self._lease_worker(head.spec)
                except Exception as e:
                    q = self._pending_by_key.get(key)
                    if q:
                        pt = q.popleft()
                        self._fail_returns(pt.spec, TaskError(
                            "SchedulingError", str(e), ""))
                        if not pt.done.done():
                            pt.done.set_result(None)
                    continue
                worker_id = grant["worker_id"]
                worker_dead = False
                try:
                    try:
                        conn = await self._worker_conn(
                            tuple(grant["worker_address"]))
                    except (rpc.ConnectionLost, rpc.RpcError, OSError) as e:
                        # Worker died between grant and connect (OOM kill,
                        # crash): report the lease dead and re-lease. No
                        # task was charged an attempt — none was pushed.
                        logger.warning("leased worker unreachable: %s", e)
                        worker_dead = True
                        continue
                    # Pipeline queued same-key tasks onto this lease.
                    while True:
                        q = self._pending_by_key.get(key)
                        if not q:
                            # Keep the lease warm until the keepalive
                            # deadline: spurious wakeups (another lane won
                            # the race for a single new task) resume
                            # waiting instead of dropping the warm lease.
                            if not await self._keepalive_wait(key):
                                break
                        q = self._pending_by_key.get(key)
                        if not q:
                            break
                        pt = q.popleft()
                        pt.state = "running"
                        pt.worker_conn = conn
                        pt.spec.retry_count = (
                            pt.spec.max_retries + 1 - pt.attempts)
                        try:
                            reply = await conn.call(
                                "push_task", {"spec": pt.spec})
                        except (rpc.ConnectionLost, rpc.RpcError) as e:
                            worker_dead = True
                            pt.attempts -= 1
                            if pt.canceled:
                                # force-cancel killed the worker (or the
                                # crash raced a cancel): do NOT re-execute.
                                pt.state = "done"
                                self._fail_returns(pt.spec, TaskError(
                                    "TaskCancelledError", "cancelled", ""))
                                if not pt.done.done():
                                    pt.done.set_result(None)
                            elif pt.attempts > 0:
                                logger.warning(
                                    "task %s failed (%s); retrying "
                                    "(%d attempts left)",
                                    pt.spec.name, e, pt.attempts)
                                pt.state = "queued"
                                pt.worker_conn = None
                                q.appendleft(pt)
                            else:
                                pt.state = "done"
                                self._fail_returns(pt.spec, TaskError(
                                    "WorkerCrashedError",
                                    f"worker died executing "
                                    f"{pt.spec.name}: {e}", ""))
                                if not pt.done.done():
                                    pt.done.set_result(None)
                            break
                        pt.state = "done"
                        self._record_returns(pt.spec, reply)
                        if not pt.done.done():
                            pt.done.set_result(None)
                finally:
                    await self._safe_release(lessor, worker_id,
                                             dead=worker_dead)
        except Exception:
            # A lane must never die silently with tasks queued: waiting
            # submitters would hang on their done futures. Log, then respawn
            # a replacement lane for whatever is still queued.
            logger.exception("lease lane crashed; respawning")
            if self._pending_by_key.get(key) and not self._closed:
                asyncio.get_running_loop().call_later(
                    0.1, self._ensure_lanes, key)
        finally:
            self._lanes[key] = self._lanes.get(key, 1) - 1


    def _release_escrow(self, spec: TaskSpec,
                        escrow: list[bytes] | None) -> None:
        """Drop in-flight escrow holds after a task completes. If the worker
        replied with acquires it could not flush (GCS outage outlasted its
        reconnect window), the decref for those ids is deferred until the
        worker's holder registration appears in the GCS ref table — releasing
        immediately could overtake the acquire once the GCS recovers and free
        args the task retained (ADVICE r2, worker.py pre-reply flush)."""
        self._release_escrow_ids(
            escrow, spec.return_ids[0] if spec.return_ids else None)

    def _release_escrow_ids(self, escrow: list[bytes] | None,
                            first_return_id: bytes | None) -> None:
        # Pop the unflushed-reply entry even when escrow is empty (a
        # no-ref-arg task during a GCS outage still records one): the map
        # must not grow unboundedly.
        unflushed = (self._unflushed_replies.pop(first_return_id, None)
                     if first_return_id is not None else None)
        if not escrow:
            return
        if unflushed is None:
            for oid in escrow:
                self.refcounter.decref(oid)
            return
        holder_id, pending = unflushed
        deferred = [oid for oid in escrow if oid in pending]
        for oid in escrow:
            if oid not in pending:
                self.refcounter.decref(oid)
        if deferred:
            self._spawn_bg(
                self._deferred_escrow_release(deferred, holder_id))

    async def _deferred_escrow_release(self, oids: list[bytes],
                                       holder_id: bytes) -> None:
        """Poll the GCS ref table until `holder_id` is registered for each
        id (the worker's background flusher landed), then decref. Bounded:
        after 5× the reconnect window the decref proceeds regardless — by
        then the worker's flusher has either landed or the worker is gone
        (holder-death cleanup reclaims its holds anyway)."""
        remaining = set(oids)
        deadline = (asyncio.get_running_loop().time()
                    + 5 * self.config.gcs_reconnect_window_s)
        while remaining and not self._closed:
            try:
                dbg = await self.gcs.call(
                    "ref_debug", {"object_ids": sorted(remaining)},
                    timeout=10.0)
                for oid, info in dbg.items():
                    if holder_id in info.get("holders", ()):
                        remaining.discard(oid)
                        self.refcounter.decref(oid)
            except Exception as e:
                # Retried until the deadline warning below — but each miss
                # extends escrow lifetime, so leave a trace.
                logger.debug("ref_debug poll failed (retrying): %s", e)
            if not remaining:
                return
            if asyncio.get_running_loop().time() >= deadline:
                logger.warning(
                    "deferred escrow release timed out waiting for worker "
                    "holder registration; releasing %d ids", len(remaining))
                break
            await asyncio.sleep(2.0)
        for oid in remaining:
            self.refcounter.decref(oid)

    async def _safe_release(self, lessor, worker_id, dead=False):
        try:
            await lessor.call("release_lease", {
                "worker_id": worker_id, "dead": dead,
            }, timeout=5)
        except Exception as e:
            # An unreleased lease pins pool capacity until the raylet's
            # own worker-death sweep reclaims it — visible, not fatal.
            logger.debug("release_lease for %s failed: %s", worker_id, e)

    def _record_returns(self, spec: TaskSpec, reply: dict) -> None:
        if os.environ.get("RAY_TPU_TORCH_DEBUG_ACTOR_PUSH"):
            logger.warning("record_returns %s n=%d",
                           spec.return_ids[0].hex() if spec.return_ids
                           else "?", len(reply.get("returns", [])))
        if reply.get("unflushed_acquires") and spec.return_ids:
            self._unflushed_replies[spec.return_ids[0]] = (
                reply["ref_holder_id"], set(reply["unflushed_acquires"]))
        for rid, (loc, data) in zip(spec.return_ids, reply["returns"]):
            if loc == "inline":
                value = serialization.unpack(data)
                self._memory_store[rid] = value
            ev = self._result_events.pop(rid, None)
            if ev is not None:
                ev.set()
            aev = self._return_ready.pop(rid, None)
            if aev is not None:
                aev.set()

    def _fail_returns(self, spec: TaskSpec, err) -> None:
        from ray_tpu_torch.core.task_error import TaskError

        if os.environ.get("RAY_TPU_TORCH_DEBUG_ACTOR_PUSH"):
            logger.warning("fail_returns %s err=%s",
                           spec.return_ids[0].hex() if spec.return_ids
                           else "?", getattr(err, "exc_type", err))

        if err is None:
            err = TaskError("UnknownError", "task failed", "")
        for rid in spec.return_ids:
            self._memory_store[rid] = err
            ev = self._result_events.pop(rid, None)
            if ev is not None:
                ev.set()
            aev = self._return_ready.pop(rid, None)
            if aev is not None:
                aev.set()

    # ------------------------------------------------------------ actors

    def create_actor(
        self,
        cls_blob: bytes,
        name: str,
        args: tuple,
        kwargs: dict,
        *,
        resources: dict[str, float] | None = None,
        hold_resources: dict[str, float] | None = None,
        max_restarts: int = 0,
        max_concurrency: int = 1,
        actor_name: str | None = None,
        get_if_exists: bool = False,
        runtime_env: dict | None = None,
        concurrency_groups: dict[str, int] | None = None,
        max_task_retries: int = 0,
    ) -> bytes:
        from ray_tpu_torch.core.runtime_env import resolve_runtime_env

        runtime_env = resolve_runtime_env(runtime_env, self)
        actor_id = ActorID.of(JobID(self.job_id)).binary()
        resources = resources or {"CPU": 1}
        st = ActorState(actor_id)
        st.resources = resources
        with self._actors_lock:
            self._actors[actor_id] = st
        # Trace capture must happen in the SUBMITTING thread — the coroutine
        # below runs on the client's event loop, whose context is empty.
        trace_ctx = tracing.capture_for_submission()
        # The arguments are built here, not on the event loop: an argument
        # above max_inline_object_size is put into the store, and put()
        # waits on the loop (on the loop itself it would wait forever).
        built = self._build_args(args, kwargs)
        result = self._run(self._create_actor_async(
            st, cls_blob, name, built, resources, hold_resources,
            max_restarts, max_concurrency, actor_name, get_if_exists,
            runtime_env, concurrency_groups, max_task_retries, trace_ctx,
        ))
        if isinstance(result, bytes):       # got existing named actor
            return result
        return actor_id

    async def _create_actor_async(
        self, st, cls_blob, name, built, resources, hold_resources,
        max_restarts, max_concurrency, actor_name, get_if_exists,
        runtime_env=None, concurrency_groups=None, max_task_retries=0,
        trace_ctx=None,
    ):
        task_id = TaskID.for_actor_task(ActorID(st.actor_id))
        arg_specs, kw_keys, escrow = built
        st.creation_escrow = escrow
        st.creation_return_id = ObjectID.for_return(task_id, 0).binary()
        spec = TaskSpec(
            kind=ACTOR_CREATION,
            task_id=task_id.binary(),
            job_id=self.job_id,
            name=f"{name}.__init__",
            fn_blob=cls_blob,
            args=arg_specs,
            kwargs_keys=kw_keys,
            num_returns=1,
            return_ids=[ObjectID.for_return(task_id, 0).binary()],
            resources=resources,
            hold_resources=hold_resources,
            actor_id=st.actor_id,
            max_restarts=max_restarts,
            max_concurrency=max_concurrency,
            actor_name=actor_name,
            runtime_env=runtime_env,
            concurrency_groups=concurrency_groups,
            trace_ctx=trace_ctx,
        )
        reg = await self.gcs.call("register_actor", {
            "actor_id": st.actor_id,
            "name": actor_name,
            "max_restarts": max_restarts,
            "max_task_retries": max_task_retries,
            "resources": resources,
            "create_spec": serialization.dumps_call(spec),
        })
        if not reg.get("ok"):
            if get_if_exists and actor_name:
                info = await self.gcs.call("get_actor", {"name": actor_name})
                if info is not None:
                    existing = ActorState(info["actor_id"])
                    existing.address = (
                        tuple(info["address"]) if info["address"] else None
                    )
                    if existing.address:
                        existing.ready.set()
                    with self._actors_lock:
                        self._actors[info["actor_id"]] = existing
                    return info["actor_id"]
            raise RuntimeError(reg.get("error", "actor registration failed"))
        self._ensure_bg(self._place_actor(
            st, spec, tuple(reg["node_address"]), reg["node_id"]
        ))
        return None

    async def _place_actor(self, st: ActorState, spec: TaskSpec,
                           node_address: tuple[str, int],
                           node_id: bytes = b"") -> None:
        """Lease a worker on the chosen node and run the creation task
        (ref: gcs_actor_scheduler.cc ScheduleByRaylet)."""
        try:
            raylet = await self._raylet_conn(node_address)
            grant = await raylet.call("request_lease", {
                "resources": spec.resources, "strategy": "LOCAL",
                "timeout": self.config.lease_timeout_s,
                **_env_lease_fields(spec),
            }, timeout=self.config.lease_timeout_s + 10)
            if "error" in grant or "spillback" in grant:
                raise RuntimeError(f"actor placement failed: {grant}")
            worker_addr = tuple(grant["worker_address"])
            conn = await self._worker_conn(worker_addr)
            reply = await conn.call("push_task", {"spec": spec})
        except Exception as e:
            from ray_tpu_torch.core.task_error import TaskError

            resp = await self.gcs.call("actor_failed", {
                "actor_id": st.actor_id,
                "error": f"placement failed: {e}",
                "resources": spec.resources,
                "placement_failed": True,
            })
            if resp.get("restart"):
                # stays RESTARTING; the restart driver / next actor-task
                # submission re-places (possibly on a different node)
                raise _PlacementRetry(str(e))
            st.dead = True
            self._release_creation_escrow(st)
            st.death_cause = str(e)
            st.ready.set()
            self._fail_returns(spec, TaskError("ActorDiedError", str(e), ""))
            return
        if reply["status"] != "ok":
            self._record_returns(spec, reply)
            await self.gcs.call("actor_failed", {
                "actor_id": st.actor_id, "error": "creation task failed",
            })
            st.dead = True
            self._release_creation_escrow(st)
            st.death_cause = "creation failed"
            st.ready.set()
            return
        # Pin the worker to this actor for life.
        await raylet.call("release_lease", {
            "worker_id": grant["worker_id"],
            "actor_id": st.actor_id,
            "resources": (
                spec.resources if spec.hold_resources is None
                else spec.hold_resources
            ),
        })
        st.address = tuple(reply["actor_address"])
        st.conn = conn
        await self.gcs.call("actor_started", {
            "actor_id": st.actor_id,
            "address": st.address,
            "node_id": node_id,
        })
        st.ready.set()
        self._record_returns(spec, reply)

    def _release_creation_escrow(self, st: ActorState) -> None:
        escrow, st.creation_escrow = st.creation_escrow, []
        # Routes through the unflushed-acquire deferral: a creation reply
        # that raced a GCS outage may have registered deferred ids under the
        # creation return id (same hazard as normal-task escrow).
        self._release_escrow_ids(escrow, st.creation_return_id)

    def actor_state(self, actor_id: bytes) -> ActorState:
        with self._actors_lock:
            st = self._actors.get(actor_id)
            if st is None:
                st = ActorState(actor_id)
                self._actors[actor_id] = st
            return st

    def submit_actor_task(
        self,
        actor_id: bytes,
        method_name: str,
        args: tuple,
        kwargs: dict,
        *,
        num_returns: int = 1,
        concurrency_group: str | None = None,
        max_task_retries: int = 0,
    ) -> list:
        from ray_tpu_torch.api import ObjectRef

        st = self.actor_state(actor_id)
        task_id = TaskID.for_actor_task(ActorID(actor_id))
        arg_specs, kw_keys, escrow = self._build_args(args, kwargs)
        n = max(num_returns, 0)
        return_ids = [
            ObjectID.for_return(task_id, i).binary() for i in range(max(n, 1))
        ]
        for rid in return_ids:
            self.refcounter.mark_owned(rid)
            self.refcounter.incref(rid)
            escrow.append(rid)
        spec = TaskSpec(
            kind=ACTOR_TASK,
            task_id=task_id.binary(),
            job_id=self.job_id,
            name=method_name,
            fn_blob=None,
            args=arg_specs,
            kwargs_keys=kw_keys,
            num_returns=n,
            return_ids=return_ids,
            actor_id=actor_id,
            method_name=method_name,
            concurrency_group=concurrency_group,
            max_retries=max_task_retries,
            trace_ctx=tracing.capture_for_submission(),
        )
        for rid in return_ids:
            self._result_events[rid] = threading.Event()
            self._return_ready[rid] = asyncio.Event()
        self._task_index[return_ids[0]] = {
            "kind": "actor", "st": st, "spec": spec,
            "state": "queued", "canceled": False,
        }
        refs = [ObjectRef(ObjectID(rid)) for rid in return_ids[:max(n, 1)]]
        self._queue_actor_task(st, spec, escrow)
        return refs if n != 1 else refs[:1]

    def _queue_actor_task(self, st: ActorState, spec: TaskSpec,
                          escrow: list[bytes]) -> None:
        """Queue the spec's dispatch once the GCS holds our escrow on its
        ref arguments (see `_publish_arg_holds`), keeping the caller's
        order. A caller off the client's loop waits here for the
        publication; a caller on the loop (a coroutine run there) must not
        block it, so its dispatch is chained behind the publication, and
        every later dispatch to the actor from the loop behind that."""
        args = self._arg_holds(spec, escrow)
        needs = bool(args) and self.refcounter.needs_publish(args)
        try:
            on_loop = asyncio.get_running_loop() is self._loop
        except RuntimeError:
            on_loop = False
        if not on_loop:
            if needs:
                self._run(self._publish_arg_holds(spec, escrow))
            self._spawn_bg(self._drive_actor_task(st, spec, escrow))
            return
        prev = st.submit_tail
        if needs or (prev is not None and not prev.done()):
            st.submit_tail = self._ensure_bg(
                self._chain_actor_task(prev, st, spec, escrow))
        else:
            self._ensure_bg(self._drive_actor_task(st, spec, escrow))

    async def _chain_actor_task(self, prev, st: ActorState, spec: TaskSpec,
                                escrow: list[bytes]) -> None:
        if prev is not None:
            await prev   # its dispatch is spawned before it completes
        await self._publish_arg_holds(spec, escrow)
        self._ensure_bg(self._drive_actor_task(st, spec, escrow))

    async def _drive_actor_task(self, st: ActorState, spec: TaskSpec,
                                escrow: list[bytes] | None = None) -> None:
        from ray_tpu_torch.core.task_error import TaskError

        try:
            # NOTE: no _await_local_deps here — delaying dispatch on a
            # pending local dep would let later no-dep calls overtake this
            # one, breaking per-caller actor ordering. Ref args resolve
            # worker-side; actor workers are dedicated, so that blocking
            # can't starve the shared task pool.
            await self._drive_actor_task_inner(st, spec)
        except Exception as e:  # noqa: BLE001
            # An unexpected dispatch failure must FAIL the returns, never
            # vanish: this coroutine's exception goes nowhere (fire-and-
            # forget future), and a silently-dropped task turns into a
            # caller-side get() hang.
            logger.exception("actor task dispatch failed: %s", spec.name)
            self._fail_returns(spec, TaskError(
                "ActorUnavailableError",
                f"dispatch failed internally: {e!r}", ""))
        finally:
            if spec.return_ids:
                self._task_index.pop(spec.return_ids[0], None)
            self._release_escrow(spec, escrow)

    async def _drive_actor_task_inner(self, st: ActorState,
                                      spec: TaskSpec) -> None:
        from ray_tpu_torch.core.task_error import TaskError

        _dbg = os.environ.get("RAY_TPU_TORCH_DEBUG_ACTOR_PUSH")
        for attempt in range(100):
            if _dbg and attempt > 0:
                logger.warning("actor push %s attempt=%d addr=%s ready=%s",
                               spec.return_ids[0].hex()[:16] if
                               spec.return_ids else "?", attempt,
                               st.address, st.ready.is_set())
            entry = (self._task_index.get(spec.return_ids[0])
                     if spec.return_ids else None)
            if isinstance(entry, dict) and entry.get("canceled"):
                self._fail_returns(spec, TaskError(
                    "TaskCancelledError", "cancelled before execution", ""))
                return
            if st.dead:
                self._fail_returns(spec, TaskError(
                    "ActorDiedError",
                    f"actor is dead: {st.death_cause}", "",
                ))
                return
            if st.address is None:
                # Resolve via GCS (covers actors created by other clients and
                # events published before we subscribed).
                info = await self.gcs.call("get_actor", {"actor_id": st.actor_id})
                if info is not None and info["state"] == "DEAD":
                    st.dead = True
                    self._release_creation_escrow(st)
                    st.death_cause = info.get("death_cause", "not found")
                    continue
                if info is not None and info["state"] == "ALIVE" and info["address"]:
                    st.address = tuple(info["address"])
                    st.ready.set()
                else:
                    # PENDING/RESTARTING (or our own creation in flight): wait
                    # for the ALIVE/DEAD signal — pubsub or local _place_actor.
                    # If it's RESTARTING with no one driving placement (e.g.
                    # node died while idle), drive it ourselves.
                    if info is not None and info["state"] == "RESTARTING":
                        self._ensure_bg(self._ensure_actor_restart(
                            st, "observed RESTARTING"))
                    try:
                        await asyncio.wait_for(
                            st.ready.wait(), self.config.lease_timeout_s * 2
                        )
                    except asyncio.TimeoutError:
                        self._fail_returns(spec, TaskError(
                            "ActorUnavailableError",
                            "timed out waiting for actor to start", "",
                        ))
                        return
                    continue
            try:
                conn = st.conn
                if conn is None or conn.closed:
                    try:
                        conn = await self._worker_conn(st.address)
                    except Exception as e:  # dial refused/timed out
                        # The task was never sent — always safe to retry.
                        # A booting worker's listener may not accept yet;
                        # only after repeated refusals treat the address
                        # as stale and re-resolve via the GCS.
                        dial_fails = getattr(spec, "_dial_fails", 0) + 1
                        spec._dial_fails = dial_fails
                        # Patient: a booting worker's listener can lag its
                        # published address by many seconds under load, and
                        # a genuinely dead worker is reported through the
                        # raylet death path anyway (st.dead short-circuits
                        # this loop). ~10s of refusals before escalating —
                        # well inside the enclosing attempt budget, so the
                        # re-resolve path actually runs.
                        if dial_fails >= 40:
                            spec._dial_fails = 0
                            st.address = None
                            st.conn = None
                            st.ready.clear()
                            self._ensure_bg(self._ensure_actor_restart(
                                st, f"dial failed: {e!r}"))
                        await asyncio.sleep(0.25)
                        continue
                    spec._dial_fails = 0
                    st.conn = conn
                spec.seq_no = next(st.seq)
                entry = (self._task_index.get(spec.return_ids[0])
                         if spec.return_ids else None)
                if isinstance(entry, dict):
                    if entry.get("canceled"):
                        self._fail_returns(spec, TaskError(
                            "TaskCancelledError",
                            "cancelled before execution", ""))
                        return
                    entry["state"] = "running"
                reply = await conn.call("push_task", {"spec": spec})
                if reply.get("status") == "actor_missing":
                    st.address = None
                    st.conn = None
                    st.ready.clear()
                    await asyncio.sleep(0.05)
                    continue
                self._record_returns(spec, reply)
                return
            except (rpc.ConnectionLost, rpc.RpcError) as e:
                # Actor worker died. Drive the restart in the background, but
                # do NOT resubmit this task unless it opted into retries —
                # it may have partially executed (ref: max_task_retries=0
                # default, direct_actor_task_submitter.cc DisconnectActor).
                st.address = None
                st.conn = None
                st.ready.clear()
                self._ensure_bg(self._ensure_actor_restart(st, str(e)))
                if spec.max_retries > 0:
                    spec.max_retries -= 1
                    continue
                self._fail_returns(spec, TaskError(
                    "ActorDiedError",
                    f"actor died while executing {spec.name}: {e}", "",
                ))
                return
        self._fail_returns(spec, TaskError(
            "ActorUnavailableError", "actor task retry budget exhausted", "",
        ))

    async def _ensure_actor_restart(self, st: ActorState, error: str) -> None:
        """Report the failure and drive re-placement until the actor is ALIVE
        again or declared DEAD. Safe to call concurrently — the GCS `placing`
        guard serializes actual placement, and only one driver runs per
        client (st._restart_driver)."""
        if getattr(st, "_restart_driver", None) is not None:
            return
        st._restart_driver = True
        try:
            for _ in range(600):
                if st.dead or (st.address is not None and st.ready.is_set()):
                    return
                try:
                    resp = await self.gcs.call("actor_failed", {
                        "actor_id": st.actor_id,
                        "error": error,
                        "resources": st.resources,
                    })
                except rpc.ConnectionLost:
                    return
                if not resp.get("restart"):
                    st.dead = True
                    self._release_creation_escrow(st)
                    st.death_cause = resp.get("cause", error)
                    st.ready.set()
                    return
                if resp.get("wait") or resp.get("node_id") is None:
                    await asyncio.sleep(0.3)
                    continue
                try:
                    await self._restart_actor(
                        st, tuple(resp["node_address"]),
                        resp.get("node_id", b""),
                    )
                except _PlacementRetry:
                    await asyncio.sleep(0.3)
                    continue
                return
        finally:
            st._restart_driver = None

    async def _restart_actor(self, st: ActorState, node_address,
                             node_id: bytes = b"") -> None:
        """Replay the creation spec on a fresh worker
        (ref: gcs_actor_manager.cc:1068-1079 restart path)."""
        raw = await self.gcs.call("kv_get", {"ns": "actor_spec",
                                             "key": st.actor_id})
        if raw is None:
            st.dead = True
            self._release_creation_escrow(st)
            st.death_cause = "creation spec lost"
            st.ready.set()
            return
        spec: TaskSpec = serialization.loads_call(raw)
        # Fresh return ids: the original creation return is already consumed.
        task_id = TaskID.for_actor_task(ActorID(st.actor_id))
        spec.task_id = task_id.binary()
        spec.return_ids = [ObjectID.for_return(task_id, 0).binary()]
        # The unflushed-acquire deferral keys off the creation return id —
        # track the replayed spec's id or the eventual escrow release would
        # look up the stale original and skip the deferral.
        st.creation_return_id = spec.return_ids[0]
        st.dead = False
        try:
            await self._place_actor(st, spec, node_address, node_id)
        except _PlacementRetry:
            raise
        except Exception as e:
            logger.warning("actor restart failed: %s", e)

    def kill_actor(self, actor_id: bytes, no_restart: bool = True) -> None:
        st = self.actor_state(actor_id)
        resp = self._run(self.gcs.call("kill_actor", {
            "actor_id": actor_id, "no_restart": no_restart}))
        restarting = isinstance(resp, dict) and resp.get("restarting")
        if restarting:
            # Actor FSM will replay the creation task: keep the creation
            # escrow (the spec's args must stay resolvable) and let the
            # RESTARTING→ALIVE pubsub events drive local state.
            st.address = None
            st.ready.clear()
            st.restarting = True
            self._spawn_bg(self._ensure_actor_restart(
                st, "killed with no_restart=False"))
        else:
            st.dead = True
            self._release_creation_escrow(st)
            st.death_cause = "killed"
        addr = resp.get("address") if isinstance(resp, dict) else None
        addr = addr or st.address
        if addr:
            async def _send_kill():
                try:
                    conn = await self._worker_conn(tuple(addr))
                    await conn.call("kill_actor", {
                        "actor_id": actor_id, "no_restart": no_restart,
                    }, timeout=2)
                except Exception:  # graftlint: disable=EXC-SWALLOW (kill target may already be dead)
                    pass

            try:
                self._run(_send_kill())
            except Exception:  # graftlint: disable=EXC-SWALLOW (kill is best-effort by contract)
                pass

    # -------------------------------------------------- cluster events

    def event_add(self, payload: dict) -> None:
        """Append one structured cluster event (GCS `event_add`; read back
        via state.list_cluster_events)."""
        self._run(self.gcs.call("event_add", payload),
                  timeout=self.config.rpc_default_timeout_s)

    # -------------------------------------------------- kv

    def kv_put(self, ns: str, key: bytes, value: bytes,
               overwrite: bool = True) -> None:
        self._run(self.gcs.call("kv_put", {
            "ns": ns, "key": key, "value": value, "overwrite": overwrite,
        }), timeout=60)

    def kv_get(self, ns: str, key: bytes):
        return self._run(self.gcs.call("kv_get", {"ns": ns, "key": key}),
                         timeout=60)

    def kv_keys(self, ns: str, prefix: bytes = b"") -> list:
        return self._run(self.gcs.call("kv_keys",
                                       {"ns": ns, "prefix": prefix}),
                         timeout=60)

    def kv_del(self, ns: str, key: bytes) -> bool:
        return self._run(self.gcs.call("kv_del", {"ns": ns, "key": key}),
                         timeout=60)["deleted"]

    # -------------------------------------------------- placement groups

    def create_placement_group(self, pg_id: bytes, bundles: list,
                               strategy: str, name: str = "") -> dict:
        return self._run(self.gcs.call("pg_create", {
            "pg_id": pg_id, "bundles": bundles, "strategy": strategy,
            "name": name,
        }), timeout=60)

    def remove_placement_group(self, pg_id: bytes) -> None:
        self._run(self.gcs.call("pg_remove", {"pg_id": pg_id}), timeout=60)

    def list_placement_groups(self) -> list:
        return self._run(self.gcs.call("pg_list", {}), timeout=30)

    def get_named_actor(self, name: str):
        """→ (actor_id, max_task_retries) or None."""
        info = self._run(self.gcs.call("get_actor", {"name": name}))
        if info is None or info["state"] == "DEAD":
            return None
        st = self.actor_state(info["actor_id"])
        if info["address"]:
            st.address = tuple(info["address"])
        return info["actor_id"], info.get("max_task_retries", 0)

    # ------------------------------------------------------------ cluster info

    def cluster_view(self) -> dict:
        return self._run(self.gcs.call("get_cluster_view", {}))


class _TaskErrorSentinel:
    def __init__(self, err):
        self.err = err
