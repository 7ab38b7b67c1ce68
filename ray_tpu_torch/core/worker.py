"""Worker process: executes tasks and hosts actors.

Parity with the reference's core-worker execution side (`src/
ray/core_worker/core_worker.cc` HandlePushTask → `_raylet.pyx:678`
execute_task): tasks are pushed worker-to-worker over RPC (direct task
transport, `transport/direct_task_transport.h:57`), actor tasks run on a
dedicated thread with in-order queues (`actor_scheduling_queue.cc`), returns
go to the local store (large) and ride the reply (small).
"""

from __future__ import annotations

import argparse
import asyncio
import concurrent.futures
import logging
import os
import sys
import threading
import time
import traceback
from typing import Any

from ray_tpu_torch.core import execution_context, rpc, serialization
from ray_tpu_torch.core.config import Config
from ray_tpu_torch.core.ids import ActorID, ObjectID, WorkerID
from ray_tpu_torch.core.task_spec import ACTOR_CREATION, ACTOR_TASK, NORMAL_TASK, TaskSpec

logger = logging.getLogger(__name__)


from ray_tpu_torch.core.task_error import TaskError
from ray_tpu_torch.utils.aio import spawn


class _Cancelled(BaseException):
    """Injected into a running task's thread by ray_tpu_torch.cancel (via
    PyThreadState_SetAsyncExc). BaseException so bare `except Exception`
    user code can't swallow it (KeyboardInterrupt-style semantics,
    ref: _private/worker.py cancel → KeyboardInterrupt)."""


class _CancellableExecutor:
    """Fixed-size thread lane pool whose threads survive stray async
    exceptions. PyThreadState_SetAsyncExc delivery is asynchronous: a
    cancel that races task completion can fire between work items — inside
    a stock ThreadPoolExecutor that lands in queue.get and silently kills
    the thread (it is never respawned). Here the worker loop absorbs any
    BaseException raised outside an item and keeps serving."""

    def __init__(self, max_workers: int, thread_name_prefix: str = "lane"):
        import queue

        self._q: queue.Queue = queue.Queue()
        self._threads = [
            threading.Thread(target=self._loop, daemon=True,
                             name=f"{thread_name_prefix}-{i}")
            for i in range(max(1, max_workers))
        ]
        for t in self._threads:
            t.start()

    def _loop(self):
        while True:
            try:
                fn, fut = self._q.get()
                if not fut.set_running_or_notify_cancel():
                    continue
                try:
                    fut.set_result(fn())
                except BaseException as e:  # noqa: BLE001
                    fut.set_exception(e)
            except BaseException:  # graftlint: disable=EXC-SWALLOW
                # Stray late _Cancelled between items: absorb, keep serving
                # (the pool thread must never die — queued futures would
                # hang forever).
                continue

    def submit(self, fn, *args, **kwargs):
        fut = concurrent.futures.Future()
        self._q.put(((lambda: fn(*args, **kwargs)), fut))
        return fut


class ActorRuntime:
    """One hosted actor instance + its execution lanes.

    - Sync methods run on named concurrency-group thread pools (ref:
      transport/concurrency_group_manager.cc — a "_default" pool of
      max_concurrency plus one pool per declared group).
    - `async def` methods run on a dedicated asyncio loop thread, bounded by
      a semaphore of max_concurrency (ref: core_worker/fiber.h async actors).
    """

    def __init__(self, actor_id: bytes, instance: Any, max_concurrency: int,
                 concurrency_groups: dict[str, int] | None = None):
        self.actor_id = actor_id
        self.instance = instance
        prefix = f"actor-{ActorID(actor_id).hex()[:8]}"
        self.pools = {
            "_default": _CancellableExecutor(
                max(1, max_concurrency), thread_name_prefix=prefix)
        }
        for group, n in (concurrency_groups or {}).items():
            self.pools[group] = _CancellableExecutor(
                max(1, int(n)), thread_name_prefix=f"{prefix}-{group}")
        self.max_concurrency = max_concurrency
        self._aloop: asyncio.AbstractEventLoop | None = None
        self._asem: asyncio.Semaphore | None = None

    def pool_for(self, method, spec) -> concurrent.futures.ThreadPoolExecutor:
        group = spec.concurrency_group or getattr(
            method, "__ray_tpu_method_opts__", {}).get("concurrency_group")
        return self.pools.get(group or "_default", self.pools["_default"])

    def async_loop(self) -> asyncio.AbstractEventLoop:
        """Lazily start the actor's event loop thread (async actors)."""
        if self._aloop is None:
            loop = asyncio.new_event_loop()
            threading.Thread(target=loop.run_forever, daemon=True,
                             name=f"actor-aio-{ActorID(self.actor_id).hex()[:8]}"
                             ).start()
            # asyncio.Semaphore is loop-agnostic at construction (3.10+);
            # it is only ever awaited on `loop`.
            self._asem = asyncio.Semaphore(max(1, self.max_concurrency))
            self._aloop = loop
        return self._aloop


class Worker:
    def __init__(
        self,
        worker_id: bytes,
        raylet_address: tuple[str, int],
        gcs_address: tuple[str, int],
        node_id: bytes,
        config: Config,
        session_dir: str,
    ):
        self.worker_id = worker_id
        self.raylet_address = raylet_address
        self.gcs_address = gcs_address
        self.node_id = node_id
        self.config = config
        self.session_dir = session_dir
        self.server = rpc.Server("127.0.0.1", 0)
        self.raylet: rpc.Connection | None = None
        self.gcs: rpc.Connection | None = None
        self.actors: dict[bytes, ActorRuntime] = {}
        # Actor ids whose ACTOR_CREATION is running in the executor, plus a
        # per-actor arrival-order gate (see _h_push_task ordering note).
        self._creating: set[bytes] = set()
        self._actor_gates: dict[bytes, asyncio.Lock] = {}
        self.task_pool = _CancellableExecutor(1, thread_name_prefix="task")
        self.loop: asyncio.AbstractEventLoop | None = None
        self.address: tuple[str, int] | None = None
        self._exit = asyncio.Event()
        self.current_task_id: bytes | None = None
        # task_id → ("thread", ident) | ("atask", asyncio.Task) for cancel
        self._running: dict[bytes, tuple] = {}
        self.server.register("push_task", self._h_push_task)
        self.server.register("kill_actor", self._h_kill_actor)
        self.server.register("cancel_task", self._h_cancel_task)
        self.server.register("ping", self._h_ping)

    async def start(self) -> None:
        self.loop = asyncio.get_running_loop()
        self.address = await self.server.start()
        self.raylet = await rpc.connect(
            *self.raylet_address,
            timeout=self.config.rpc_connect_timeout_s,
            notify_handler=self._raylet_notify,
        )
        self.gcs = rpc.ReconnectingConnection(
            *self.gcs_address,
            dial_timeout=self.config.rpc_connect_timeout_s,
            reconnect_window_s=self.config.gcs_reconnect_window_s,
        )
        await self.gcs._ensure()
        await self.raylet.call("register_worker", {
            "worker_id": self.worker_id,
            "address": self.address,
            "pid": os.getpid(),
        })

        # Fate-sharing: if the raylet goes away, this worker dies with it
        # (ref: _private/ray_process_reaper.py).
        async def _watch_raylet():
            await self.raylet._closed.wait()
            logger.warning("raylet connection lost; exiting")
            os._exit(1)

        spawn(_watch_raylet())
        spawn(self._obs_flush_loop())
        # Make this process usable as a client (nested tasks): api.init picks
        # these up lazily inside executing task code.
        os.environ["RAY_TPU_TORCH_RAYLET_ADDRESS"] = (
            f"{self.raylet_address[0]}:{self.raylet_address[1]}"
        )
        os.environ["RAY_TPU_TORCH_GCS_ADDRESS"] = (
            f"{self.gcs_address[0]}:{self.gcs_address[1]}"
        )
        os.environ["RAY_TPU_TORCH_SESSION_DIR"] = self.session_dir
        logger.info("worker %s serving at %s", WorkerID(self.worker_id).hex()[:8],
                    self.address)

    def _raylet_notify(self, method: str, payload: Any) -> None:
        if method == "exit":
            self.loop.call_soon_threadsafe(self._exit.set) if (
                threading.current_thread() is not threading.main_thread()
            ) else self._exit.set()

    async def _h_ping(self, conn, p):
        return {"ok": True, "actors": [a.hex() for a in self.actors]}

    async def _h_cancel_task(self, conn, p):
        """Cancel a running task (ref: CoreWorker::HandleCancelTask).
        Cooperative: an async exception lands in the executing thread (or
        the asyncio task is cancelled). force=True kills the process."""
        if p.get("force"):
            asyncio.get_running_loop().call_later(0.05, os._exit, 1)
            return {"ok": True, "forced": True}
        entry = self._running.get(p["task_id"])
        if entry is None:
            return {"ok": False, "running": False}
        kind, target = entry
        if kind == "thread":
            import ctypes

            # Narrow race: the task can complete between this check and the
            # delivery (async-exc lands at the next bytecode). A stray
            # _Cancelled outside an item is absorbed by
            # _CancellableExecutor, so the worst case is a spurious
            # TaskCancelledError on the task, never a dead lane thread.
            if p["task_id"] not in self._running:
                return {"ok": False, "running": False}
            n = ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(target), ctypes.py_object(_Cancelled))
            return {"ok": n == 1, "running": True}
        target.get_loop().call_soon_threadsafe(target.cancel)
        return {"ok": True, "running": True}

    async def _h_kill_actor(self, conn, p):
        rt = self.actors.get(p["actor_id"])
        if rt is None:
            return {"ok": False}
        # Actor death == worker process death regardless of no_restart
        # (matches reference: one actor per worker process; the restart, if
        # any, replays the creation spec on a FRESH worker — the GCS decided
        # that before this RPC was sent).
        asyncio.get_running_loop().call_later(0.05, os._exit, 0)
        return {"ok": True}

    # ------------------------------------------------------------ execution

    async def _obs_flush_loop(self) -> None:
        """Ship buffered profile events + metric snapshots to the GCS
        (ref: core_worker/profiling.cc batching to AddProfileData).
        Shared loop body in profiling.run_obs_flush_loop."""
        from ray_tpu_torch import profiling

        await profiling.run_obs_flush_loop(
            f"worker:{WorkerID(self.worker_id).hex()[:8]}",
            lambda method, p: self.gcs.call(
                method, p, timeout=self.config.rpc_default_timeout_s),
            self.config.worker_profile_flush_interval_s,
            self._exit.is_set)

    async def _h_push_task(self, conn, p):
        from ray_tpu_torch import profiling

        spec: TaskSpec = p["spec"]
        _t0 = time.time()
        if spec.kind == ACTOR_TASK:
            # Per-actor FIFO gate: registration wait + executor submission
            # happen in ARRIVAL order. Without it, a method push processed
            # while the actor's __init__ is still running in the executor
            # gets "actor_missing", and the client's retry lands AFTER later
            # calls — breaking per-caller actor ordering (ref:
            # direct_actor_task_submitter.cc sequenced send queue).
            gate = self._actor_gates.setdefault(
                spec.actor_id, asyncio.Lock())
            fut = None
            rt = None
            async with gate:
                rt = self.actors.get(spec.actor_id)
                # Wait as long as the creation is genuinely in flight (an
                # LLM replica's __init__ can load weights for minutes);
                # creation failure clears _creating and exits the loop.
                while rt is None and spec.actor_id in self._creating:
                    await asyncio.sleep(0.02)
                    rt = self.actors.get(spec.actor_id)
                if rt is None:
                    return {"status": "actor_missing"}
                method = getattr(rt.instance, spec.method_name, None)
                if not asyncio.iscoroutinefunction(method):
                    fut = asyncio.get_running_loop().run_in_executor(
                        rt.pool_for(method, spec), self._run_actor_task,
                        rt, spec)
            if fut is not None:
                results, error = await fut
            else:
                # async actor: run on the actor's event loop, bounded by
                # the concurrency semaphore (ref: core_worker/fiber.h).
                results, error = await self._run_async_actor_task(rt, spec)
        elif spec.kind == ACTOR_CREATION:
            # Mark BEFORE the executor runs __init__ (we are still in the
            # synchronous prefix of this handler, so no method push for this
            # actor can observe an intermediate state).
            self._creating.add(spec.actor_id)
            try:
                fut = asyncio.get_running_loop().run_in_executor(
                    self.task_pool, self._run_actor_creation, spec
                )
                results, error = await fut
            finally:
                self._creating.discard(spec.actor_id)
        else:
            fut = asyncio.get_running_loop().run_in_executor(
                self.task_pool, self._run_normal_task, spec
            )
            results, error = await fut
        from ray_tpu_torch import tracing

        profiling.record_event(
            spec.method_name or spec.name, spec.kind, _t0, time.time() - _t0,
            pid=f"node:{self.node_id.hex()[:8]}",
            tid=f"worker:{WorkerID(self.worker_id).hex()[:8]}",
            args=(tracing.carrier_event_args(spec.trace_ctx)
                  if spec.trace_ctx else None))
        reply: dict[str, Any] = {"status": "ok", "worker_id": self.worker_id}
        if error is not None:
            reply["status"] = "error"
        # Store returns; inline small ones in the reply.
        stored = await self._store_returns(spec, results)
        reply["returns"] = stored
        if spec.kind == ACTOR_CREATION and error is None:
            reply["actor_address"] = self.address
        # Flush ref acquires/containments BEFORE replying: the submitter
        # drops its in-flight escrow on reply, and the GCS must already know
        # about any refs this task kept (actor state) or returned — a release
        # must never overtake its matching acquire. Retried briefly (a flush
        # failure is usually a transient GCS hiccup); if it still can't land,
        # the reply carries the unflushed acquires so the submitter defers
        # its escrow decref for those ids until this worker's holder
        # registration is observed — safe without stalling every completing
        # task's reply through a long outage.
        from ray_tpu_torch import api

        if api._client is not None:
            counter = api._client.refcounter
            deadline = time.time() + min(
                self.config.worker_preflush_window_s,
                self.config.gcs_reconnect_window_s)
            delay = self.config.gcs_reconnect_backoff_s
            while True:
                try:
                    # Per-attempt timeout bounded by the remaining deadline:
                    # a hung (not failing-fast) GCS connection must not hold
                    # the reply past the fallback window.
                    budget = max(1.0, deadline - time.time())
                    await asyncio.to_thread(counter.flush_now, budget, True)
                    break
                except Exception as e:
                    if time.time() >= deadline:
                        pending = counter.pending_acquire_ids()
                        if pending:
                            reply["unflushed_acquires"] = pending
                            reply["ref_holder_id"] = counter.holder_id
                        logger.error(
                            "pre-reply ref flush still failing (%s); "
                            "replying with %d unflushed acquires",
                            e, len(pending))
                        break
                    logger.warning("pre-reply ref flush failed: %s "
                                   "(retrying)", e)
                    await asyncio.sleep(delay)
                    delay = min(delay * 2, 2.0)
        return reply

    def _resolve_args(self, spec: TaskSpec) -> tuple[list, dict]:
        from ray_tpu_torch import api

        client = api._ensure_client()
        vals: list[Any] = []
        for a in spec.args:
            if a.kind == "value":
                vals.append(serialization.unpack(a.value))
            else:
                from ray_tpu_torch.api import ObjectRef

                vals.append(client.get([ObjectRef(ObjectID(a.object_id))])[0])
        n_kw = len(spec.kwargs_keys)
        if n_kw:
            args = vals[:-n_kw]
            kwargs = dict(zip(spec.kwargs_keys, vals[-n_kw:]))
        else:
            args, kwargs = vals, {}
        return args, kwargs

    def _run_normal_task(self, spec: TaskSpec):
        from ray_tpu_torch import tracing

        self.current_task_id = spec.task_id
        self._running[spec.task_id] = ("thread", threading.get_ident())
        execution_context.current_task_id.set(spec.task_id)
        restore = None
        # Always set (even to None): pooled threads must not leak a prior
        # task's trace context into this task's nested submissions.
        trace_token = tracing.enter_task(spec.trace_ctx)
        try:
            from ray_tpu_torch.core.runtime_env import apply_runtime_env

            restore = apply_runtime_env(spec.runtime_env)
            fn = serialization.unpack(spec.fn_blob)
            _t = time.time()
            args, kwargs = self._resolve_args(spec)
            if spec.trace_ctx is not None:
                spec.trace_ctx["transfer_s"] = time.time() - _t
            _t = time.time()
            try:
                out = fn(*args, **kwargs)
            finally:
                if spec.trace_ctx is not None:
                    spec.trace_ctx["exec_s"] = time.time() - _t
            if spec.dynamic_returns:
                return [self._expand_dynamic(spec, out)], None
            return self._split_returns(spec, out), None
        except _Cancelled as e:
            err = TaskError("TaskCancelledError", str(e) or "cancelled", "")
            return [err] * max(1, spec.num_returns), err
        except Exception as e:
            err = TaskError(type(e).__name__, str(e), traceback.format_exc())
            return [err] * max(1, spec.num_returns), err
        finally:
            # Pooled worker: don't leak this task's env into the next.
            if restore is not None:
                restore()
            tracing.exit_task(trace_token)
            self.current_task_id = None
            self._running.pop(spec.task_id, None)

    def _run_actor_creation(self, spec: TaskSpec):
        from ray_tpu_torch import tracing

        trace_token = tracing.enter_task(spec.trace_ctx)
        try:
            from ray_tpu_torch.core.runtime_env import apply_runtime_env

            apply_runtime_env(spec.runtime_env)
            cls = serialization.unpack(spec.fn_blob)
            _t = time.time()
            args, kwargs = self._resolve_args(spec)
            if spec.trace_ctx is not None:
                spec.trace_ctx["transfer_s"] = time.time() - _t
            execution_context.current_actor_id.set(spec.actor_id)
            _t = time.time()
            instance = cls(*args, **kwargs)
            if spec.trace_ctx is not None:
                spec.trace_ctx["exec_s"] = time.time() - _t
            rt = ActorRuntime(spec.actor_id, instance, spec.max_concurrency,
                              spec.concurrency_groups)
            self.actors[spec.actor_id] = rt
            return [None], None
        except Exception as e:
            err = TaskError(type(e).__name__, str(e), traceback.format_exc())
            return [err], err
        finally:
            tracing.exit_task(trace_token)

    def _run_actor_task(self, rt: ActorRuntime, spec: TaskSpec):
        from ray_tpu_torch import tracing

        self.current_task_id = spec.task_id
        self._running[spec.task_id] = ("thread", threading.get_ident())
        execution_context.current_actor_id.set(spec.actor_id)
        execution_context.current_task_id.set(spec.task_id)
        trace_token = tracing.enter_task(spec.trace_ctx)
        try:
            method = getattr(rt.instance, spec.method_name)
            _t = time.time()
            args, kwargs = self._resolve_args(spec)
            if spec.trace_ctx is not None:
                spec.trace_ctx["transfer_s"] = time.time() - _t
            _t = time.time()
            try:
                out = method(*args, **kwargs)
            finally:
                if spec.trace_ctx is not None:
                    spec.trace_ctx["exec_s"] = time.time() - _t
            return self._split_returns(spec, out), None
        except _Cancelled as e:
            err = TaskError("TaskCancelledError", str(e) or "cancelled", "")
            return [err] * max(1, spec.num_returns), err
        except Exception as e:
            err = TaskError(type(e).__name__, str(e), traceback.format_exc())
            return [err] * max(1, spec.num_returns), err
        finally:
            tracing.exit_task(trace_token)
            self.current_task_id = None
            self._running.pop(spec.task_id, None)

    async def _run_async_actor_task(self, rt: ActorRuntime, spec: TaskSpec):
        """Async actor call: args resolve off-loop, the coroutine runs on
        the actor's event loop under the concurrency semaphore; cancellation
        maps to asyncio task cancellation."""
        import concurrent.futures as _cf

        method = getattr(rt.instance, spec.method_name)
        try:
            args, kwargs = await asyncio.to_thread(self._resolve_args, spec)
        except Exception as e:
            err = TaskError(type(e).__name__, str(e), traceback.format_exc())
            return [err] * max(1, spec.num_returns), err
        loop = rt.async_loop()
        done: _cf.Future = _cf.Future()

        async def runner():
            from ray_tpu_torch import tracing

            execution_context.current_actor_id.set(spec.actor_id)
            execution_context.current_task_id.set(spec.task_id)
            # Each asyncio task runs in its own context copy, so this set
            # is isolated from interleaved calls on the same loop.
            tracing.enter_task(spec.trace_ctx)
            async with rt._asem:
                _t = time.time()
                try:
                    return await method(*args, **kwargs)
                finally:
                    if spec.trace_ctx is not None:
                        spec.trace_ctx["exec_s"] = time.time() - _t

        def schedule():
            t = loop.create_task(runner())
            self._running[spec.task_id] = ("atask", t)
            def _finish(task):
                self._running.pop(spec.task_id, None)
                if task.cancelled():
                    done.set_exception(asyncio.CancelledError())
                elif task.exception() is not None:
                    done.set_exception(task.exception())
                else:
                    done.set_result(task.result())
            t.add_done_callback(_finish)

        loop.call_soon_threadsafe(schedule)
        try:
            out = await asyncio.wrap_future(done)
            return self._split_returns(spec, out), None
        except asyncio.CancelledError:
            err = TaskError("TaskCancelledError", "cancelled", "")
            return [err] * max(1, spec.num_returns), err
        except Exception as e:
            err = TaskError(type(e).__name__, str(e), traceback.format_exc())
            return [err] * max(1, spec.num_returns), err

    def _expand_dynamic(self, spec: TaskSpec, gen) -> list:
        """num_returns="dynamic" (ref: _raylet.pyx:602): stream the task's
        generator into per-item objects; the task's single return is the
        list of their refs. The returned list's serialization registers
        refs-in-refs containment, so the items are GC'd exactly when the
        list object is — no special casing in the ref counter."""
        from ray_tpu_torch import api
        from ray_tpu_torch.api import ObjectRef
        from ray_tpu_torch.core import serialization as ser
        from ray_tpu_torch.core.ids import TaskID

        client = api._ensure_client()
        refs = []
        task_id = TaskID(spec.task_id)
        try:
            for i, item in enumerate(gen):
                oid = ObjectID.for_return(task_id, i + 1)
                head, views = ser.serialize(item)
                # This worker creates (owns) the item objects.
                client.refcounter.mark_owned(oid.binary())
                client._run(client._store_serialized(
                    oid.binary(), head, views))
                # Uncounted: the containment escrow from serializing this
                # list (store_returns → add_contains) holds the items until
                # the GCS registers the outer object's pseudo-holds; a
                # counted ref here would pin them until an unpredictable
                # worker gc.collect().
                refs.append(ObjectRef._uncounted(oid))
        except BaseException:
            # Generator raised/cancelled mid-stream: already-stored items
            # have no holders or containment yet — free them now or they
            # leak in the node store for the worker pool's lifetime.
            stored = [r.id.binary() for r in refs]
            if stored:
                try:
                    client._run(client.raylet.call(
                        "store_free", {"object_ids": stored}, timeout=30))
                    client._run(client.gcs.call(
                        "obj_free", {"object_ids": stored}, timeout=30))
                except Exception as e:
                    # The original generator error (re-raised below) matters
                    # more, but a failed free leaks the partial stream.
                    logger.debug(
                        "freeing %d partial dynamic returns failed: %s",
                        len(stored), e)
            raise
        return refs

    @staticmethod
    def _split_returns(spec: TaskSpec, out: Any) -> list:
        n = spec.num_returns
        if n == 0:
            return []
        if n == 1:
            return [out]
        if not isinstance(out, (tuple, list)) or len(out) != n:
            raise ValueError(
                f"task {spec.name} declared num_returns={n} but returned "
                f"{type(out).__name__} of length "
                f"{len(out) if hasattr(out, '__len__') else 'n/a'}"
            )
        return list(out)

    async def _store_returns(self, spec: TaskSpec, results: list):
        """→ list of ("inline", bytes) | ("stored", None) per return slot."""
        from ray_tpu_torch import api

        out = []
        client = api._client
        for obj_id, value in zip(spec.return_ids, results):
            with serialization.capture_refs() as nested:
                head, views = serialization.serialize(value)
            if nested and client is not None:
                # Returned value embeds ObjectRefs: the stored return keeps
                # them alive (refs-in-refs, reference_count.h:534). Flushed
                # before the task reply below.
                client.refcounter.add_contains(obj_id, nested)
            size = serialization.serialized_size(head, views)
            if size <= self.config.max_inline_object_size:
                data = bytearray(size)
                serialization.write_to(memoryview(data), head, views)
                data = bytes(data)
                await self.raylet.call("store_put_inline", {
                    "object_id": obj_id, "data": data,
                })
                out.append(("inline", data))
            else:
                resp = await self.raylet.call("store_create", {
                    "object_id": obj_id, "size": size,
                })
                from ray_tpu_torch.core.object_store import attach_extent

                view = attach_extent(resp["arena"], resp["offset"], size)
                serialization.write_to(view, head, views)
                view.release()
                await self.raylet.call("store_seal", {"object_id": obj_id})
                out.append(("stored", None))
        return out

    async def run_forever(self) -> None:
        await self._exit.wait()
        try:
            self.raylet.notify("worker_exiting", {"worker_id": self.worker_id})
        except Exception:  # graftlint: disable=EXC-SWALLOW (exiting anyway; raylet reaps us on disconnect)
            pass


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--raylet", required=True)
    ap.add_argument("--gcs", required=True)
    ap.add_argument("--node-id", required=True)
    ap.add_argument("--worker-id", required=True)
    ap.add_argument("--session-dir", required=True)
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO,
                        format="[worker] %(levelname)s %(message)s")
    rhost, rport = args.raylet.rsplit(":", 1)
    ghost, gport = args.gcs.rsplit(":", 1)
    from ray_tpu_torch.core.config import current_config

    config = current_config()

    async def run():
        worker = Worker(
            WorkerID.from_hex(args.worker_id).binary(),
            (rhost, int(rport)),
            (ghost, int(gport)),
            bytes.fromhex(args.node_id),
            config,
            args.session_dir,
        )
        await worker.start()
        await worker.run_forever()

    asyncio.run(run())


if __name__ == "__main__":
    main()
