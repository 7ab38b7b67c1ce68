"""Public API: init/remote/get/put/wait/kill/cancel + handles.

Parity with the reference's Python surface (`python/ray/
__init__.py:204` __all__, `remote_function.py:35` RemoteFunction,
`actor.py:377,1020` ActorClass/ActorHandle, `_private/worker.py:2241,2334`
get/put). Option validation mirrors `_private/ray_option_utils.py`.
"""

from __future__ import annotations

import atexit
import functools
import logging
import os
import threading
from typing import Any, Sequence

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.config import Config
from ray_tpu_torch.core.ids import ActorID, ObjectID

logger = logging.getLogger(__name__)

_client = None
_node = None
_lock = threading.RLock()


def _current_counter():
    """The live client's ReferenceCounter, or None pre-init/post-shutdown."""
    c = _client
    if c is None or c._closed:
        return None
    return c.refcounter


class RayTaskError(Exception):
    """A task/actor method raised; carries the remote traceback."""

    def __init__(self, exc_type: str, message: str, tb: str):
        self.exc_type = exc_type
        self.remote_traceback = tb
        super().__init__(f"{exc_type}: {message}\n--- remote traceback ---\n{tb}")


class TaskCancelledError(RayTaskError):
    """The task was cancelled via ray_tpu_torch.cancel
    (ref: exceptions.py TaskCancelledError)."""


class ActorDiedError(RayTaskError):
    """The actor running the task is dead (ref: exceptions.py
    RayActorError). Subclasses RayTaskError so existing broad catches
    keep working, but is distinguishable for failover: Serve's
    controller reaps the replica immediately instead of waiting out the
    health-probe strike window, and the proxies retry the request
    against a surviving replica."""


class ActorUnavailableError(RayTaskError):
    """The actor could not be reached but is not known dead (still
    starting / restarting / retry budget exhausted). Retriable-elsewhere
    like ActorDiedError, but NOT a definitive death verdict."""


class ObjectRef:
    """Future-like handle to an object in the cluster.

    Pickles by identity (ref: `_private/serialization.py:110-131`) so refs can
    be captured in closures and passed into tasks. Every live instance holds
    one local reference in the process's ReferenceCounter (ref:
    `reference_count.h:61` local_ref_count); `__del__` releases it, and
    process-level zero triggers a batched release to the GCS → automatic
    object GC.
    """

    __slots__ = ("id", "_counter", "__weakref__")

    def __init__(self, object_id: ObjectID):
        self.id = object_id
        c = _current_counter()
        self._counter = c
        if c is not None:
            c.incref(object_id.binary())

    @classmethod
    def from_hex(cls, hex_id: str) -> "ObjectRef":
        """Borrowed-ref construction from a serialized object id (the KV
        page-set index stores ids as hex in the GCS KV): counts as an
        ordinary local reference — incref on build, release on GC — so
        resolving an index entry pins the object for the read."""
        return cls(ObjectID(bytes.fromhex(hex_id)))

    @classmethod
    def _uncounted(cls, object_id: ObjectID) -> "ObjectRef":
        """A ref that holds NO local count (internal): used where another
        mechanism (e.g. refs-in-refs containment escrow) owns the lifetime
        and the instance may sit in asyncio frame cycles whose __del__ only
        runs at an unpredictable gc.collect()."""
        r = object.__new__(cls)
        r.id = object_id
        r._counter = None
        return r

    def hex(self) -> str:
        return self.id.hex()

    def __repr__(self):
        return f"ObjectRef({self.id.hex()})"

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __reduce__(self):
        # Escaping via serialization: report to the active capture scope so
        # the sender can escrow the ref while it is in flight (borrowed-ref
        # registration, ref: reference_count.h:511).
        serialization.note_ref(self.id.binary())
        return (ObjectRef, (self.id,))

    def __del__(self):
        # May run inside the cyclic GC on ANY thread — including while that
        # thread holds the counter's or the lineage lock. Only a lock-free
        # deque append happens here; the flusher drains it.
        c = self._counter
        if c is not None:
            try:
                c.decref_deferred(self.id.binary())
            except Exception:
                pass

    def future(self):
        import concurrent.futures

        fut: concurrent.futures.Future = concurrent.futures.Future()

        def _resolve():
            try:
                fut.set_result(get(self))
            except Exception as e:
                fut.set_exception(e)

        threading.Thread(target=_resolve, daemon=True).start()
        return fut


# --------------------------------------------------------------- init

def is_initialized() -> bool:
    return _client is not None


def _ensure_client():
    """Lazy-attach inside worker processes (env set by core/worker.py)."""
    global _client
    with _lock:
        if _client is None:
            raylet = os.environ.get("RAY_TPU_TORCH_RAYLET_ADDRESS")
            gcs = os.environ.get("RAY_TPU_TORCH_GCS_ADDRESS")
            if raylet and gcs:
                init(address=gcs, _raylet_address=raylet)
            else:
                init()
        return _client


def init(
    address: str | None = None,
    *,
    num_cpus: int | None = None,
    resources: dict[str, float] | None = None,
    object_store_memory: int | None = None,
    _system_config: dict | None = None,
    _raylet_address: str | None = None,
    ignore_reinit_error: bool = False,
):
    """Start (or attach to) a cluster.

    - address=None: start a single-node local cluster (GCS + raylet
      subprocesses), like the reference's `ray.init()` auto-start
      (`_private/worker.py:1031`) — unless RAY_TPU_TORCH_ADDRESS is set (job
      drivers, `ray job submit` children), which attaches instead.
    - address="host:port": attach to an existing GCS.
    """
    global _client, _node
    with _lock:
        if _client is not None:
            if ignore_reinit_error:
                return _client
            raise RuntimeError("ray_tpu_torch already initialized")
        if address is None:
            address = os.environ.get("RAY_TPU_TORCH_ADDRESS")
        from ray_tpu_torch.core.client import CoreClient

        from ray_tpu_torch.core.config import current_config

        config = current_config().override(_system_config)
        if address is not None and address.startswith("ray://"):
            # Remote driver: connect from outside the cluster; object data
            # travels over RPC instead of the same-host shm arena.
            address = address[len("ray://"):]
            config.remote_object_plane = True
        if object_store_memory is not None:
            config.object_store_memory = object_store_memory
        if address is None:
            from ray_tpu_torch.core.node import Node

            res = dict(resources or {})
            if num_cpus is not None:
                res["CPU"] = num_cpus
            res.setdefault("CPU", os.cpu_count() or 1)
            _node = Node(config, head=True, resources=res)
            _node.start()
            gcs_addr = _node.gcs_address
            raylet_addr = _node.raylet_address
            atexit.register(shutdown)
        else:
            host, port = address.rsplit(":", 1)
            gcs_addr = (host, int(port))
            if _raylet_address is not None:
                rh, rp = _raylet_address.rsplit(":", 1)
                raylet_addr = (rh, int(rp))
            else:
                raylet_addr = _pick_raylet(gcs_addr, config)
            # Attached clients also need a clean close at exit (cancels the
            # event-loop thread's connection tasks).
            atexit.register(shutdown)
        _client = CoreClient(gcs_addr, raylet_addr, config)
        return _client


def _pick_raylet(gcs_addr, config) -> tuple[str, int]:
    """Drivers attaching remotely use the least-loaded alive raylet."""
    import asyncio

    from ray_tpu_torch.core import rpc

    async def go():
        conn = await rpc.connect(*gcs_addr, timeout=config.rpc_connect_timeout_s)
        view = await conn.call("get_cluster_view", {})
        await conn.close()
        alive = [n for n in view.values() if n.get("alive", True)]
        if not alive:
            raise RuntimeError("no alive nodes in cluster")
        best = min(alive, key=lambda n: n.get("load", 0))
        return tuple(best["address"])

    return asyncio.run(go())


def shutdown() -> None:
    global _client, _node
    with _lock:
        # Always clear the globals, even if teardown throws (e.g. the GCS
        # was already killed by a fault-tolerance test) — a failed shutdown
        # must not wedge every later init() with "already initialized".
        client, _client = _client, None
        node, _node = _node, None
    try:
        if client is not None:
            client.shutdown()
    finally:
        if node is not None:
            node.stop()


# --------------------------------------------------------------- options

_TASK_ONLY = {"num_returns", "max_retries"}
_ACTOR_ONLY = {"max_restarts", "max_concurrency", "name", "get_if_exists",
               "lifetime", "max_task_retries", "concurrency_groups"}
_COMMON = {"num_cpus", "num_gpus", "resources", "scheduling_strategy",
           "runtime_env", "placement_group", "placement_group_bundle_index"}


def _build_resources(opts: dict) -> dict[str, float]:
    res = dict(opts.get("resources") or {})
    if opts.get("num_cpus") is not None:
        res["CPU"] = float(opts["num_cpus"])
    elif "CPU" not in res:
        res["CPU"] = 1.0
    if opts.get("num_gpus") is not None:
        res["GPU"] = float(opts["num_gpus"])
    return res


def _validate_options(opts: dict, *, for_actor: bool) -> None:
    allowed = _COMMON | (_ACTOR_ONLY if for_actor else _TASK_ONLY)
    unknown = set(opts) - allowed
    if unknown:
        kind = "actor" if for_actor else "task"
        raise ValueError(f"invalid {kind} options: {sorted(unknown)}")


class RemoteFunction:
    """Handle produced by @remote on a function
    (ref: remote_function.py:35)."""

    def __init__(self, fn, options: dict):
        _validate_options(options, for_actor=False)
        self._fn = fn
        self._options = options
        self._fn_blob: bytes | None = None
        self._captured_refs: list = []
        functools.update_wrapper(self, fn)

    def _blob(self) -> bytes:
        if self._fn_blob is None:
            # ObjectRefs captured in the function body (globals/closures) are
            # snapshotted into the pickle — hold live refs alongside the
            # cached blob so the objects can't be GC'd while the function
            # remains callable (borrowed-ref parity for captures).
            try:
                with serialization.capture_refs() as caps:
                    self._fn_blob = serialization.pack(self._fn)
            except Exception as e:
                from ray_tpu_torch.utils.check_serialize import serialization_error

                raise serialization_error(
                    self._fn,
                    name=getattr(self._fn, "__name__", None),
                    kind="remote function", cause=e) from e
            self._captured_refs = [ObjectRef(ObjectID(o)) for o in caps]
        return self._fn_blob

    def options(self, **opts) -> "RemoteFunction":
        merged = {**self._options, **opts}
        return RemoteFunction(self._fn, merged)

    def remote(self, *args, **kwargs):
        client = _ensure_client()
        o = self._options
        nr = o.get("num_returns", 1)
        dynamic = nr == "dynamic"
        refs = client.submit_task(
            self._blob(),
            getattr(self._fn, "__name__", "task"),
            args, kwargs,
            num_returns=1 if dynamic else nr,
            dynamic_returns=dynamic,
            resources=_build_resources(o),
            max_retries=o.get("max_retries"),
            scheduling_strategy=_strategy_payload(o),
            runtime_env=o.get("runtime_env"),
        )
        return refs[0] if dynamic or nr == 1 else refs

    def bind(self, *args, **kwargs):
        """Build a lazy DAG node instead of submitting (ref: dag/dag_node.py);
        execute with `.execute()` or durably via ray_tpu_torch.workflow."""
        from ray_tpu_torch.dag import FunctionNode

        return FunctionNode(self, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            "Remote function cannot be called directly; use .remote()"
        )


def _strategy_payload(o: dict):
    s = o.get("scheduling_strategy")
    pg = o.get("placement_group")
    if pg is not None:
        from ray_tpu_torch.core.placement_group import PlacementGroup

        if isinstance(pg, PlacementGroup):
            return {"type": "placement_group", "pg_id": pg.id.binary(),
                    "bundle_index": o.get("placement_group_bundle_index", -1)}
    if s is None or isinstance(s, str):
        return s
    # PlacementGroupSchedulingStrategy-like object
    if hasattr(s, "placement_group"):
        from ray_tpu_torch.core.placement_group import PlacementGroup

        if isinstance(s.placement_group, PlacementGroup):
            return {
                "type": "placement_group",
                "pg_id": s.placement_group.id.binary(),
                "bundle_index": getattr(
                    s, "placement_group_bundle_index", -1),
            }
    # NodeAffinitySchedulingStrategy-like object
    if hasattr(s, "node_id"):
        nid = s.node_id
        if isinstance(nid, str):   # public node ids are hex (api.nodes())
            nid = bytes.fromhex(nid)
        return {"type": "node_affinity", "node_id": nid,
                "soft": getattr(s, "soft", False)}
    return None


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str, num_returns: int = 1,
                 concurrency_group: str | None = None):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns
        self._concurrency_group = concurrency_group

    def options(self, num_returns: int = 1,
                concurrency_group: str | None = None) -> "ActorMethod":
        return ActorMethod(self._handle, self._name, num_returns,
                           concurrency_group)

    def remote(self, *args, **kwargs):
        client = _ensure_client()
        refs = client.submit_actor_task(
            self._handle._actor_id.binary(),
            self._name, args, kwargs,
            num_returns=self._num_returns,
            concurrency_group=self._concurrency_group,
            max_task_retries=self._handle._max_task_retries,
        )
        return refs[0] if self._num_returns == 1 else refs


class ActorHandle:
    """Callable handle to a live actor (ref: actor.py:1020)."""

    def __init__(self, actor_id: ActorID, max_task_retries: int = 0):
        self._actor_id = actor_id
        # Retries for this actor's METHOD calls after an actor crash +
        # restart (distinct from task max_retries; ref:
        # ray_option_utils.py:158-159 max_task_retries).
        self._max_task_retries = max_task_retries

    def __getattr__(self, item: str) -> ActorMethod:
        if item.startswith("_"):
            raise AttributeError(item)
        return ActorMethod(self, item)

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._max_task_retries))

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()})"


class ActorClass:
    """Handle produced by @remote on a class (ref: actor.py:377)."""

    def __init__(self, cls, options: dict):
        _validate_options(options, for_actor=True)
        self._cls = cls
        self._options = options
        self._cls_blob: bytes | None = None
        self._captured_refs: list = []

    def _blob(self) -> bytes:
        if self._cls_blob is None:
            try:
                with serialization.capture_refs() as caps:
                    self._cls_blob = serialization.pack(self._cls)
            except Exception as e:
                from ray_tpu_torch.utils.check_serialize import serialization_error

                raise serialization_error(
                    self._cls,
                    name=getattr(self._cls, "__name__", None),
                    kind="actor class", cause=e) from e
            self._captured_refs = [ObjectRef(ObjectID(o)) for o in caps]
        return self._cls_blob

    def options(self, **opts) -> "ActorClass":
        return ActorClass(self._cls, {**self._options, **opts})

    def remote(self, *args, **kwargs) -> ActorHandle:
        client = _ensure_client()
        o = self._options
        placement = _build_resources(o)
        # Reference semantics: actors use 1 CPU for scheduling but hold 0 CPU
        # while alive unless num_cpus was explicit
        # (ref: _private/ray_option_utils.py actor defaults).
        hold = dict(placement)
        if o.get("num_cpus") is None and "CPU" not in (o.get("resources") or {}):
            hold["CPU"] = 0.0
        actor_id = client.create_actor(
            self._blob(),
            self._cls.__name__,
            args, kwargs,
            resources=placement,
            hold_resources=hold,
            max_restarts=o.get("max_restarts", 0),
            max_concurrency=o.get("max_concurrency", 1),
            actor_name=o.get("name"),
            get_if_exists=o.get("get_if_exists", False),
            runtime_env=o.get("runtime_env"),
            concurrency_groups=o.get("concurrency_groups"),
            max_task_retries=o.get("max_task_retries", 0),
        )
        return ActorHandle(ActorID(actor_id),
                           max_task_retries=o.get("max_task_retries", 0))

    def __call__(self, *args, **kwargs):
        raise TypeError("Actor class cannot be instantiated directly; "
                        "use .remote()")


def remote(*args, **options):
    """@remote decorator for tasks and actors (ref: worker.py `ray.remote`)."""
    if len(args) == 1 and callable(args[0]) and not options:
        target = args[0]
        if isinstance(target, type):
            return ActorClass(target, {})
        return RemoteFunction(target, {})
    if args:
        raise TypeError("use @remote or @remote(**options)")

    def deco(target):
        if isinstance(target, type):
            return ActorClass(target, options)
        return RemoteFunction(target, options)

    return deco


# --------------------------------------------------------------- data plane

def put(value: Any, *, _cache_local: bool = True) -> ObjectRef:
    return _ensure_client().put(value, cache_local=_cache_local)


def get(refs, timeout: float | None = None):
    client = _ensure_client()
    single = isinstance(refs, ObjectRef)
    if single:
        refs = [refs]
    if not all(isinstance(r, ObjectRef) for r in refs):
        raise TypeError("get() accepts an ObjectRef or a list of ObjectRefs")
    out = client.get(refs, timeout)
    return out[0] if single else out


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: float | None = None):
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() accepts a list of ObjectRefs")
    return _ensure_client().wait(refs, num_returns, timeout)


def free(refs: Sequence[ObjectRef]) -> None:
    if isinstance(refs, ObjectRef):
        refs = [refs]
    _ensure_client().free(refs)


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    _ensure_client().kill_actor(actor._actor_id.binary(), no_restart)


def cancel(ref: ObjectRef, *, force: bool = False,
           recursive: bool = False) -> bool:
    """Cancel the task producing `ref` (ref: _private/worker.py:2389).

    Queued tasks are unqueued and fail with TaskCancelledError; running
    tasks receive a cooperative async exception on their executing thread
    (async actor calls get asyncio cancellation); force=True kills the
    executing worker process. Returns True if a cancellation was delivered.
    `recursive` is accepted for API parity (child tasks are not tracked).
    """
    return _ensure_client().cancel_task(ref.id.binary(), force)


def get_actor(name: str) -> ActorHandle:
    found = _ensure_client().get_named_actor(name)
    if found is None:
        raise ValueError(f"no alive actor named {name!r}")
    actor_id, max_task_retries = found
    # Retry semantics ride the GCS actor record, so a handle fetched by
    # name behaves like the creator's handle.
    return ActorHandle(ActorID(actor_id), max_task_retries=max_task_retries)


# --------------------------------------------------------------- cluster info

def nodes() -> list[dict]:
    view = _ensure_client().cluster_view()
    return [
        {"NodeID": nid.hex(), "Alive": n["alive"],
         "Resources": n["resources_total"], "Address": n["address"],
         "Labels": n.get("labels", {})}
        for nid, n in view.items()
    ]


def cluster_resources() -> dict[str, float]:
    total: dict[str, float] = {}
    for n in _ensure_client().cluster_view().values():
        if not n.get("alive", True):
            continue
        for k, v in n["resources_total"].items():
            total[k] = total.get(k, 0) + v
    return total


def available_resources() -> dict[str, float]:
    total: dict[str, float] = {}
    for n in _ensure_client().cluster_view().values():
        if not n.get("alive", True):
            continue
        for k, v in n["resources_available"].items():
            total[k] = total.get(k, 0) + v
    return total


class RuntimeContext:
    @property
    def job_id(self):
        return _ensure_client().job_id

    @property
    def is_initialized(self):
        return is_initialized()

    def get_actor_id(self) -> str | None:
        """Hex id of the actor executing the current code, or None outside
        an actor (ref: runtime_context.py get_actor_id)."""
        from ray_tpu_torch.core import execution_context
        from ray_tpu_torch.core.ids import ActorID

        aid = execution_context.current_actor_id.get()
        return ActorID(aid).hex() if aid is not None else None

    def get_node_id(self) -> str | None:
        """Hex id of the node whose raylet started this worker process,
        or None in a driver (ref: runtime_context.py get_node_id)."""
        return os.environ.get("RAY_TPU_TORCH_NODE_ID")

    def get_task_id(self) -> str | None:
        from ray_tpu_torch.core import execution_context
        from ray_tpu_torch.core.ids import TaskID

        tid = execution_context.current_task_id.get()
        return TaskID(tid).hex() if tid is not None else None


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext()


def method(**opts):
    """Decorator for actor methods (num_returns), parity with ray.method."""

    def deco(fn):
        fn.__ray_tpu_method_opts__ = opts
        return fn

    return deco
