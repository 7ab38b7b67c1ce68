"""Serve public API: @deployment, run, handles, batching.

Parity: `python/ray/serve/api.py:277,455` (@serve.deployment,
serve.run), `_private/router.py:62` (power-of-two-choices replica selection),
`serve/batching.py` (@serve.batch). The HTTP ingress lives in http_proxy.py.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import ray_tpu_torch
from ray_tpu_torch.core import serialization

logger = logging.getLogger(__name__)

CONTROLLER_NAME = "ray_tpu_serve_controller"
_local = threading.local()

# One routing-push subscription per process (not per handle): every
# DeploymentHandle reads the shared pushed version; re-subscribes if the
# client was re-initialized.
_push_state = {"version": -1, "client": None}

# Process-level dead-actor set fed by the GCS actor-death pubsub (plus
# note_dead() from failover paths that just watched a replica die): the
# hot routing path filters corpses with O(1) set lookups instead of one
# client actor_state lookup per cached replica per pick. Bounded: serve
# replicas never restart in place (the controller spawns replacements
# under fresh ids), so entries only matter while a stale route cache
# still lists the corpse — old ids age out at the cap.
_dead_state: dict = {"client": None, "dead": None}
_DEAD_CAP = 4096


def _dead_actors():
    """The process's dead-replica id set (bytes actor ids), arming the
    actor-death subscription on first use / client re-init. Gated on an
    ALREADY attached client: reading the dead set off-cluster must not
    BOOT a cluster as a side effect (`_ensure_client` auto-inits, and
    no entry point may boot one); without a client the current (possibly empty) set serves,
    and arming happens on the first call after init()."""
    import collections

    from ray_tpu_torch import api as _api

    client = _api._client
    if client is None:
        return _dead_state["dead"]
    if _dead_state["client"] is not client:
        _dead_state["client"] = client
        _dead_state["dead"] = collections.OrderedDict()

        def on_actor(payload, _c=client):
            if _dead_state["client"] is not _c:
                return
            if payload.get("state") == "DEAD":
                d = _dead_state["dead"]
                d[payload.get("actor_id")] = True
                while len(d) > _DEAD_CAP:
                    d.popitem(last=False)

        try:
            client.subscribe_channel("actor", on_actor)
        except Exception as e:
            # Without the death feed the TTL refresh + failover retries
            # still bound how long a corpse can be picked; say so once.
            logger.debug("actor-death subscription failed (dead replicas "
                         "age out via TTL refresh only): %s", e)
    return _dead_state["dead"]


def note_dead(actor_id: bytes) -> None:
    """Record an observed corpse ahead of the pubsub notification (the
    failover paths call this the moment a dispatch dies), so the very
    next pick — possibly before the GCS broadcast lands — already
    filters it."""
    d = _dead_state["dead"]
    if d is not None:
        d[actor_id] = True
        while len(d) > _DEAD_CAP:
            d.popitem(last=False)


def _rendezvous(key: bytes, replicas: list):
    """Highest-random-weight (rendezvous) hash: the stable preferred
    replica for an affinity key — stable under membership churn (only
    keys owned by a removed replica move)."""
    import hashlib

    return max(replicas, key=lambda r: hashlib.blake2b(
        key + r._actor_id.binary(), digest_size=8).digest())


def _pushed_version() -> int:
    from ray_tpu_torch import api as _api
    from ray_tpu_torch.serve.controller import ROUTES_CHANNEL

    # Gate on an already attached client (never _ensure_client): this
    # runs on every staleness check — including from handles built
    # off-cluster in unit tests — and must not auto-boot a cluster.
    client = _api._client
    if client is None:
        return _push_state["version"]
    if _push_state["client"] is not client:
        _push_state["client"] = client
        _push_state["version"] = -1

        def on_push(payload, _c=client):
            if _push_state["client"] is _c:
                _push_state["version"] = max(
                    _push_state["version"], payload.get("version", -1))

        try:
            client.subscribe_channel(ROUTES_CHANNEL, on_push)
        except Exception as e:
            # Without the push channel every handle falls back to TTL
            # polling — correct but slower to see redeploys; say so once.
            logger.debug("routes push subscription failed (handles will "
                         "poll): %s", e)
        try:
            _dead_actors()  # death feed rides the same (re)arm point
        except Exception as e:
            logger.debug("actor-death subscription arm failed: %s", e)
    return _push_state["version"]


def _get_controller(create: bool = False):
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        if not create:
            raise RuntimeError("serve not started — call serve.start() or serve.run()")
        from ray_tpu_torch.serve.controller import ServeController

        ctrl = ray_tpu_torch.remote(ServeController).options(
            name=CONTROLLER_NAME, get_if_exists=True, max_concurrency=16,
            # Controller FT: auto-restart; __init__ restores the GCS KV
            # checkpoint and the reconcile loop re-adopts live replicas.
            max_restarts=-1,
        ).remote()
        return ctrl


def start():
    return _get_controller(create=True)


def shutdown():
    try:
        ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        return
    try:
        ray_tpu_torch.get(ctrl.shutdown.remote(), timeout=60)
    except Exception:  # graftlint: disable=EXC-SWALLOW (shutdown: controller may be mid-crash; kill below finishes it)
        pass
    try:
        ray_tpu_torch.kill(ctrl)
    except Exception:  # graftlint: disable=EXC-SWALLOW (shutdown: already dead is success)
        pass


@dataclass
class Deployment:
    func_or_class: Any
    name: str
    num_replicas: int = 1
    route_prefix: str | None = None
    ray_actor_options: dict | None = None
    max_concurrent_queries: int = 8
    user_config: Any = None
    init_args: tuple = ()
    init_kwargs: dict = field(default_factory=dict)
    # {"min_replicas", "max_replicas", "target_ongoing_requests",
    #  "upscale_delay_s", "downscale_delay_s"} — queue-depth autoscaling
    # (ref: _private/autoscaling_policy.py). None = fixed num_replicas.
    autoscaling_config: dict | None = None
    # Disaggregated serving pools (serve_pool_role): "prefill" /
    # "decode" marks this deployment's replica pool; None = fused
    # (every replica does both — today's behavior). The role rides the
    # controller routing table for observability and router awareness;
    # the handoff mechanics live in LLMDeployment(pool_role=,
    # pool_peer=) — prefill replicas donate KV pages and migrate the
    # stream, decode replicas adopt. Each pool autoscales
    # independently through its own deployment record.
    pool_role: str | None = None

    def options(self, **kw) -> "Deployment":
        import dataclasses

        return dataclasses.replace(self, **kw)

    def bind(self, *args, **kwargs) -> "Deployment":
        """DAG-style binding of constructor args (ref: serve DAG API)."""
        import dataclasses

        return dataclasses.replace(
            self, init_args=args, init_kwargs=kwargs
        )


def deployment(_func_or_class=None, *, name: str | None = None,
               num_replicas: int = 1, route_prefix: str | None = None,
               ray_actor_options: dict | None = None,
               max_concurrent_queries: int = 8,
               user_config: Any = None,
               autoscaling_config: dict | None = None,
               pool_role: str | None = None):
    def make(target):
        return Deployment(
            func_or_class=target,
            name=name or getattr(target, "__name__", "deployment"),
            num_replicas=num_replicas,
            route_prefix=(
                route_prefix if route_prefix is not None
                else f"/{name or getattr(target, '__name__', 'deployment')}"
            ),
            ray_actor_options=ray_actor_options,
            max_concurrent_queries=max_concurrent_queries,
            user_config=user_config,
            autoscaling_config=autoscaling_config,
            pool_role=pool_role,
        )

    if _func_or_class is not None:
        return make(_func_or_class)
    return make


class DeploymentHandle:
    """Client-side handle: routes calls to replicas with power-of-two-choices
    (ref: router.py ReplicaSet). Routing-table updates arrive by PUSH: the
    controller publishes version bumps on GCS pubsub (long_poll.py parity),
    so scaling/deletion is visible at the next call — the TTL is only a
    safety net against a lost notify."""

    def __init__(self, deployment_name: str):
        from ray_tpu_torch.core.config import runtime_config

        _cfg = runtime_config()
        self.REFRESH_TTL_S = _cfg.serve_handle_refresh_ttl_s
        self.COLD_START_TIMEOUT_S = _cfg.serve_cold_start_timeout_s
        # Router policy (serve_router_policy): p2c_local = legacy
        # handle-local power-of-two-choices; p2c_load = p2c over blended
        # local + probed load; affinity = p2c_load + prefix-affine
        # placement with load spill.
        self._policy = getattr(_cfg, "serve_router_policy", "p2c_load")
        if self._policy not in ("p2c_local", "p2c_load", "affinity"):
            logger.warning("unknown serve_router_policy %r; using "
                           "p2c_load", self._policy)
            self._policy = "p2c_load"
        self._load_stale_s = max(
            0.001, getattr(_cfg, "serve_router_load_stale_s", 5.0))
        self._spill_ongoing = getattr(
            _cfg, "serve_router_spill_ongoing", 16.0)
        self._shed_queue_depth = int(getattr(
            _cfg, "serve_overload_queue_depth", 0))
        self._shed_retry_after_s = getattr(
            _cfg, "serve_overload_retry_after_s", 1.0)
        # Affinity keys hash the chunk-chain head at the engine's prefill
        # chunk granularity (so keys match the prefix cache's depth-1
        # entries); a one-shot engine (chunk 0) falls back to 64.
        self._affinity_chunk = int(
            getattr(_cfg, "llm_prefill_chunk", 0) or 64)
        self.deployment_name = deployment_name
        self._version = -1
        self._replicas: list = []
        # actor id hex → last-probed load row (pushed by the controller
        # alongside the routing table: queue_depth / ongoing /
        # ttft_ewma_ms / kv_pages_free / prefix_cache_hit_rate / ts).
        self._loads: dict[str, dict] = {}
        # (table build ts on the controller's clock, local monotonic at
        # receipt): probe ages are computed as same-clock differences —
        # see _row_age. None = no table yet (unit use falls back to a
        # local wall-clock diff).
        self._loads_ref: tuple[float, float] | None = None
        self._overload_pinned = False
        # Descriptor-less warm discovery (pushed with the load table):
        # actor id hex → the replica's donated-chain-head summary
        # (16-hex depth-1 digest prefixes — the affinity-key space),
        # and the fleet-wide union for the O(1) "is this prefix warm
        # ANYWHERE" hint check. Refreshed with every routing push, so
        # neither costs a request-path RPC.
        self._kv_summaries: dict[str, frozenset] = {}
        self._kv_warm: frozenset = frozenset()
        self._lock = threading.Lock()
        self._last_refresh = 0.0
        # Router-local in-flight per replica (actor id → count): the
        # power-of-two-choices signal, maintained from this handle's own
        # dispatches instead of two blocking RPCs per request (ref: the
        # reference router's RunningReplica queue-len cache,
        # serve/_private/replica_scheduler/pow_2_scheduler.py).
        self._local_inflight: dict[bytes, int] = {}
        # Arm the process-level push subscription + actor-death feed —
        # only when a client already exists: constructing a handle must
        # never BOOT a cluster as a side effect (_ensure_client
        # auto-inits). A handle built before init() arms lazily on its
        # first pick (_pushed_version runs on every staleness check).
        from ray_tpu_torch import api as _api

        if _api._client is not None:
            try:
                _pushed_version()
                _dead_actors()
            except Exception as e:
                logger.debug("push subscription arm failed (handle will "
                             "poll): %s", e)

    def _refresh(self, force: bool = False):
        ctrl = _get_controller()
        table = ray_tpu_torch.get(
            ctrl.get_routing.remote(-1 if force else self._version),
            timeout=30,
        )
        with self._lock:
            self._last_refresh = time.monotonic()
            if table is None:
                return
            self._version = table["version"]
            route = table["routes"].get(self.deployment_name)
            self._replicas = route["replicas"] if route else []
            self._loads = (route.get("loads") or {}) if route else {}
            summaries = {
                aid: frozenset(row.get("kv_summary") or ())
                for aid, row in self._loads.items()
                if row.get("kv_summary")}
            self._kv_summaries = summaries
            self._kv_warm = (frozenset().union(*summaries.values())
                             if summaries else frozenset())
            tbl_ts = table.get("ts")
            self._loads_ref = (None if tbl_ts is None
                               else (float(tbl_ts), time.monotonic()))
            self._overload_pinned = bool(
                route.get("overload_pinned")) if route else False

    def _alive(self, replicas: list) -> list:
        """Drop replicas this process knows are dead — O(1) set lookups
        against the pubsub-fed dead set (note_dead() pre-seeds observed
        corpses), never a per-replica client lookup on the hot path."""
        dead = _dead_state["dead"]
        if not dead:
            return list(replicas)
        return [r for r in replicas
                if r._actor_id.binary() not in dead]

    def evict_replica(self, replica, dead: bool = False) -> None:
        """Failover hint: drop a replica from the cached route table NOW
        (a caller just observed it die or reject work while draining).
        The pubsub death notification / controller routing bump carry the
        same fact, but may lag the very next pick — without this an
        immediate no-backoff retry can land on the same corpse and burn
        the whole failover budget. Purely local: a still-routable replica
        reappears on the next table refresh. `dead=True` (the caller
        watched it DIE, not merely drain) additionally seeds the
        process-wide dead set so every handle's next pick filters it."""
        aid = replica._actor_id.binary()
        if dead:
            note_dead(aid)
        with self._lock:
            self._replicas = [r for r in self._replicas
                              if r._actor_id.binary() != aid]
            self._local_inflight.pop(aid, None)

    def _pick_replica(self, affinity_key: bytes | None = None):
        replicas: list = []
        for attempt in range(4):
            with self._lock:
                stale = (
                    self._version < _pushed_version()
                    or time.monotonic() - self._last_refresh
                    > self.REFRESH_TTL_S
                )
                replicas = self._alive(self._replicas)
            if replicas and not stale:
                break
            try:
                self._refresh(force=not replicas)
            except Exception:  # graftlint: disable=EXC-SWALLOW (controller mid-restart: serve from cache below)
                pass
            with self._lock:
                replicas = self._alive(self._replicas)
            if replicas:
                break
            time.sleep(0.3 * (attempt + 1))
        if not replicas:
            # Scale-to-zero wake-up: ask the controller for a cold start
            # and wait for the first replica (ref: the handle-queue-driven
            # upscale in serve/_private/autoscaling_policy.py). A False
            # verdict means the deployment doesn't exist (deleted/typo) —
            # fail fast instead of burning the cold-start window.
            woke = False
            try:
                ctrl = _get_controller()
                woke = ray_tpu_torch.get(ctrl.request_scale_up.remote(
                    self.deployment_name), timeout=30)
            except Exception as e:
                # No verdict = no cold-start wait below; surface why the
                # scale-to-zero wake-up couldn't be requested.
                logger.warning("scale-up request for %s failed: %s",
                               self.deployment_name, e)
            deadline = time.monotonic() + self.COLD_START_TIMEOUT_S
            while woke and time.monotonic() < deadline:
                time.sleep(0.5)
                try:
                    self._refresh(force=True)
                except Exception:  # graftlint: disable=EXC-SWALLOW (cold-start poll: retried until the deadline)
                    continue
                with self._lock:
                    replicas = self._alive(self._replicas)
                if replicas:
                    break
        if not replicas:
            raise RuntimeError(
                f"no replicas for deployment {self.deployment_name!r}"
            )
        return self._p2c(replicas, affinity_key)

    def _row_age(self, row: dict) -> float:
        """Probe age of a pushed load row, skew-free: (table build time
        − probe time) on the CONTROLLER's clock, plus local monotonic
        time since the table arrived — both same-clock differences, so
        cross-node wall-clock skew can't silently mark every probe
        stale (disabling blended routing and shedding) or fresh-forever.
        Falls back to a local wall-clock diff when no table receipt is
        recorded (rows injected directly, e.g. tests)."""
        ts = float(row.get("ts") or 0.0)
        ref = self._loads_ref
        if ref is not None:
            tbl_ts, received = ref
            return max(0.0, tbl_ts - ts) + (time.monotonic() - received)
        return max(0.0, time.time() - ts)

    def _blended(self, replica) -> float:
        """Blended load score: handle-local in-flight plus the replica's
        last-probed ongoing (inflight + queued), weighted down linearly
        with probe age so a stale probe decays to the local-only signal
        instead of blackholing traffic on old news."""
        aid = replica._actor_id
        with self._lock:
            local = self._local_inflight.get(aid.binary(), 0)
            row = self._loads.get(aid.hex())
        if row is None:
            return float(local)
        w = max(0.0, 1.0 - self._row_age(row) / self._load_stale_s)
        return local + w * float(row.get("ongoing", 0.0))

    def _p2c(self, replicas: list, affinity_key: bytes | None = None):
        """Replica selection per serve_router_policy.

        p2c_local: power-of-two-choices on the handle's OWN outstanding
        counts — byte-for-byte the legacy router, no per-request RPC.
        p2c_load: the same two random choices compared on the BLENDED
        score (_blended) so cluster-wide queue depth steers the pick.
        affinity: the rendezvous-hashed preferred replica for the
        request's prefix key, unless its blended load crossed the spill
        threshold — then fall through to the p2c_load pick (affinity
        never defeats load balancing)."""
        import random

        if len(replicas) == 1:
            return replicas[0]
        if affinity_key is not None and self._policy == "affinity":
            pref = _rendezvous(affinity_key, replicas)
            head = affinity_key.hex()[:16]
            with self._lock:
                summaries = self._kv_summaries
            if summaries and head not in summaries.get(
                    pref._actor_id.hex(), ()):
                # Pushed-summary override: the rendezvous pick never
                # donated this chain, but another replica advertises it
                # — route to the least-loaded holder (its pages adopt
                # or its cache is warm either way), under the SAME
                # spill threshold so a hot holder never beats load
                # balancing. A stale summary just sends the request
                # somewhere it re-prefills — the ladder's fallback rung
                # keeps it correct.
                holders = [r for r in replicas
                           if head in summaries.get(
                               r._actor_id.hex(), ())]
                if holders:
                    best = min(holders, key=self._blended)
                    if self._blended(best) < self._spill_ongoing:
                        return best
            if self._blended(pref) < self._spill_ongoing:
                return pref
            # Preferred replica is hot: spill to the load-balanced pick.
        a, b = random.sample(replicas, 2)
        if self._policy == "p2c_local":
            with self._lock:
                la = self._local_inflight.get(a._actor_id.binary(), 0)
                lb = self._local_inflight.get(b._actor_id.binary(), 0)
            return a if la <= lb else b
        return a if self._blended(a) <= self._blended(b) else b

    def try_pick_replica(self, affinity_key: bytes | None = None):
        """Non-blocking replica pick: a replica when the route cache is
        fresh and has live replicas, else None (caller falls back to the
        blocking _pick_replica off-loop). The async ingress fast path."""
        with self._lock:
            stale = (
                self._version < _pushed_version()
                or time.monotonic() - self._last_refresh > self.REFRESH_TTL_S
            )
            replicas = [] if stale else self._alive(self._replicas)
        if not replicas:
            return None
        return self._p2c(replicas, affinity_key)

    def affinity_key(self, payload) -> bytes | None:
        """Prefix-affinity key for a request payload (None unless the
        policy is `affinity` and the payload carries prompt_ids): the
        chunk-chain head digest, so equal prefixes rendezvous to the
        replica whose prefix cache is already warm."""
        if self._policy != "affinity" or not isinstance(payload, dict):
            return None
        ids = payload.get("prompt_ids")
        if not ids:
            return None
        from ray_tpu_torch.serve.prefix_cache import affinity_key as _akey

        try:
            return _akey(ids, self._affinity_chunk)
        except Exception as e:
            # Unhashable payload (wrong dtype/shape): route by load.
            logger.debug("affinity key failed (routing by load): %s", e)
            return None

    def kv_hint(self, payload):
        """Descriptor-less adoption hint: when ``payload``'s chain head
        appears in ANY replica's pushed summary, return a copy carrying
        ``kv={"discover": True}`` — the engine's adopt-plan walks the
        store index for it at admission instead of cold-prefilling.
        Zero request-path RPCs: the summary union is a local set
        refreshed by the routing push, and a false positive (swept or
        evicted donation) falls through the byte-exact adoption ladder
        to a plain re-prefill. Payloads that already carry a descriptor
        (handoff/drain continuations) pass through untouched — the
        descriptor is strictly richer. Works under EVERY router policy
        (discovery is about where pages ARE, not where requests go)."""
        if (not isinstance(payload, dict) or payload.get("kv")
                or not payload.get("prompt_ids")):
            return payload
        with self._lock:
            warm = self._kv_warm
        if not warm:
            return payload
        from ray_tpu_torch.serve.prefix_cache import affinity_key as _akey

        try:
            head = _akey(payload["prompt_ids"],
                         self._affinity_chunk).hex()[:16]
        except Exception as e:
            # Unhashable payload (wrong dtype/shape): no hint.
            logger.debug("kv hint skipped: %s", e)
            return payload
        if head not in warm:
            return payload
        out = dict(payload)
        out["kv"] = {"discover": True}
        return out

    def shed_verdict(self) -> dict | None:
        """Overload-shed gate for the ingress: a verdict dict when new
        work should be shed, else None. Sheds ONLY when the autoscaler
        reports the recommendation pinned at max_replicas (pushed with
        the routing table) AND every FRESH-probed replica's queue depth
        exceeds serve_overload_queue_depth — scaling can't absorb more
        and queues are past the knee, so bounded degradation (typed 503
        + Retry-After at the proxy) beats unbounded TTFT burn. Stale
        probes never shed: no fresh evidence, no degradation."""
        if self._shed_queue_depth <= 0:
            return None
        with self._lock:
            if not self._overload_pinned or not self._loads:
                return None
            rows = list(self._loads.values())
        fresh = [r for r in rows
                 if self._row_age(r) <= self._load_stale_s]
        if not fresh:
            return None
        qmin = min(float(r.get("queue_depth", 0.0)) for r in fresh)
        if qmin <= self._shed_queue_depth:
            return None
        return {"retry_after_s": self._shed_retry_after_s,
                "queue_depth_min": qmin}

    def _track(self, aid: bytes, ref) -> None:
        """Count a dispatch against `aid` until its result ref resolves."""
        from ray_tpu_torch import api as _api

        with self._lock:
            self._local_inflight[aid] = self._local_inflight.get(aid, 0) + 1

        def _done(_f):
            with self._lock:
                n = self._local_inflight.get(aid, 0)
                if n <= 1:
                    self._local_inflight.pop(aid, None)
                else:
                    self._local_inflight[aid] = n - 1

        try:
            client = _api._client
            if client is None:
                raise RuntimeError("client torn down mid-dispatch")
            client.get_future(ref).add_done_callback(_done)
        except Exception:  # graftlint: disable=EXC-SWALLOW
            # Client torn down mid-dispatch: settle the inflight counter
            # immediately so the p2c signal can't leak a phantom request.
            _done(None)

    def remote(self, *args, **kwargs):
        return self.method("__call__", *args, **kwargs)

    def dispatch(self, replica, method_name: str, args: tuple,
                 kwargs: dict):
        """Submit one request to a chosen replica, tracked for the local
        p2c in-flight signal. The single definition of the dispatch
        envelope — handle.method/stream and the ingress proxy all route
        through it."""
        ref = replica.handle_request.remote(method_name, args, kwargs)
        self._track(replica._actor_id.binary(), ref)
        return ref

    def method(self, method_name: str, *args, **kwargs):
        # Dict payloads with prompt_ids rendezvous-route under the
        # affinity policy; everything else picks by load. The warm-
        # discovery hint rides the same payload (kv_hint — no-op
        # unless a pushed summary says the prefix is donated somewhere);
        # it is computed AFTER the pick so a stale handle hints from the
        # refreshed summary, not the pre-refresh one (stream() orders
        # the same way).
        key = self.affinity_key(args[0]) if args else None
        replica = self._pick_replica(key)
        if args:
            hinted = self.kv_hint(args[0])
            if hinted is not args[0]:
                args = (hinted,) + args[1:]
        return self.dispatch(replica, method_name, args, kwargs)

    def stream(self, request: dict, *,
               submit_method: str = "submit_stream",
               poll_method: str = "stream_read",
               poll_timeout_s: float = 0.25,
               deadline_s: float = 600.0):
        """Incremental results from a streaming deployment (e.g. the LLM
        engine's per-token stream): yields items as the replica produces
        them instead of buffering the full response. Protocol:
        `submit_method(request) -> stream_id`, then
        `poll_method(stream_id, cursor, timeout) ->
        {"tokens": [...], "done": bool, ...}` long-polled until done.

        The stream pins to ONE replica (cursor state lives there) until
        that replica dies or drains; then the already-yielded tokens are
        resubmitted teacher-forced (`generated_ids`) to a re-picked
        replica and the stream resumes at the same cursor — callers see
        an uninterrupted item sequence (cursor-exact splice, same
        contract as the async proxy's SSE failover)."""
        import ray_tpu_torch
        from ray_tpu_torch.core.config import runtime_config

        attempts = max(0, runtime_config().serve_failover_attempts)

        def gen():
            import time as _time

            from ray_tpu_torch.serve.http_proxy import (_FAILOVERS, _HANDOFFS,
                                                  absorb_handoff,
                                                  failover_mode)

            emitted: list = []
            budget = attempts
            hops = 0
            t_end = _time.monotonic() + deadline_s
            replica = None
            sid = None
            cur = self        # current handle: a pool handoff switches it
            handles = {self.deployment_name: self}
            # Resume context from a donor's handoff/export: the KV
            # page-set descriptor + memoized hash chain ride every
            # resubmit, so the destination engine walks the adoption
            # ladder instead of unconditionally re-prefilling.
            carry: dict = {}
            # Prefix affinity holds for the FIRST placement only: a
            # resume after death/drain re-picks purely by load (the
            # preferred replica just proved unreliable, and the
            # teacher-forced re-prefill works anywhere).
            key = self.affinity_key(request)

            def _call(replica, method, *call_args):
                # Tracked like method() dispatches: long token streams
                # must weigh on the local p2c signal.
                return cur.dispatch(replica, method, call_args, {})

            def _resume(mode: str, victim, dead: bool = False) -> bool:
                # Mirrors HTTPProxy._stream_sse._failover — the protocol
                # invariants live in that docstring; keep both in sync.
                # Only a CONFIRMED death (ActorDiedError) may seed the
                # process-wide dead set.
                nonlocal budget, sid, key
                if budget <= 0:
                    return False
                budget -= 1
                if victim is not None:
                    cur.evict_replica(victim, dead=dead)
                _FAILOVERS.inc(1.0, tags={
                    "route": self.deployment_name,
                    "mode": f"stream_{mode}"})
                sid = None
                key = None          # failover re-picks by load
                return True

            def _absorb_handoff(out) -> str | None:
                # → destination deployment name for a pool handoff,
                # else None; updates the resume context either way
                # (absorb_handoff is THE one copy of the transfer).
                return absorb_handoff(out.get("handoff"), carry)

            while True:
                try:
                    if sid is None:
                        replica = cur._pick_replica(key)
                        req = dict(request)
                        req.update(carry)
                        # Warm-discovery hint (no-op when a handoff/
                        # export descriptor already rides in carry).
                        req = cur.kv_hint(req)
                        if emitted:
                            req["generated_ids"] = list(emitted)
                        sid = ray_tpu_torch.get(
                            _call(replica, submit_method, req),
                            timeout=deadline_s)
                        cursor = len(emitted)
                    out = ray_tpu_torch.get(
                        _call(replica, poll_method, sid, cursor,
                              poll_timeout_s),
                        timeout=60)
                except Exception as e:  # noqa: BLE001 — classified below
                    from ray_tpu_torch.serve.http_proxy import confirmed_dead

                    mode = failover_mode(e)
                    if mode is not None and _resume(mode, replica,
                                                    confirmed_dead(e)):
                        continue
                    raise
                for tok in out["tokens"]:
                    yield tok
                emitted.extend(out["tokens"])
                cursor += len(out["tokens"])
                err = out.get("error")
                if err:
                    if "unknown stream" in err and _resume("death", replica):
                        continue
                    raise RuntimeError(err)
                if out.get("done"):
                    if out.get("migrated"):
                        peer = _absorb_handoff(out)
                        if peer is not None:
                            if hops >= 4:
                                # Pool ring: the typed loop error (like
                                # the unary paths) — never drain
                                # failover chasing the ring.
                                raise RuntimeError(
                                    "pool handoff loop: stream still "
                                    f"migrating after {hops} hops "
                                    "(check pool_role/pool_peer "
                                    "wiring)")
                            # Pool handoff (prefill → decode): the
                            # NORMAL path of a split deployment, not a
                            # failure — no failover budget spent.
                            hops += 1
                            if peer not in handles:
                                handles[peer] = DeploymentHandle(peer)
                            cur = handles[peer]
                            sid = None
                            key = None
                            _HANDOFFS.inc(1.0, tags={
                                "route": self.deployment_name})
                            continue
                        if _resume("drain", replica):
                            continue
                        raise RuntimeError(
                            "replica drained; failover budget exhausted")
                    return
                if _time.monotonic() > t_end:
                    raise TimeoutError(f"stream {sid} exceeded deadline")

        return gen()

    def __reduce__(self):
        # Handles travel into replica constructors (deployment graphs);
        # routing state (locks, caches) rebuilds in the destination process.
        return (DeploymentHandle, (self.deployment_name,))

    def __eq__(self, other):
        # Identity == target deployment (matches __reduce__): the controller
        # compares init_args on redeploy to detect idempotent graph re-runs —
        # without this, every _resolve_graph pass builds fresh handle
        # instances and healthy replicas of shared diamond children would be
        # rolled on each run.
        return (isinstance(other, DeploymentHandle)
                and other.deployment_name == self.deployment_name)

    def __hash__(self):
        return hash(("DeploymentHandle", self.deployment_name))


def _resolve_graph(args, kwargs, *, blocking: bool, deadline: float):
    """Deployment-graph composition (ref: serve DAG API, serve/dag.py):
    Deployment instances bound as init args deploy first (depth-first) and
    are replaced by handles, so a deployment's constructor receives live
    DeploymentHandles to its dependencies. Children deploy WITHOUT an HTTP
    route (only the ingress is routable) and share the caller's deadline."""

    def sub(v):
        if isinstance(v, Deployment):
            child = v.options(route_prefix=None)  # internal: not routable
            return run(child, _blocking_until_ready=blocking,
                       _deadline=deadline)
        if isinstance(v, (list, tuple)):
            return type(v)(sub(x) for x in v)
        if isinstance(v, dict):
            return {k: sub(x) for k, x in v.items()}
        return v

    return tuple(sub(a) for a in args), {k: sub(v)
                                         for k, v in (kwargs or {}).items()}


def _replica_resources(opts: dict | None) -> dict | None:
    """A replica actor's resources from `ray_actor_options`: the
    ``resources`` dict, ``num_cpus`` as "CPU" and ``num_gpus`` as "GPU"
    (the resource `remote(num_gpus=...)` asks for, so a replica that
    asks for a GPU is never placed without one). ``num_tpus`` raises:
    the port has no TPU resource, and dropping the key would place the
    replica on any node."""
    if not opts:
        return None
    if "num_tpus" in opts:
        raise ValueError(
            "ray_actor_options['num_tpus'] is not supported: the port "
            "schedules GPUs (ask for num_gpus)")
    resources = dict(opts.get("resources", {}) or {})
    if "num_cpus" in opts:
        resources["CPU"] = opts["num_cpus"]
    if "num_gpus" in opts:
        resources["GPU"] = float(opts["num_gpus"])
    return resources


def run(target: Deployment, *, name: str | None = None,
        route_prefix: str | None = None, _blocking_until_ready: bool = True,
        timeout: float = 120.0,
        _deadline: float | None = None) -> DeploymentHandle:
    # Before the controller boots: a request the cluster can never meet
    # fails here, not as a replica that stays pending.
    resources = _replica_resources(target.ray_actor_options)
    ctrl = _get_controller(create=True)
    deadline = _deadline if _deadline is not None else (
        time.monotonic() + timeout)

    def remaining(cap: float = 120.0) -> float:
        return max(0.5, min(cap, deadline - time.monotonic()))

    dep = target
    if name is not None:
        dep = dep.options(name=name)
    if route_prefix is not None:
        dep = dep.options(route_prefix=route_prefix)
    init_args, init_kwargs = _resolve_graph(
        dep.init_args, dep.init_kwargs,
        blocking=_blocking_until_ready, deadline=deadline)
    dep = dep.options(init_args=init_args, init_kwargs=init_kwargs)
    cls_blob = serialization.pack(dep.func_or_class)
    deployed_at = time.time()
    if dep.pool_role not in (None, "prefill", "decode"):
        raise ValueError(
            f"pool_role must be None|'prefill'|'decode', got "
            f"{dep.pool_role!r}")
    ray_tpu_torch.get(ctrl.deploy.remote(
        dep.name, cls_blob, dep.init_args, dep.init_kwargs,
        dep.num_replicas, dep.route_prefix, resources,
        dep.max_concurrent_queries, dep.user_config,
        dep.autoscaling_config, dep.pool_role,
    ), timeout=remaining())
    handle = DeploymentHandle(dep.name)
    if _blocking_until_ready:
        while time.monotonic() < deadline:
            deps = ray_tpu_torch.get(ctrl.list_deployments.remote(),
                               timeout=remaining(30.0))
            info = deps.get(dep.name)
            if info and info["live_replicas"] >= info["num_replicas"]:
                break
            err = _start_error(dep.name, deployed_at)
            if err is not None and not (info or {}).get("live_replicas"):
                # A constructor that raised (a replica asked for a GPU
                # it cannot see, a bad checkpoint) fails the same way on
                # every respawn: stop the deployment and say why.
                try:
                    delete(dep.name)
                except Exception as e:  # noqa: BLE001 — the raise below is the report
                    logger.debug("delete of failed %s: %s", dep.name, e)
                raise RuntimeError(
                    f"deployment {dep.name} failed to start: {err}")
            time.sleep(0.2)
        else:
            raise TimeoutError(f"deployment {dep.name} not ready")
    return handle


START_ERRORS_NS = "serve_start_errors"


def _start_error(name: str, since: float) -> str | None:
    """The newest replica constructor failure of deployment ``name``
    reported at or after ``since`` (wall clock), else None (see
    `replica.Replica`)."""
    import json

    from ray_tpu_torch import api as _api

    client = _api._client
    if client is None:
        return None
    try:
        raw = client.kv_get(START_ERRORS_NS, name.encode())
        row = json.loads(raw) if raw else None
    except Exception:  # noqa: BLE001 — no report reads as none yet
        return None
    if not row or row.get("ts", 0.0) < since:
        return None
    return row.get("error")


def get_deployment_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name)


def delete(name: str) -> None:
    ctrl = _get_controller()
    ray_tpu_torch.get(ctrl.delete_deployment.remote(name), timeout=60)


def status() -> dict:
    ctrl = _get_controller()
    return ray_tpu_torch.get(ctrl.list_deployments.remote(), timeout=30)


# ---------------------------------------------------------------- batching

def batch(_func=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """@serve.batch: concurrent calls buffer into one list-in/list-out call
    (ref: serve/batching.py). The wrapped fn receives a list of inputs and
    must return a list of outputs of equal length."""

    def deco(fn):
        # Per-process state, created lazily inside the replica — threading
        # primitives must not be captured at decoration time (the deployment
        # class is cloudpickled to replicas).
        def _state():
            st = wrapper.__dict__.get("_batch_state")
            if st is None:
                # dict.setdefault is atomic under the GIL — exactly one
                # candidate state wins even under concurrent first calls
                st = wrapper.__dict__.setdefault(
                    "_batch_state",
                    {"buf": [], "lock": threading.Lock(), "timer": None},
                )
            return st

        class _Slot:
            __slots__ = ("event", "result", "error")

            def __init__(self):
                self.event = threading.Event()
                self.result = None
                self.error = None

        def flush():
            state = _state()
            with state["lock"]:
                buf, state["buf"] = state["buf"], []
                state["timer"] = None
            if not buf:
                return
            self_obj = buf[0][0]
            inputs = [a for _, a, _ in buf]
            try:
                outputs = (
                    fn(self_obj, inputs) if self_obj is not None else fn(inputs)
                )
                if len(outputs) != len(inputs):
                    raise ValueError(
                        f"batched fn returned {len(outputs)} outputs for "
                        f"{len(inputs)} inputs"
                    )
                for (_, _, slot), out in zip(buf, outputs):
                    slot.result = out
                    slot.event.set()
            except Exception as e:
                for _, _, slot in buf:
                    slot.error = e
                    slot.event.set()

        def wrapper(*call_args):
            # supports both plain functions fn(items) and methods
            # fn(self, items): the per-call payload is the last positional arg
            if len(call_args) == 2:
                self_obj, arg = call_args
            elif len(call_args) == 1:
                self_obj, arg = None, call_args[0]
            else:
                raise TypeError("@serve.batch functions take exactly one arg")
            slot = _Slot()
            do_flush = False
            state = _state()
            with state["lock"]:
                state["buf"].append((self_obj, arg, slot))
                if len(state["buf"]) >= max_batch_size:
                    do_flush = True
                elif state["timer"] is None:
                    state["timer"] = threading.Timer(
                        batch_wait_timeout_s, flush
                    )
                    state["timer"].daemon = True
                    state["timer"].start()
            if do_flush:
                flush()
            slot.event.wait()
            if slot.error is not None:
                raise slot.error
            return slot.result

        wrapper.__name__ = getattr(fn, "__name__", "batched")
        wrapper._batched = True
        return wrapper

    if _func is not None:
        return deco(_func)
    return deco
