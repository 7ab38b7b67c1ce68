"""Replica actor: hosts one copy of a deployment's callable.

Parity: `python/ray/serve/_private/replica.py` — wraps the
user class/function, counts in-flight queries (for power-of-two routing),
applies reconfigure(user_config), and reports health.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any

from ray_tpu_torch import chaos as _chaos
from ray_tpu_torch import profiling, tracing
from ray_tpu_torch.core import serialization

logger = logging.getLogger(__name__)

_EXEC_LATENCY = profiling.Histogram(
    "serve_replica_execute_s",
    description="Replica user-code execution time per request",
    boundaries=profiling.LATENCY_BUCKETS_S,
    tag_keys=("deployment",))

# Methods a DRAINING replica still serves: stream readers must drain
# their cursors (stream_read) and the control plane must keep observing
# the replica; everything else is new work and is rejected so the
# caller's failover re-picks a live replica.
_DRAIN_ALLOWED = frozenset((
    "stream_read", "health", "stats", "metrics", "load_snapshot",
    "num_inflight",
))


def _report_start_error(deployment_name: str | None, exc: Exception) -> None:
    """Record a constructor failure where `serve.run` looks for it (GCS
    KV ``serve_start_errors``, keyed by deployment): the actor's death
    alone says only that its creation failed. Best effort."""
    if deployment_name is None:
        return
    try:
        import json

        from ray_tpu_torch import api as _api
        from ray_tpu_torch.serve.api import START_ERRORS_NS

        client = _api._client
        if client is not None:
            client.kv_put(START_ERRORS_NS, deployment_name.encode(),
                          json.dumps({"error": f"{type(exc).__name__}: "
                                               f"{exc}",
                                      "ts": time.time()}).encode())
    except Exception as e:  # noqa: BLE001 — the raise is the real report
        logger.debug("start error of %s not recorded: %s",
                     deployment_name, e)


class Replica:
    def __init__(self, cls_blob: bytes, init_args: tuple, init_kwargs: dict,
                 user_config: Any = None, deployment_name: str | None = None):
        target = serialization.unpack(cls_blob)
        if isinstance(target, type):
            try:
                self.callable = target(*init_args, **(init_kwargs or {}))
            except Exception as e:
                _report_start_error(deployment_name, e)
                raise
        else:
            self.callable = target
        self._inflight = 0
        self._lock = threading.Lock()
        self._processed = 0
        self._draining = False
        # Idle clock for scale-to-zero: time since the last request
        # FINISHED (or since construction) — a freshly cold-started replica
        # reads as "busy" until the waking request has had its chance.
        self._last_active = time.monotonic()
        if user_config is not None:
            self.reconfigure(user_config)
        if deployment_name is not None:
            self._deployment_name = deployment_name
            # Read the actor id HERE: __init__ runs in the creation task's
            # context (the ContextVar is set); a fresh thread starts with an
            # empty context and would see None.
            from ray_tpu_torch import api as _api

            my_id = _api.get_runtime_context().get_actor_id()
            t = threading.Thread(
                target=self._membership_loop, args=(my_id,), daemon=True)
            t.start()

    def _membership_loop(self, my_id: str | None) -> None:
        """Orphan self-drain: a replica spawned right before a controller
        crash may be missing from the restored checkpoint — the restarted
        controller spawns replacements and this actor would serve (and hold
        resources) forever. Each replica therefore periodically asks the
        controller whether it is still a member of its deployment; two
        consecutive "no"s → exit. Controller unreachable (dead / mid-restart)
        → keep serving: routes must survive a controller outage."""
        import os
        import time

        import ray_tpu_torch

        if my_id is None:
            return  # not running inside an actor (unit tests) — no verdicts
        strikes = 0
        while True:
            time.sleep(5.0)
            try:
                from ray_tpu_torch.serve.api import CONTROLLER_NAME

                ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
                ok = ray_tpu_torch.get(
                    ctrl.is_member.remote(self._deployment_name, my_id),
                    timeout=10)
            except Exception:  # graftlint: disable=EXC-SWALLOW (no verdict without a healthy controller; keep serving is the designed outcome)
                strikes = 0
                continue
            strikes = strikes + 1 if not ok else 0
            if strikes >= 2:
                # Drain before exiting: a saturated-but-healthy replica can
                # be dropped by a timed-out health probe — its in-flight
                # requests must complete (bounded wait; the routing table
                # already stopped sending new work here).
                deadline = time.monotonic() + 120
                while self._inflight > 0 and time.monotonic() < deadline:
                    time.sleep(0.5)
                os._exit(0)

    def health(self) -> bool:
        _chaos.hit("serve.replica.probe")
        return True

    def drain(self, timeout_s: float | None = None) -> dict:
        """Drain protocol (controller scale-down / version roll): stop
        admitting new work, give in-flight requests up to `timeout_s` to
        finish, and report what remains. A callable exposing drain()
        (e.g. LLMDeployment) runs its own protocol first — finishing or
        exporting live decodes as resumable continuations — then the
        generic in-flight wait covers whatever handle_request calls are
        still unwinding. The controller hard-kills the actor only after
        this returns (or after the deadline passes without an answer)."""
        from ray_tpu_torch.core.config import runtime_config

        if timeout_s is None:
            timeout_s = runtime_config().serve_drain_timeout_s
        self._draining = True
        deadline = time.monotonic() + max(0.0, timeout_s)
        info: dict = {}
        fn = getattr(self.callable, "drain", None)
        if fn is not None:
            try:
                info = dict(fn(timeout_s) or {})
            except Exception as e:
                # The generic in-flight wait below still bounds the
                # drain; a broken user drain() must not wedge scale-down.
                logger.warning("callable drain() failed on %s: %s",
                               type(self.callable).__name__, e)
                info = {"drain_error": str(e)}
        while time.monotonic() < deadline:
            with self._lock:
                n = self._inflight
            if n <= 0:
                break
            time.sleep(0.05)
        with self._lock:
            n = self._inflight
        info["inflight"] = n
        info.setdefault("exported", 0)
        info["drained"] = n <= 0 and not info.get("drain_error") and (
            info.get("drained", True))
        return info

    def install_chaos(self, rules) -> bool:
        """Arm a chaos spec in THIS replica process (fault-injection
        tests target one victim of a fleet; see ray_tpu_torch/chaos.py)."""
        _chaos.install(rules)
        return True

    def reconfigure(self, user_config: Any) -> bool:
        fn = getattr(self.callable, "reconfigure", None)
        if fn is not None:
            fn(user_config)
        return True

    def num_inflight(self) -> int:
        return self._inflight

    def stats(self) -> dict:
        _chaos.hit("serve.replica.probe")
        # Live engine load (flight recorder): a callable exposing
        # load_snapshot() — e.g. LLMDeployment — rides its numbers on the
        # controller's existing stats probe, no extra RPC.
        load = None
        fn = getattr(self.callable, "load_snapshot", None)
        if fn is not None:
            try:
                load = fn()
            except Exception as e:
                # Load is advisory; the probe must still answer (it
                # doubles as the replica health verdict).
                logger.warning("load_snapshot failed on %s: %s",
                               type(self.callable).__name__, e)
        with self._lock:
            idle = (0.0 if self._inflight > 0
                    else time.monotonic() - self._last_active)
            out = {"inflight": self._inflight,
                   "processed": self._processed,
                   "idle_s": idle,
                   # The replica's process (the load table names it, so
                   # an operator or a fault drill can find its worker).
                   "pid": os.getpid()}
        if load is not None:
            out["load"] = load
        return out

    def handle_request(self, method: str, args: tuple, kwargs: dict):
        _chaos.hit("serve.replica.request")
        if (self._draining and method not in _DRAIN_ALLOWED
                and hasattr(self.callable, "drain")):
            # Admission stopped: the caller's failover path re-picks a
            # live replica ("draining" in the message is the contract).
            # Only a callable with its own drain protocol (an engine
            # exporting its streams) stops admitting: a plain one keeps
            # serving until it is killed, since the controller sends the
            # drain before handles get the routes push that drops this
            # replica, and a unary handle call has no failover. Its drain
            # still waits for every call in flight.
            raise RuntimeError(
                f"replica draining: rejecting {method!r} — resubmit to "
                "another replica")
        dep = getattr(self, "_deployment_name", None) or type(
            self.callable).__name__
        with self._lock:
            self._inflight += 1
        t0 = time.time()
        try:
            # Child span of the proxy's request span (the actor-task hop
            # restored the ambient context): user-code execution, separated
            # from the dispatch/queue time the outer spans carry.
            with tracing.start_span(f"replica:{dep}.{method}", cat="serve"):
                if method == "__call__":
                    return self.callable(*args, **kwargs)
                return getattr(self.callable, method)(*args, **kwargs)
        finally:
            _EXEC_LATENCY.observe(time.time() - t0,
                                  tags={"deployment": dep})
            with self._lock:
                self._inflight -= 1
                self._processed += 1
                self._last_active = time.monotonic()
