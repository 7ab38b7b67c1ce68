"""Node daemon ("raylet"): worker pool + lease scheduling + object plane.

Parity with the reference's per-node NodeManager (`src/ray/
raylet/node_manager.h:144`): worker leasing with spillback
(`HandleRequestWorkerLease`, node_manager.cc:1880), a worker pool that spawns/
reuses processes (`worker_pool.cc`), the local object store (plasma; here
object_store.py), chunked node-to-node object transfer
(`object_manager.proto:63-65`), and heartbeats to the GCS.

Scheduling is the reference's hybrid policy (`raylet/scheduling/policy/
hybrid_scheduling_policy.h:24-47`): grant locally while local utilization is
below a threshold; otherwise spill to the least-loaded feasible node.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any

from ray_tpu_torch.core import rpc, serialization
from ray_tpu_torch.core.config import Config
from ray_tpu_torch.core.ids import NodeID, ObjectID, WorkerID
from ray_tpu_torch.core.object_store import LocalObjectStore
from ray_tpu_torch.utils.aio import spawn

logger = logging.getLogger(__name__)


@dataclass
class WorkerHandle:
    worker_id: bytes
    pid: int
    address: tuple[str, int] | None = None   # worker's RPC server
    conn: rpc.Connection | None = None       # raylet→worker connection
    idle: bool = True
    actor_id: bytes | None = None            # pinned if hosting an actor
    lease_resources: dict[str, float] = field(default_factory=dict)
    lease_retriable: bool = True             # current task can retry (OOM kill)
    bundle_key: tuple | None = None          # (pg_id, index) when PG-backed
    started: float = field(default_factory=time.monotonic)
    leased_at: float = 0.0                   # when the current lease was granted
    env_key: str = ""                        # pip-env digest ("" = base image)
    proc: Any = None


@dataclass
class LeaseRequest:
    resources: dict[str, float]
    strategy: Any
    future: asyncio.Future
    bundle_key: tuple | None = None          # grant from this PG bundle
    retriable: bool = True                   # OOM-kill preference hint
    env_key: str = ""                        # pip-env digest
    pip_env: dict | None = None              # build recipe for env_key
    enqueued: float = field(default_factory=time.monotonic)
    # No live node can run it; it waits for a node the autoscaler launches.
    infeasible: bool = False


class Raylet:
    def __init__(
        self,
        config: Config,
        gcs_address: tuple[str, int],
        resources: dict[str, float],
        host: str = "127.0.0.1",
        port: int = 0,
        session_dir: str | None = None,
        labels: dict[str, str] | None = None,
    ):
        self.config = config
        self.node_id = NodeID.from_random().binary()
        self.gcs_address = gcs_address
        self.resources_total = dict(resources)
        self.resources_available = dict(resources)
        self.labels = labels or {}
        self.server = rpc.Server(host, port)
        self.session_dir = session_dir or os.path.join(
            config.session_dir, "session-default"
        )
        os.makedirs(self.session_dir, exist_ok=True)
        self.store = LocalObjectStore(
            NodeID(self.node_id).hex(),
            config,
            os.path.join(self.session_dir, config.spill_dir,
                         NodeID(self.node_id).hex()[:8]),
        )
        self.workers: dict[bytes, WorkerHandle] = {}
        # conn id → {(ObjectID, entry generation): pin count}. Generation-
        # tagged so a reader's unpin releases exactly the extent it mmap'd —
        # never another connection's zombie (freed+re-created) extent.
        self._conn_pins: dict[int, dict] = {}
        self.lease_queue: list[LeaseRequest] = []
        self._env_spawning: set[str] = set()   # pip envs being built
        # (pg_id, bundle_index) → {"total": res, "free": res}. Reserved out
        # of resources_available via the GCS 2PC (ref: node_manager.proto:
        # 377-384 PrepareBundle/CommitBundle).
        self.pg_bundles: dict[tuple, dict] = {}
        self.gcs: rpc.Connection | None = None
        self.cluster_view: dict[bytes, dict] = {}
        self._pulls_inflight: dict[bytes, asyncio.Future] = {}
        self._pull_bytes = 0          # admission accounting (bytes in flight)
        self._pull_waiters: list = []  # FIFO of (size, future)
        # Outbound serve slots per object: token → expiry deadline.
        # Bounding concurrent readers per object turns an N-node broadcast
        # into a fan-out TREE — rejected pullers retry the directory, where
        # freshly-completed pullers have registered as new holders, so a
        # hot object propagates O(log N) waves deep instead of N serial
        # reads off one node (ref: push_manager.h:29 push dedup/fanout).
        self._serve_slots: dict[bytes, dict[str, float]] = {}
        self._peer_conns: dict[tuple[str, int], rpc.Connection] = {}
        self._shutdown = False
        self._view_seen = 0            # last applied cluster-view version
        self._register_handlers()

    # ------------------------------------------------------------------ setup

    def _register_handlers(self) -> None:
        s = self.server
        # worker lifecycle
        s.register("register_worker", self._h_register_worker)
        # leasing
        s.register("request_lease", self._h_request_lease)
        s.register("release_lease", self._h_release_lease)
        # object plane (local clients)
        s.register("store_create", self._h_store_create)
        s.register("store_seal", self._h_store_seal)
        s.register("store_put_inline", self._h_store_put_inline)
        s.register("store_put_data", self._h_store_put_data)
        s.register("store_create_remote", self._h_store_create_remote)
        s.register("store_write_chunk", self._h_store_write_chunk)
        s.register("store_seal_remote", self._h_store_seal_remote)
        s.register("store_get", self._h_store_get)
        s.register("store_contains", self._h_store_contains)
        s.register("store_free", self._h_store_free)
        s.register("store_release", self._h_store_release)
        s.register("store_stats", self._h_store_stats)
        s.register("store_pin", self._h_store_pin)
        # placement groups (GCS-driven bundle reservation)
        s.register("pg_reserve", self._h_pg_reserve)
        s.register("pg_return", self._h_pg_return)
        # object plane (remote raylets)
        s.register("obj_read_chunk", self._h_obj_read_chunk)
        s.register("obj_info", self._h_obj_info)
        s.register("obj_end_read", self._h_obj_end_read)
        s.register("node_info", self._h_node_info)
        # log fetch (ref: dashboard/modules/log — browse + tail worker logs)
        s.register("log_list", self._h_log_list)
        s.register("log_fetch", self._h_log_fetch)
        s.on_disconnect(self._handle_disconnect)

    async def start(self) -> tuple[str, int]:
        addr = await self.server.start()
        self.address = addr
        async def _gcs_request(method: str, payload: Any):
            # The GCS drives raylet-side actions (bundle reservation, …)
            # back over this same connection; dispatch into the normal
            # handler table.
            fn = self.server._handlers.get(method)
            if fn is None:
                raise rpc.RpcError(f"unknown method {method!r}")
            return await fn(self.gcs, payload)

        async def _on_gcs_reconnect(conn):
            # GCS failover: re-register with held objects, re-subscribe,
            # refresh the view (ref: node_manager.proto:355
            # NotifyGCSRestart semantics, initiated from our side).
            await conn.call("register_node", self._register_payload())
            await conn.call("subscribe", {"channels": ["node"]})
            self.cluster_view = await conn.call("get_cluster_view", {})
            # The restarted GCS's view-version counter restarted too; resync
            # from zero or deltas would never ship again.
            self._view_seen = 0
            logger.info("re-registered with restarted GCS")

        self.gcs = rpc.ReconnectingConnection(
            *self.gcs_address,
            dial_timeout=self.config.rpc_connect_timeout_s,
            reconnect_window_s=self.config.gcs_reconnect_window_s,
            notify_handler=self._gcs_notify,
            request_handler=_gcs_request,
            on_reconnect=_on_gcs_reconnect,
        )
        await self.gcs.call("register_node", self._register_payload())
        await self.gcs.call("subscribe", {"channels": ["node"]})
        view = await self.gcs.call("get_cluster_view", {})
        self.cluster_view = view
        spawn(self._heartbeat_loop())
        spawn(self._reap_idle_loop())
        if self.config.memory_monitor_period_s > 0:
            spawn(self._memory_monitor_loop())
        if self.config.log_to_driver:
            spawn(self._log_monitor_loop())
        for _ in range(self.config.prestart_workers):
            self._spawn_worker()
        logger.info(
            "raylet %s up at %s resources=%s",
            NodeID(self.node_id).hex()[:8], addr, self.resources_total,
        )
        return addr

    def _register_payload(self) -> dict:
        return {
            "node_id": self.node_id,
            "address": self.address,
            "resources": self.resources_total,
            "labels": self.labels,
            "objects": [oid.binary() for oid, e in self.store.entries.items()
                        if e.sealed and not e.doomed],
        }

    def _gcs_notify(self, method: str, payload: Any) -> None:
        if method == "pub:node":
            ev = payload
            if ev["event"] == "added":
                self.cluster_view[ev["node_id"]] = {
                    "address": tuple(ev["address"]),
                    "resources_total": ev["resources"],
                    "resources_available": dict(ev["resources"]),
                    "alive": True, "load": 0, "labels": {},
                }
                self._spill_infeasible()
            elif ev["event"] == "dead":
                info = self.cluster_view.get(ev["node_id"])
                if info:
                    info["alive"] = False
        elif method == "free_objects":
            for ob in payload["object_ids"]:
                self.store.free(ObjectID(ob))

    async def _heartbeat_loop(self) -> None:
        while not self._shutdown:
            await asyncio.sleep(self.config.heartbeat_period_s)
            try:
                resp = await self.gcs.call("heartbeat", {
                    "node_id": self.node_id,
                    "resources_available": self.resources_available,
                    "load": len(self.lease_queue),
                    # Resource shapes of queued leases — the autoscaler's
                    # demand signal (ref: gcs_resource_manager.cc resource
                    # load; resource_demand_scheduler.py consumes it).
                    "pending_demand": [
                        dict(req.resources) for req in
                        list(self.lease_queue)[:100]
                    ],
                }, timeout=5.0)
                if resp.get("reregister"):
                    await self.gcs.call("register_node",
                                        self._register_payload())
                # Versioned delta sync (ref: ray_syncer.h): pull only
                # entries stamped since our last ack; an idle cluster
                # exchanges nothing beyond the heartbeat itself.
                vv = resp.get("view_version", -1)
                if vv != self._view_seen:
                    delta = await self.gcs.call(
                        "get_view_delta", {"since": self._view_seen},
                        timeout=self.config.rpc_default_timeout_s)
                    for nid, nview in delta["nodes"].items():
                        nview["address"] = tuple(nview["address"])
                        self.cluster_view[nid] = nview
                    self._view_seen = delta["version"]
                    self._spill_infeasible()
            except (rpc.ConnectionLost, asyncio.TimeoutError):
                if self._shutdown:
                    return
                logger.warning("GCS unreachable; retrying connect")
                try:
                    self.gcs = await rpc.connect(
                        *self.gcs_address,
                        timeout=self.config.gcs_register_timeout_s,
                        notify_handler=self._gcs_notify,
                    )
                    await self.gcs.call("register_node",
                                        self._register_payload())
                    await self.gcs.call("subscribe", {"channels": ["node"]})
                    # Fresh GCS, fresh version counter: full resync or the
                    # delta protocol would skip its low-stamped updates.
                    self.cluster_view = await self.gcs.call(
                        "get_cluster_view", {})
                    self._view_seen = 0
                except rpc.ConnectionLost:
                    pass

    # ------------------------------------------------------- worker pool

    def _spawn_worker(self, env_key: str = "",
                      python: str | None = None) -> WorkerHandle:
        worker_id = WorkerID.from_random().binary()
        env = dict(os.environ)
        env["RAY_TPU_TORCH_WORKER_ID"] = WorkerID(worker_id).hex()
        env["RAY_TPU_TORCH_NODE_ID"] = NodeID(self.node_id).hex()
        # Forward the full config so driver _system_config overrides reach
        # worker-side library code (config.current_config()).
        from ray_tpu_torch.core.config import CONFIG_ENV_JSON

        env[CONFIG_ENV_JSON] = self.config.to_json()
        if python is not None:
            # Venv interpreter (pip runtime env): the package isn't
            # installed into the venv — make it importable from the repo.
            import ray_tpu_torch as _pkg

            repo_root = os.path.dirname(os.path.dirname(
                os.path.abspath(_pkg.__file__)))
            env["PYTHONPATH"] = repo_root + os.pathsep + env.get(
                "PYTHONPATH", "")
        cmd = [
            python or sys.executable, "-m", "ray_tpu_torch.core.worker",
            "--raylet", f"{self.address[0]}:{self.address[1]}",
            "--gcs", f"{self.gcs_address[0]}:{self.gcs_address[1]}",
            "--node-id", NodeID(self.node_id).hex(),
            "--worker-id", WorkerID(worker_id).hex(),
            "--session-dir", self.session_dir,
        ]
        log_dir = os.path.join(self.session_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        out = open(os.path.join(log_dir, f"worker-{WorkerID(worker_id).hex()[:8]}.log"), "ab")
        proc = subprocess.Popen(cmd, env=env, stdout=out, stderr=out)
        handle = WorkerHandle(worker_id=worker_id, pid=proc.pid, proc=proc,
                              idle=False, env_key=env_key)
        self.workers[worker_id] = handle
        return handle

    def _spawn_env_worker(self, env_key: str, pip_env: dict) -> None:
        """Build the pip venv off-loop, then spawn a worker on its
        interpreter. At most one build+spawn in flight per env key — the
        registered worker pumps the lease queue."""
        if env_key in self._env_spawning:
            return
        self._env_spawning.add(env_key)

        async def build_and_spawn():
            from ray_tpu_torch.core.runtime_env import ensure_pip_env

            try:
                loop = asyncio.get_running_loop()

                def kv_get(ns, key):
                    fut = asyncio.run_coroutine_threadsafe(
                        self.gcs.call("kv_get", {"ns": ns, "key": key},
                                      timeout=120),
                        loop)
                    return fut.result(180)

                python = await asyncio.to_thread(
                    ensure_pip_env, pip_env, self.session_dir, kv_get)
                self._spawn_worker(env_key=env_key, python=python)
            except Exception as e:
                logger.error("pip env %s build failed: %s", env_key, e)
                # Fail every queued lease waiting on this env — they would
                # otherwise hang until lease timeout.
                for req in list(self.lease_queue):
                    if req.env_key == env_key and not req.future.done():
                        req.future.set_result(
                            {"error": f"runtime_env build failed: {e}"})
                        self.lease_queue.remove(req)
            finally:
                self._env_spawning.discard(env_key)

        spawn(build_and_spawn())

    async def _h_register_worker(self, conn, p):
        worker_id = p["worker_id"]
        handle = self.workers.get(worker_id)
        if handle is None:  # externally spawned (tests)
            handle = WorkerHandle(worker_id=worker_id, pid=p.get("pid", -1))
            self.workers[worker_id] = handle
        handle.address = tuple(p["address"])
        handle.conn = conn
        handle.idle = True
        self._pump_leases()
        return {"node_id": self.node_id, "ok": True}

    def _handle_disconnect(self, conn) -> None:
        # Release zero-copy read pins held by the departed client (plasma
        # releases client refs on disconnect the same way).
        for (obj, gen), n in self._conn_pins.pop(id(conn), {}).items():
            for _ in range(n):
                self.store.unpin(obj, gen)
        for wid, h in list(self.workers.items()):
            if h.conn is conn:
                logger.warning("worker %s disconnected", WorkerID(wid).hex()[:8])
                self._return_resources(h)
                self.workers.pop(wid, None)
                if h.actor_id is not None:
                    # Death notification (ref: node_manager worker-failure
                    # report → gcs_actor_manager.cc OnWorkerDead): the
                    # raylet is the FIRST to see an actor worker die — the
                    # GCS must transition the actor NOW (RESTARTING, or
                    # DEAD broadcast to every subscribed client) instead
                    # of the owner discovering the corpse one dial-timeout
                    # ladder later. Without this, an actor that dies with
                    # no call in flight keeps its stale ALIVE address in
                    # the GCS and new dispatches hang for minutes before
                    # anyone drives the restart; with it, clients get the
                    # pubsub verdict in milliseconds — ActorDiedError for
                    # non-restartable actors (Serve failover keys off
                    # this), a driven restart for restartable ones.
                    spawn(self._report_actor_death(h.actor_id))
                # Freed resources may satisfy queued lease requests; without a
                # pump they would sit until lease_timeout_s.
                self._pump_leases()

    async def _report_actor_death(self, actor_id: bytes) -> None:
        try:
            await self.gcs.call("actor_failed", {
                "actor_id": actor_id,
                "error": "actor worker process died",
                "transition_only": True,
            })
        except Exception as e:
            # The owner-side dial-failure ladder is the (slow) fallback
            # detector; losing this report only costs latency.
            logger.warning("actor death report for %s failed: %s",
                           actor_id.hex()[:8], e)

    def _return_resources(self, h: WorkerHandle) -> None:
        bundle = (self.pg_bundles.get(h.bundle_key)
                  if h.bundle_key is not None else None)
        if bundle is not None:
            for k, v in h.lease_resources.items():
                bundle["free"][k] = bundle["free"].get(k, 0) + v
        else:
            # Plain lease — or the PG was removed mid-lease, in which case
            # the bundle's reservation already went back minus this share.
            for k, v in h.lease_resources.items():
                self.resources_available[k] = (
                    self.resources_available.get(k, 0) + v)
        h.lease_resources = {}
        h.bundle_key = None

    def _kill_worker(self, h: WorkerHandle) -> None:
        """Ask an idle worker to exit and drop it from the pool now (its
        capacity slot frees immediately for a replacement spawn)."""
        if h.conn is not None:
            try:
                h.conn.notify("exit", {})
            except Exception:  # graftlint: disable=EXC-SWALLOW (worker already dead = already reaped)
                pass
        self.workers.pop(h.worker_id, None)

    async def _reap_idle_loop(self) -> None:
        while not self._shutdown:
            await asyncio.sleep(self.config.raylet_idle_reap_interval_s)
            now = time.monotonic()
            excess = [
                h for h in self.workers.values()
                if h.idle and h.actor_id is None
                and now - h.started > self.config.idle_worker_ttl_s
            ]
            min_keep = max(1, self.config.prestart_workers)
            for h in excess[: max(0, len(excess) - min_keep)]:
                if h.conn is not None:
                    h.conn.notify("exit", {})

    # ------------------------------------------------- log streaming
    # (ref: _private/log_monitor.py:100 — tail worker logs, publish via GCS
    #  pubsub so drivers print task/actor output live)

    async def _h_log_list(self, conn, p):
        """Worker/driver log files on this node (name, size, mtime)."""
        log_dir = os.path.join(self.session_dir, "logs")
        out = []
        try:
            for name in sorted(os.listdir(log_dir)):
                path = os.path.join(log_dir, name)
                try:
                    st = os.stat(path)
                except OSError:
                    continue
                out.append({"name": name, "size": st.st_size,
                            "mtime": st.st_mtime})
        except OSError:
            pass
        return out

    async def _h_log_fetch(self, conn, p):
        """Tail of one log file (bounded; name is sanitized — the log dir
        only, no path traversal)."""
        name = os.path.basename(p["name"])
        tail = min(int(p.get("tail_bytes", 64 * 1024)), 4 * 1024 * 1024)
        path = os.path.join(self.session_dir, "logs", name)
        try:
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                f.seek(max(0, size - tail))
                data = f.read(tail)
        except OSError:
            return None
        return {"name": name, "size": size,
                "data": data.decode("utf-8", "replace")}

    async def _log_monitor_loop(self) -> None:
        offsets: dict[str, int] = {}
        log_dir = os.path.join(self.session_dir, "logs")
        node_hex = NodeID(self.node_id).hex()[:8]
        while not self._shutdown:
            await asyncio.sleep(self.config.raylet_log_scan_interval_s)
            try:
                names = [n for n in os.listdir(log_dir)
                         if n.startswith("worker-")]
            except OSError:
                continue
            for name in names:
                path = os.path.join(log_dir, name)
                try:
                    size = os.path.getsize(path)
                except OSError:
                    continue
                off = offsets.get(name, 0)
                if size <= off:
                    continue
                window = 64 * 1024
                try:
                    with open(path, "rb") as f:
                        f.seek(off)
                        chunk = f.read(window)
                except OSError:
                    continue
                # Only ship complete lines; carry partials to the next tick.
                cut = chunk.rfind(b"\n")
                if cut < 0:
                    if len(chunk) >= window:
                        # A single line longer than the window would stall
                        # the tail forever: force-advance and truncate it.
                        offsets[name] = off + len(chunk)
                        chunk = chunk + b"...[truncated]\n"
                        cut = len(chunk) - 1
                    else:
                        continue
                else:
                    offsets[name] = off + cut + 1
                lines = [
                    ln for ln in
                    chunk[:cut].decode("utf-8", "replace").split("\n")
                    # framework chatter stays in the file; user prints stream
                    if ln and not ln.startswith("[worker]")
                ]
                worker_hex = name[len("worker-"):-len(".log")]
                # NOTE: the channel is cluster-scoped — with multiple
                # concurrent drivers each sees all jobs' prints (the
                # reference filters by job id; workers here are pooled
                # across jobs, so per-job attribution needs worker-side
                # tagging — future work).
                for i in range(0, len(lines), 200):
                    try:
                        await self.gcs.call("publish", {
                            "channel": "logs",
                            "message": {
                                "node": node_hex,
                                "worker": worker_hex,
                                "lines": lines[i:i + 200],
                            },
                        }, timeout=self.config.rpc_default_timeout_s)
                    except Exception as e:
                        # Dropped log batch — the monitor retries from the
                        # file offset next tick, but note the gap.
                        logger.debug("log publish failed (retry next "
                                     "tick): %s", e)
                        break

    # ------------------------------------------------- memory protection
    # (ref: common/memory_monitor.h:48 UsageAboveThreshold +
    #  raylet/worker_killing_policy.h:58 RetriableLIFOWorkerKillingPolicy)

    @staticmethod
    def _host_memory_fraction() -> float:
        try:
            total = avail = None
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemTotal:"):
                        total = int(line.split()[1]) * 1024
                    elif line.startswith("MemAvailable:"):
                        avail = int(line.split()[1]) * 1024
                    if total is not None and avail is not None:
                        break
            if not total or avail is None:
                # Unknown usage must read as "no pressure" — treating it as
                # full would turn the monitor into a kill-everything loop.
                return 0.0
            return 1.0 - avail / total
        except OSError:
            return 0.0

    @staticmethod
    def _proc_rss(pid: int) -> int:
        try:
            with open(f"/proc/{pid}/statm") as f:
                return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
        except (OSError, IndexError, ValueError):
            return 0

    def _pick_oom_victim(self) -> WorkerHandle | None:
        """RetriableLIFO: newest-leased retriable task worker first, then
        newest non-retriable task worker; actor workers only as a last
        resort (killing an actor loses state; a task retries cheaply)."""
        busy = [h for h in self.workers.values()
                if not h.idle and h.conn is not None and h.actor_id is None]
        if busy:
            retriable = [h for h in busy if h.lease_retriable]
            pool = retriable or busy
            # Rank by lease-grant time, not process spawn time: pooled
            # workers are reused, so a long-lived worker may be running the
            # newest task (ADVICE r2).
            return max(pool, key=lambda h: h.leased_at)
        actors = [h for h in self.workers.values()
                  if h.actor_id is not None and h.conn is not None]
        if actors:
            return max(actors, key=lambda h: h.leased_at)
        return None

    async def _memory_monitor_loop(self) -> None:
        cfg = self.config
        while not self._shutdown:
            await asyncio.sleep(cfg.memory_monitor_period_s)
            try:
                frac = self._host_memory_fraction()
                over_host = frac > cfg.memory_usage_threshold
                over_limit = False
                if cfg.memory_limit_bytes:
                    rss = sum(self._proc_rss(h.pid)
                              for h in self.workers.values() if h.pid > 0)
                    over_limit = rss > cfg.memory_limit_bytes
                if not (over_host or over_limit):
                    continue
                victim = self._pick_oom_victim()
                if victim is None:
                    continue
                logger.warning(
                    "memory pressure (host=%.0f%%%s): killing newest %s "
                    "worker %s (pid %d); its task will retry",
                    frac * 100,
                    " + worker-rss over limit" if over_limit else "",
                    "retriable" if victim.lease_retriable else "busy",
                    WorkerID(victim.worker_id).hex()[:8], victim.pid,
                )
                if victim.proc is not None:
                    try:
                        victim.proc.kill()
                    except ProcessLookupError:
                        pass
                elif victim.pid > 0:
                    try:
                        os.kill(victim.pid, 9)
                    except ProcessLookupError:
                        pass
                # Durable post-mortem trail (dashboard /api/events).
                try:
                    spawn(self.gcs.call("event_add", {
                        "type": "WORKER_OOM_KILLED", "severity": "WARNING",
                        "source": f"raylet:{NodeID(self.node_id).hex()[:8]}",
                        "message": (
                            f"memory pressure (host {frac * 100:.0f}%): "
                            f"killed worker "
                            f"{WorkerID(victim.worker_id).hex()[:8]}"),
                        "node_id": NodeID(self.node_id).hex(),
                        "pid": victim.pid,
                    }))
                except Exception:  # graftlint: disable=EXC-SWALLOW (event emit is advisory; the kill itself already happened)
                    pass
                # disconnect handling returns resources + pumps the queue
            except Exception:
                logger.exception("memory monitor iteration failed")

    # ------------------------------------------------------- leasing

    def _feasible(self, resources: dict[str, float]) -> bool:
        return all(
            self.resources_total.get(k, 0) >= v for k, v in resources.items()
        )

    def _available(self, resources: dict[str, float]) -> bool:
        return all(
            self.resources_available.get(k, 0) >= v
            for k, v in resources.items()
        )

    def _utilization(self) -> float:
        fracs = [
            1 - self.resources_available.get(k, 0) / v
            for k, v in self.resources_total.items()
            if v > 0
        ]
        return max(fracs) if fracs else 0.0

    async def _autoscaler_can_launch(self, resources: dict) -> bool:
        """Whether a running autoscaler (a fresh advertisement in the GCS
        KV) can launch a node type with room for ``resources``."""
        from ray_tpu_torch.autoscaler.autoscaler import (
            ADVERTISE_KEY,
            ADVERTISE_TTL_S,
        )

        try:
            ad = await self.gcs.call(
                "kv_get", {"ns": ADVERTISE_KEY[0], "key": ADVERTISE_KEY[1]},
                timeout=self.config.rpc_default_timeout_s)
        except (rpc.ConnectionLost, asyncio.TimeoutError):
            return False
        if not ad or time.time() - ad.get("at", 0) > ADVERTISE_TTL_S:
            return False
        return any(all(nt.get(k, 0) >= v for k, v in resources.items())
                   for nt in ad.get("node_types", []))

    def _spill_infeasible(self) -> None:
        """Send each queued lease no node could run to a node that now
        can (one the autoscaler launched has joined the view)."""
        for req in list(self.lease_queue):
            if req.infeasible and not req.future.done():
                spill = self._pick_spill_node(req.resources)
                if spill is not None:
                    req.future.set_result({"spillback": spill})
                    self.lease_queue.remove(req)

    def _pick_spill_node(self, resources: dict[str, float],
                         require_available: bool = False) -> tuple | None:
        """Hybrid policy step 2: least-loaded remote feasible node
        (ref: hybrid_scheduling_policy.h:24-47). With require_available,
        only nodes with free capacity qualify — spilling to an equally
        saturated peer just ping-pongs the lease (it would spill straight
        back); queue locally instead."""
        best, best_score = None, None
        for nid, n in self.cluster_view.items():
            if nid == self.node_id or not n.get("alive", True):
                continue
            tot, avail = n["resources_total"], n["resources_available"]
            if not all(tot.get(k, 0) >= v for k, v in resources.items()):
                continue
            has = all(avail.get(k, 0) >= v for k, v in resources.items())
            if require_available and not has:
                continue
            score = (not has, n.get("load", 0))
            if best_score is None or score < best_score:
                best, best_score = tuple(n["address"]), score
        return best

    async def _h_pg_reserve(self, conn, p):
        """Carve a bundle out of this node's available resources."""
        key = (p["pg_id"], p["bundle_index"])
        if key in self.pg_bundles:
            return {"ok": True}  # idempotent retry
        res = p["resources"]
        if not self._available(res):
            return {"ok": False, "error": "insufficient resources"}
        for k, v in res.items():
            self.resources_available[k] = self.resources_available.get(k, 0) - v
        self.pg_bundles[key] = {"total": dict(res), "free": dict(res)}
        return {"ok": True}

    async def _h_pg_return(self, conn, p):
        key = (p["pg_id"], p["bundle_index"])
        b = self.pg_bundles.pop(key, None)
        if b is not None:
            # Outstanding leases from this bundle return their share to the
            # node directly when released (bundle record is gone by then).
            for k, v in b["free"].items():
                self.resources_available[k] = (
                    self.resources_available.get(k, 0) + v)
            self._pump_leases()
        return {"ok": True}

    def _bundle_fits(self, key: tuple, resources: dict) -> bool:
        b = self.pg_bundles.get(key)
        return b is not None and all(
            b["free"].get(k, 0) >= v for k, v in resources.items())

    async def _h_request_lease(self, conn, p):
        resources = p.get("resources", {})
        strategy = p.get("strategy")
        if isinstance(strategy, dict) and strategy.get("type") == "placement_group":
            return await self._lease_from_bundle(p, resources, strategy)
        affinity = None
        if isinstance(strategy, dict) and strategy.get("type") == "node_affinity":
            affinity = strategy
        if affinity is not None and affinity.get("node_id") != self.node_id:
            target = self.cluster_view.get(affinity["node_id"])
            if target is not None and target.get("alive", True):
                return {"spillback": tuple(target["address"])}
            if not affinity.get("soft", False):
                return {"error": "affinity node not available"}
        infeasible = False
        if not self._feasible(resources):
            # This node can never run it: redirect to any feasible node,
            # busy or not (it will queue there).
            spill = self._pick_spill_node(resources)
            if spill is not None:
                return {"spillback": spill}
            if not await self._autoscaler_can_launch(resources):
                return {"error": f"no node can satisfy resources {resources}"}
            # A running autoscaler can launch a node that fits: queue the
            # lease (its shape is the demand the autoscaler reads) until
            # such a node joins, then spill it there.
            infeasible = True
        # Hybrid: spill when saturated locally and someone else has ROOM —
        # never to an equally saturated peer (that bounces the lease until
        # the hop cap; under cluster-wide saturation tasks must queue).
        # `no_spill` is the client's post-hop-budget fallback: queue here.
        if not p.get("no_spill"):
            saturated = (
                affinity is None
                and strategy != "LOCAL"
                and not self._available(resources)
            )
            if saturated or (strategy == "SPREAD" and self._utilization() > 0):
                spill = self._pick_spill_node(resources, require_available=True)
                if spill is not None and (
                    saturated
                    or self._utilization() > self.config.hybrid_threshold
                ):
                    return {"spillback": spill}
        req = LeaseRequest(
            resources=resources, strategy=strategy,
            retriable=p.get("retriable", True),
            env_key=p.get("runtime_env_key", ""),
            pip_env=p.get("pip_env"),
            future=asyncio.get_running_loop().create_future(),
            infeasible=infeasible,
        )
        self.lease_queue.append(req)
        self._pump_leases()
        try:
            grant = await asyncio.wait_for(
                req.future, p.get("timeout", self.config.lease_timeout_s)
            )
            return grant
        except asyncio.TimeoutError:
            if req in self.lease_queue:
                self.lease_queue.remove(req)
            return {"error": "lease timeout"}

    async def _lease_from_bundle(self, p, resources, strategy):
        """Grant a lease out of a reserved PG bundle on this node, or
        spill to the node holding the bundle."""
        pg_id = strategy["pg_id"]
        index = strategy.get("bundle_index", -1)
        local_keys = ([(pg_id, index)] if index >= 0 else
                      sorted(k for k in self.pg_bundles if k[0] == pg_id))
        key = next((k for k in local_keys
                    if k in self.pg_bundles
                    and all(self.pg_bundles[k]["total"].get(rk, 0) >= rv
                            for rk, rv in resources.items())), None)
        if key is None:
            # Bundle lives elsewhere: ask the GCS where and spill there.
            info = await self.gcs.call("pg_get", {"pg_id": pg_id})
            if info is None:
                return {"error": f"placement group {pg_id.hex()[:12]} not found"}
            # Statically infeasible (no bundle anywhere is big enough):
            # fail now instead of ping-ponging spillbacks between holders.
            if not any(
                (index < 0 or b["index"] == index)
                and all(b["resources"].get(rk, 0) >= rv
                        for rk, rv in resources.items())
                for b in info["bundles"]
            ):
                return {"error":
                        f"resources {resources} exceed every bundle in the "
                        "placement group"}
            for b in info["bundles"]:
                if index >= 0 and b["index"] != index:
                    continue
                if b["node_id"] == self.node_id:
                    continue
                target = self.cluster_view.get(b["node_id"])
                if target is not None and target.get("alive", True):
                    return {"spillback": tuple(target["address"])}
            return {"error": "no alive node holds the requested bundle"}
        req = LeaseRequest(
            resources=resources, strategy=strategy, bundle_key=key,
            retriable=p.get("retriable", True),
            env_key=p.get("runtime_env_key", ""),
            pip_env=p.get("pip_env"),
            future=asyncio.get_running_loop().create_future(),
        )
        self.lease_queue.append(req)
        self._pump_leases()
        try:
            return await asyncio.wait_for(
                req.future, p.get("timeout", self.config.lease_timeout_s))
        except asyncio.TimeoutError:
            if req in self.lease_queue:
                self.lease_queue.remove(req)
            return {"error": "lease timeout (bundle busy)"}

    def _pump_leases(self) -> None:
        if self._shutdown:
            # stop() terminates the workers it holds; a worker spawned for
            # a queued lease after that (a dying worker's freed resources
            # pump the queue) would outlive the raylet.
            return
        granted = []
        for req in self.lease_queue:
            if req.future.done():
                granted.append(req)
                continue
            if req.bundle_key is not None:
                if not self._bundle_fits(req.bundle_key, req.resources):
                    continue
            elif not self._available(req.resources):
                continue
            worker = self._find_idle_worker(req.env_key)
            if worker is None:
                # Spawn only up to the node's concurrency capacity: one slot
                # per whole CPU plus actor-pinned workers (ref: worker_pool.cc
                # maximum_startup_concurrency).
                n_pinned = sum(
                    1 for h in self.workers.values() if h.actor_id is not None
                )
                cap = min(
                    int(self.resources_total.get("CPU", 1)) + n_pinned,
                    self.config.max_workers_per_node,
                )
                if len(self.workers) >= cap:
                    # At capacity with only WRONG-env idle workers: evict
                    # one to make room, or a pip-env lease starves forever
                    # behind a kept-warm base worker (and vice versa) —
                    # ref: worker_pool.cc pops an idle worker of another
                    # runtime env for replacement.
                    victim = next(
                        (h for h in self.workers.values()
                         if h.idle and h.conn is not None
                         and h.actor_id is None
                         and h.env_key != req.env_key), None)
                    if victim is not None:
                        self._kill_worker(victim)
                if len(self.workers) < cap:
                    if req.env_key:
                        self._spawn_env_worker(req.env_key, req.pip_env or {})
                    else:
                        self._spawn_worker()
                continue
            worker.idle = False
            worker.lease_resources = dict(req.resources)
            worker.lease_retriable = req.retriable
            worker.leased_at = time.monotonic()
            worker.bundle_key = req.bundle_key
            if req.bundle_key is not None:
                free = self.pg_bundles[req.bundle_key]["free"]
                for k, v in req.resources.items():
                    free[k] = free.get(k, 0) - v
            else:
                for k, v in req.resources.items():
                    self.resources_available[k] = (
                        self.resources_available.get(k, 0) - v
                    )
            req.future.set_result({
                "worker_id": worker.worker_id,
                "worker_address": worker.address,
            })
            granted.append(req)
        for req in granted:
            if req in self.lease_queue:
                self.lease_queue.remove(req)

    def _find_idle_worker(self, env_key: str = "") -> WorkerHandle | None:
        # Strict env matching: a pip-env worker's interpreter has extra
        # packages — base-image tasks never run there, and vice versa
        # (ref: worker_pool.cc pools keyed by runtime env).
        for h in self.workers.values():
            if (h.idle and h.conn is not None and h.actor_id is None
                    and h.env_key == env_key):
                return h
        return None

    async def _h_release_lease(self, conn, p):
        h = self.workers.get(p["worker_id"])
        if h is not None:
            bundle_key = h.bundle_key
            self._return_resources(h)
            if p.get("actor_id"):
                h.actor_id = p["actor_id"]       # pinned to actor: not reusable
                # actor holds its resources for life — from the same pool
                # (PG bundle or node) its creation lease came from
                h.lease_resources = p.get("resources", {})
                bundle = (self.pg_bundles.get(bundle_key)
                          if bundle_key is not None else None)
                if bundle is not None:
                    h.bundle_key = bundle_key
                    for k, v in h.lease_resources.items():
                        bundle["free"][k] = bundle["free"].get(k, 0) - v
                else:
                    for k, v in h.lease_resources.items():
                        self.resources_available[k] = (
                            self.resources_available.get(k, 0) - v
                        )
            elif p.get("dead"):
                self.workers.pop(p["worker_id"], None)
            else:
                h.idle = True
                h.started = time.monotonic()
            self._pump_leases()
        return {"ok": True}

    # ------------------------------------------------------- object plane

    async def _h_store_create(self, conn, p):
        name, offset = await self.store.create(ObjectID(p["object_id"]), p["size"])
        return {"arena": name, "offset": offset}

    def _announce_locations(self, object_ids: list[bytes]) -> None:
        """Fire-and-forget directory announce: the store reply must not wait
        a GCS round trip (remote getters' pulls retry against the directory
        every second, so a lagging announce only delays a pull, never loses
        an object)."""

        async def go():
            try:
                await self.gcs.call("obj_loc_add", {
                    "object_ids": object_ids, "node_id": self.node_id,
                }, timeout=30.0)
            except Exception as e:
                logger.warning("location announce failed: %s", e)

        spawn(go())

    async def _h_store_seal(self, conn, p):
        obj = ObjectID(p["object_id"])
        self.store.seal(obj)
        if not p.get("local_only"):
            self._announce_locations([p["object_id"]])
        return {"ok": True}

    async def _h_store_put_inline(self, conn, p):
        obj = ObjectID(p["object_id"])
        self.store.put_inline(obj, p["data"])
        if not p.get("local_only"):
            self._announce_locations([p["object_id"]])
        return {"ok": True}

    async def _h_store_put_data(self, conn, p):
        """Remote-driver put: data arrives over RPC and is written into the
        store daemon-side (no client mmap)."""
        obj = ObjectID(p["object_id"])
        data = p["data"]
        await self.store.create(obj, len(data))
        self.store.write_bytes(obj, 0, data)
        self.store.seal(obj)
        if not p.get("local_only"):
            self._announce_locations([p["object_id"]])
        return {"ok": True}

    # Chunked remote-driver writes (objects above remote_object_chunk_bytes
    # stream one frame per chunk; ref: the reference client's plasma
    # chunking for arbitrarily large ray:// objects, util/client/).

    async def _h_store_create_remote(self, conn, p):
        await self.store.create(ObjectID(p["object_id"]), p["size"])
        return {"ok": True}

    async def _h_store_write_chunk(self, conn, p):
        self.store.write_bytes(ObjectID(p["object_id"]), p["offset"],
                               p["data"])
        return {"ok": True}

    async def _h_store_seal_remote(self, conn, p):
        self.store.seal(ObjectID(p["object_id"]))
        self._announce_locations([p["object_id"]])
        return {"ok": True}

    async def _h_store_get(self, conn, p):
        """Resolve objects for a local client; pulls from remote if needed.
        Returns per-object: ("inline", bytes) | ("shm", (name, size)) |
        ("missing", None). want_data=True (remote drivers) returns bytes
        for shm entries instead of an arena descriptor."""
        timeout = p.get("timeout")
        want_data = p.get("want_data", False)
        loop = asyncio.get_running_loop()
        deadline = None if timeout is None else loop.time() + timeout
        out = []
        for ob in p["object_ids"]:
            obj = ObjectID(ob)
            ok = self.store.contains(obj)
            # Retry rounds: a lost object may reappear on another node after
            # owner-side lineage reconstruction; re-consult the directory
            # every second instead of blocking on the local seal event.
            while not ok:
                remaining = (None if deadline is None
                             else deadline - loop.time())
                if remaining is not None and remaining <= 0:
                    break
                ok = await self._pull(obj, remaining)
                if ok:
                    break
                w = self.config.object_pull_retry_interval_s
                wait = w if remaining is None else min(w, remaining)
                ok = await self.store.wait_sealed(obj, wait)
            if not ok:
                out.append(("missing", None))
            else:
                # Pin: the client holds a zero-copy mmap view — the extent
                # must not be spilled/moved under it. Released on explicit
                # free by this client or when the connection drops.
                if want_data:
                    e = self.store.entries.get(obj)
                    if e is not None and e.location == "spilled":
                        if e.size > self.config.remote_object_chunk_bytes:
                            out.append(("remote_chunked", e.size))
                            continue
                        # Serve straight from the spill file: restoring into
                        # the arena just to copy bytes into the reply could
                        # evict live objects under pressure.
                        out.append(("inline",
                                    self.store.read_bytes(obj, 0, e.size)))
                        continue
                try:
                    loc, data = await self.store.describe(obj,
                                                          pin=not want_data)
                except KeyError:  # freed concurrently with this get
                    out.append(("missing", None))
                    continue
                if loc == "shm":
                    if want_data:
                        _arena, _off, size = data
                        if size > self.config.remote_object_chunk_bytes:
                            # Client streams via obj_read_chunk: one frame
                            # per chunk instead of one giant reply.
                            out.append(("remote_chunked", size))
                            continue
                        out.append(("inline",
                                    self.store.read_bytes(obj, 0, size)))
                        continue
                    key = (obj, self.store.entry_gen(obj))
                    pins = self._conn_pins.setdefault(id(conn), {})
                    pins[key] = pins.get(key, 0) + 1
                out.append((loc, data))
        return out

    async def _h_store_contains(self, conn, p):
        return [self.store.contains(ObjectID(ob)) for ob in p["object_ids"]]

    async def _h_store_free(self, conn, p):
        for ob in p["object_ids"]:
            obj = ObjectID(ob)
            # The freeing client has released its own views: drop its pins
            # first so an otherwise-unreferenced extent is reclaimed now
            # rather than parked doomed until disconnect.
            self._drop_conn_pins(conn, obj)
            self.store.free(obj)
            spawn(self.gcs.call("obj_loc_remove", {
                "object_id": ob, "node_id": self.node_id,
            }))
        return {"ok": True}

    def _drop_conn_pins(self, conn, obj: ObjectID) -> None:
        pins = self._conn_pins.get(id(conn), {})
        for key in [k for k in pins if k[0] == obj]:
            n = pins.pop(key)
            for _ in range(n):
                self.store.unpin(obj, key[1])

    async def _h_store_release(self, conn, p):
        """A client released its zero-copy views of these objects (its last
        ObjectRef died): drop the reader pins it holds via this connection,
        without freeing the entries."""
        for ob in p["object_ids"]:
            self._drop_conn_pins(conn, ObjectID(ob))
        return {"ok": True}

    async def _h_store_stats(self, conn, p):
        return self.store.stats()

    async def _h_store_pin(self, conn, p):
        for ob in p["object_ids"]:
            self.store.pin(ObjectID(ob), p.get("delta", 1))
        return {"ok": True}

    async def _h_obj_info(self, conn, p):
        obj = ObjectID(p["object_id"])
        if not self.store.contains(obj):
            return None
        info = {"size": self.store.entries[obj].size,
                "inline": self.store.entries[obj].location == "inline"}
        # Bulk transfers reserve a serve slot (tree fan-out — see
        # _serve_slots); inline reads are one small RPC, never gated.
        if p.get("want_serve") and not info["inline"]:
            tok = self._serve_acquire(obj.binary())
            if tok is None:
                return {"busy": True}
            info["serve_token"] = tok
        return info

    async def _h_obj_read_chunk(self, conn, p):
        obj = ObjectID(p["object_id"])
        if not self.store.contains(obj):
            return None
        return self.store.read_bytes(obj, p["offset"], p["length"])

    def _serve_acquire(self, key: bytes) -> str | None:
        """→ slot token, or None when the object's reader bound is full.
        Tokened so a release always frees the RELEASER's slot — popping an
        arbitrary entry would let a straggler free a live puller's slot
        and drift the bound above the fanout."""
        import uuid

        now = time.monotonic()
        slots = self._serve_slots.setdefault(key, {})
        for tok in [t for t, d in slots.items() if d <= now]:
            slots.pop(tok, None)
        if len(slots) >= self.config.object_serve_fanout:
            return None
        tok = uuid.uuid4().hex[:16]
        slots[tok] = now + self.config.object_serve_slot_ttl_s
        return tok

    def _serve_release(self, key: bytes, token: str) -> None:
        slots = self._serve_slots.get(key)
        if slots is not None:
            slots.pop(token, None)
            if not slots:
                self._serve_slots.pop(key, None)

    async def _h_obj_end_read(self, conn, p):
        self._serve_release(p["object_id"], p.get("token", ""))
        return {"ok": True}

    async def _peer(self, address: tuple[str, int]) -> rpc.Connection:
        conn = self._peer_conns.get(address)
        if conn is None or conn.closed:
            conn = await rpc.connect(*address, timeout=self.config.rpc_connect_timeout_s)
            self._peer_conns[address] = conn
        return conn

    async def _pull(self, obj: ObjectID, timeout: float | None) -> bool:
        """Chunked pull from a remote holder (ref: pull_manager.h:48,
        object_manager.proto Push/Pull, 5 MiB chunks)."""
        key = obj.binary()
        fut = self._pulls_inflight.get(key)
        if fut is not None:
            try:
                return await asyncio.wait_for(
                    asyncio.shield(fut), timeout
                )
            except asyncio.TimeoutError:
                return False
        fut = asyncio.get_running_loop().create_future()
        self._pulls_inflight[key] = fut
        try:
            ok = await self._pull_once(obj, timeout)
            fut.set_result(ok)
            return ok
        except Exception as e:
            fut.set_result(False)
            logger.warning("pull %s failed: %s", obj.hex()[:12], e)
            return False
        finally:
            self._pulls_inflight.pop(key, None)

    async def _pull_once(self, obj: ObjectID, timeout: float | None) -> bool:
        import random

        deadline = (time.monotonic() + timeout) if timeout else None
        backoff = self.config.object_pull_backoff_s
        while True:
            locs = await self.gcs.call(
                "obj_loc_get", {"object_id": obj.binary()})
            if not locs:
                # No live copy anywhere: route a reconstruction request to
                # the owner (ref: object_recovery_manager.h RecoverObject);
                # we keep polling the directory on later store_get rounds.
                try:
                    await self.gcs.call("obj_request_recovery", {
                        "object_ids": [obj.binary()]},
                        timeout=self.config.rpc_default_timeout_s)
                except Exception as e:
                    # Recovery request lost: the object stays unavailable
                    # until the next store_get poll retries — log it, a
                    # silent drop here looks exactly like a refcount bug.
                    logger.debug("obj_request_recovery %s failed: %s",
                                 obj.hex()[:12], e)
                return False
            # Randomize holder order so a broadcast (N nodes pulling one hot
            # object) spreads across replicas as copies appear, instead of
            # serializing on the original holder (ref: push_manager.h dedup
            # + pull location selection).
            locs = [l for l in locs if l["node_id"] != self.node_id]
            random.shuffle(locs)
            saw_busy = False
            for loc in locs:
                try:
                    peer = await self._peer(tuple(loc["address"]))
                    info = await peer.call(
                        "obj_info",
                        {"object_id": obj.binary(), "want_serve": True},
                        timeout=self.config.rpc_default_timeout_s)
                    if info is None:
                        continue
                    if info.get("busy"):
                        # Holder's serve slots are full (broadcast wave):
                        # try another holder; if all are saturated, back
                        # off and re-read the directory — completed pullers
                        # will have registered as fresh holders (tree
                        # fan-out instead of N pulls on one node).
                        saw_busy = True
                        continue
                    size = info["size"]
                    if info["inline"]:
                        data = await peer.call("obj_read_chunk", {
                            "object_id": obj.binary(), "offset": 0,
                            "length": size,
                        }, timeout=60.0)
                        self.store.put_inline(obj, data)
                    else:
                        try:
                            await self._pull_admission(size)
                            try:
                                await self._pull_chunks(obj, peer, size)
                            finally:
                                self._pull_release(size)
                        finally:
                            try:
                                await peer.call("obj_end_read", {
                                    "object_id": obj.binary(),
                                    "token": info.get("serve_token", ""),
                                }, timeout=5.0)
                            except Exception:  # graftlint: disable=EXC-SWALLOW (read-slot TTL reclaims it)
                                pass
                    await self.gcs.call("obj_loc_add", {
                        "object_ids": [obj.binary()],
                        "node_id": self.node_id,
                    })
                    return True
                except (rpc.RpcError, rpc.ConnectionLost, KeyError) as e:
                    logger.debug("pull from %s failed: %s", loc, e)
                    continue
            if saw_busy and (deadline is None
                             or time.monotonic() + backoff < deadline):
                await asyncio.sleep(backoff)
                backoff = min(backoff * 1.6, 1.0)
                continue
            break
        # Every holder failed: abort any partially-created unsealed extent
        # so the arena doesn't leak it (a later retry re-creates it).
        e = self.store.entries.get(obj)
        if e is not None and not e.sealed:
            self.store.free(obj)
        return False

    async def _pull_admission(self, size: int) -> None:
        """FIFO admission control (ref: pull_manager.h:48): bound the bytes
        of concurrently inbound pulls to a fraction of store capacity.
        Strict arrival order — a large pull at the head admits as soon as
        in-flight bytes drain, instead of being starved by a stream of
        small pulls slipping past it."""
        fut = asyncio.get_running_loop().create_future()
        self._pull_waiters.append((size, fut))
        self._pump_pull_admission()
        await fut

    def _pump_pull_admission(self) -> None:
        limit = max(
            int(self.store.capacity * self.config.pull_admission_fraction),
            self.config.object_transfer_chunk_size)
        while self._pull_waiters:
            size, fut = self._pull_waiters[0]
            if fut.done():
                self._pull_waiters.pop(0)
                continue
            if self._pull_bytes > 0 and self._pull_bytes + size > limit:
                break
            self._pull_waiters.pop(0)
            self._pull_bytes += size
            fut.set_result(None)

    def _pull_release(self, size: int) -> None:
        self._pull_bytes -= size
        self._pump_pull_admission()

    async def _pull_chunks(self, obj: ObjectID, peer, size: int) -> None:
        """Windowed parallel chunk fetch: overlap network round trips
        (the r1 pull fetched 5 MiB chunks strictly serially)."""
        chunk = self.config.object_transfer_chunk_size
        await self.store.create(obj, size)
        offsets = list(range(0, size, chunk))
        sem = asyncio.Semaphore(self.config.object_pull_parallelism)

        async def fetch(off: int):
            async with sem:
                n = min(chunk, size - off)
                data = await peer.call("obj_read_chunk", {
                    "object_id": obj.binary(), "offset": off, "length": n,
                }, timeout=60.0)
                if data is None:
                    raise rpc.RpcError("holder dropped object mid-pull")
                self.store.write_bytes(obj, off, data)

        tasks = [asyncio.ensure_future(fetch(o)) for o in offsets]
        try:
            await asyncio.gather(*tasks)
        except BaseException:
            # Cancel + drain siblings: a straggler writing into the extent
            # after we've moved on (or freed it) would corrupt a retry.
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            raise
        self.store.seal(obj)

    async def _h_node_info(self, conn, p):
        return {
            "node_id": self.node_id,
            "resources_total": self.resources_total,
            "resources_available": self.resources_available,
            "n_workers": len(self.workers),
            "store": self.store.stats(),
        }

    # ------------------------------------------------------- shutdown

    async def stop(self) -> None:
        self._shutdown = True
        for h in self.workers.values():
            if h.conn is not None:
                h.conn.notify("exit", {})
            if h.proc is not None:
                try:
                    h.proc.terminate()
                except ProcessLookupError:
                    pass
        # The arena first: the server waits for its clients to hang up.
        self.store.shutdown()
        await self.server.stop()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gcs", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--resources", default="{}")
    ap.add_argument("--labels", default="{}")
    ap.add_argument("--config", default=None)
    ap.add_argument("--session-dir", default=None)
    ap.add_argument("--ready-fd", type=int, default=None)
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO,
                        format="[raylet] %(levelname)s %(message)s")
    import json

    config = Config.from_json(open(args.config).read()) if args.config else Config.from_env()
    ghost, gport = args.gcs.rsplit(":", 1)
    resources = json.loads(args.resources)

    async def run():
        raylet = Raylet(
            config, (ghost, int(gport)), resources,
            args.host, args.port, session_dir=args.session_dir,
            labels=json.loads(args.labels),
        )
        host, port = await raylet.start()
        if args.ready_fd is not None:
            os.write(args.ready_fd, f"{host}:{port}\n".encode())
            os.close(args.ready_fd)
        # SIGTERM (Node.stop, the CLI's stop) ends the raylet through
        # stop(): its workers are told to exit and its arena is unlinked
        # from /dev/shm (killed by the default action, the arena stayed
        # until the next store's stale sweep).
        stopping = asyncio.Event()
        asyncio.get_running_loop().add_signal_handler(
            signal.SIGTERM, stopping.set)
        await stopping.wait()
        await raylet.stop()

    asyncio.run(run())


if __name__ == "__main__":
    main()
