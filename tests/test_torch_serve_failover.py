"""Serve failover on the port's cluster: replica death and drain are
invisible to clients, and the controller survives kill -9 and a
checkpoint-write blip.

Mirrors ``tests/test_chaos.py::TestServeFailover`` (4 cases) case for
case; exact comparisons (no float tolerance). Where the JAX tests sleep
a fixed 2-3 s, these poll to a deadline: the controller's restart is
read from the cluster event log (ACTOR_RESTARTING, then ACTOR_ALIVE),
the checkpoint from the GCS KV.
"""

import os
import threading
import time
import urllib.request

import ray_tpu_torch
from ray_tpu_torch import state


def _restarted(actor_hex: str, after_seq: int) -> bool:
    """The actor went RESTARTING and then ALIVE after ``after_seq``."""
    evs = [e for e in state.list_cluster_events(after_seq=after_seq,
                                                limit=10000)
           if e.get("actor_id") == actor_hex]
    kinds = [e["type"] for e in evs]
    return ("ACTOR_RESTARTING" in kinds and "ACTOR_ALIVE"
            in kinds[kinds.index("ACTOR_RESTARTING"):])


class TestServeFailover:
    """Cluster-level: replica death / drain invisible to clients."""

    def test_unary_failover_on_replica_death(self):
        """A replica SIGKILLed MID-REQUEST costs the client nothing: the
        proxy maps ActorDiedError to one immediate failover retry on a
        re-picked replica before any 5xx (satellite: http_proxy
        _submit/_await_ref)."""
        from ray_tpu_torch import serve
        from ray_tpu_torch.serve.api import _get_controller

        ray_tpu_torch.init(num_cpus=4)
        try:
            @serve.deployment(name="mortal", num_replicas=2)
            class Mortal:
                def __call__(self, req):
                    time.sleep(0.05)
                    return {"pid": os.getpid()}

            serve.run(Mortal.bind())
            _proxy, port = serve.start_proxy()
            deadline = time.time() + 30
            while time.time() < deadline:
                try:
                    urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/mortal", data=b"{}",
                        timeout=30)
                    break
                except Exception:
                    time.sleep(0.5)
            ctrl = _get_controller()
            table = ray_tpu_torch.get(ctrl.get_routing.remote(-1), timeout=30)
            victim = table["routes"]["mortal"]["replicas"][0]
            # Seeded kill: the victim dies abruptly inside its NEXT
            # handle_request — exactly one request observes the death.
            ray_tpu_torch.get(victim.install_chaos.remote(
                [{"site": "serve.replica.request", "action": "kill"}]),
                timeout=30)
            errors = []
            for _ in range(12):
                try:
                    r = urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/mortal", data=b"{}",
                        timeout=60)
                    assert r.status == 200
                except Exception as e:  # noqa: BLE001
                    errors.append(e)
            assert not errors, f"client saw failures: {errors}"
        finally:
            serve.shutdown()
            ray_tpu_torch.shutdown()

    def test_scale_down_drains_instead_of_killing(self):
        """Scale-down routes through the drain protocol: the shed replica
        leaves the routing table immediately, finishes its in-flight
        work inside serve_drain_timeout_s, and only then is killed —
        in-flight unary requests on the drained replica complete."""
        from ray_tpu_torch import serve

        ray_tpu_torch.init(num_cpus=4,
                     _system_config={"serve_drain_timeout_s": 20.0})
        try:
            @serve.deployment(name="slowpoke", num_replicas=2,
                              max_concurrent_queries=8)
            class Slow:
                def __call__(self, req):
                    time.sleep(req.get("sleep", 0.0))
                    return {"pid": os.getpid()}

            dep = Slow.bind()
            handle = serve.run(dep)
            # Park slow requests on BOTH replicas, then scale down.
            refs = [handle.remote({"sleep": 3.0}) for _ in range(8)]
            time.sleep(0.5)
            serve.run(dep.options(num_replicas=1))
            # The shed replica is draining, not dead: every parked
            # request completes.
            outs = ray_tpu_torch.get(refs, timeout=60)
            assert len({o["pid"] for o in outs}) == 2
            deadline = time.time() + 30
            while time.time() < deadline:
                st = serve.status()["slowpoke"]
                if (st["live_replicas"] == 1
                        and st["draining_replicas"] == 0):
                    break
                time.sleep(0.5)
            st = serve.status()["slowpoke"]
            assert st["live_replicas"] == 1
            assert st["draining_replicas"] == 0
        finally:
            serve.shutdown()
            ray_tpu_torch.shutdown()

    def test_controller_kill9_mid_reconcile_routes_keep_serving(self):
        """Pins the controller docstring's claim: requests keep flowing
        through a controller kill -9 (chaos: abrupt exit mid-reconcile),
        and the restarted controller ADOPTS the live replicas from its
        checkpoint instead of respawning them."""
        from ray_tpu_torch import serve
        from ray_tpu_torch.serve.api import _get_controller

        ray_tpu_torch.init(num_cpus=4)
        try:
            @serve.deployment(name="steady", num_replicas=2)
            def steady(req):
                return {"ok": True}

            handle = serve.run(steady)
            ctrl = _get_controller()
            table = ray_tpu_torch.get(ctrl.get_routing.remote(-1), timeout=30)
            aids_before = {h._actor_id.hex()
                           for h in table["routes"]["steady"]["replicas"]}

            stop = threading.Event()
            failures: list = []
            count = [0]

            def traffic():
                while not stop.is_set():
                    try:
                        out = ray_tpu_torch.get(handle.remote({}), timeout=30)
                        assert out == {"ok": True}
                        count[0] += 1
                    except Exception as e:  # noqa: BLE001
                        failures.append(repr(e))
                    time.sleep(0.02)

            t = threading.Thread(target=traffic, daemon=True)
            t.start()
            _, latest = state.list_cluster_events(return_latest_seq=True)
            # Abrupt controller death two reconcile ticks from now.
            ray_tpu_torch.get(ctrl.install_chaos.remote(
                [{"site": "serve.controller.reconcile", "action": "kill",
                  "after": 2}]), timeout=30)
            # Wait through death + auto-restart (the event log shows
            # both), then until the restarted controller answers
            # get_routing again (fresh reconcile loop running).
            deadline = time.time() + 90
            restarted = False
            while time.time() < deadline and not restarted:
                try:
                    restarted = (
                        _restarted(ctrl._actor_id.hex(), latest)
                        and bool(ray_tpu_torch.get(
                            _get_controller().get_routing.remote(-1),
                            timeout=10)))
                except Exception:  # noqa: BLE001 — mid-restart
                    pass
                if not restarted:
                    time.sleep(0.3)
            assert restarted, "controller did not come back"
            # A couple of post-restart reconcile ticks, with traffic on.
            mark = count[0]
            while (time.time() < deadline and count[0] < mark + 40
                   and not failures):
                time.sleep(0.1)
            stop.set()
            t.join(timeout=30)
            assert not failures, f"requests failed during kill -9: " \
                                 f"{failures[:3]} (+{len(failures)})"
            assert count[0] > 0
            table = ray_tpu_torch.get(
                _get_controller().get_routing.remote(-1), timeout=30)
            aids_after = {h._actor_id.hex()
                          for h in table["routes"]["steady"]["replicas"]}
            # Adoption, not respawn: the SAME replica actors serve on.
            assert aids_after == aids_before
        finally:
            serve.shutdown()
            ray_tpu_torch.shutdown()

    def test_ckpt_write_retry_survives_transient_gcs_blip(self):
        """Satellite: checkpoint writes retry with backoff — two injected
        consecutive write failures must not cost the next controller
        restart its state."""
        from ray_tpu_torch import serve
        from ray_tpu_torch.serve.api import _get_controller

        ray_tpu_torch.init(num_cpus=4)
        try:
            @serve.deployment(name="durable")
            def durable(req):
                return 1

            serve.start()
            ctrl = _get_controller()
            # Every checkpoint's first two write ATTEMPTS fail (count=-1
            # with p=1 would kill all retries; after+count target exactly
            # the first two attempts of the FIRST write burst — later
            # writes all succeed, but the deploy right below must survive
            # its own write's blip via retry).
            ray_tpu_torch.get(ctrl.install_chaos.remote(
                [{"site": "serve.controller.ckpt_write", "action": "raise",
                  "count": 2}]), timeout=30)
            serve.run(durable)
            # Let the retrying writer land: poll the checkpoint row.
            from ray_tpu_torch import api as _api
            from ray_tpu_torch.serve.controller import CKPT_KEY, CKPT_NS

            deadline = time.time() + 30
            while time.time() < deadline:
                raw = _api._client.kv_get(CKPT_NS, CKPT_KEY)
                if raw and b"durable" in bytes(raw):
                    break
                time.sleep(0.1)
            ray_tpu_torch.kill(ctrl, no_restart=False)
            deadline = time.time() + 90
            while time.time() < deadline:
                try:
                    if "durable" in serve.status():
                        break
                except Exception:  # noqa: BLE001 — mid-restart
                    pass
                time.sleep(0.5)
            assert "durable" in serve.status(), (
                "restarted controller lost the deployment — checkpoint "
                "write was dropped despite retry budget")
        finally:
            serve.shutdown()
            ray_tpu_torch.shutdown()


class _Plain:
    def __call__(self, x):
        return x + 1


class _Engined(_Plain):
    def drain(self, timeout_s):
        return {"exported": 0}


def test_draining_replica_admits_plain_calls_only():
    """A draining replica of a plain callable serves a call routed on a
    stale table (a unary handle call has no failover); one whose
    callable drains an engine rejects it, for its callers to fail
    over. In process, no cluster."""
    import pytest

    from ray_tpu_torch.core import serialization
    from ray_tpu_torch.serve.replica import Replica

    plain = Replica(serialization.pack(_Plain), (), {})
    assert plain.drain(0.0)["drained"]
    assert plain.handle_request("__call__", (1,), {}) == 2
    engined = Replica(serialization.pack(_Engined), (), {})
    engined.drain(0.0)
    with pytest.raises(RuntimeError, match="replica draining"):
        engined.handle_request("__call__", (1,), {})
    assert engined.stats()["inflight"] == 0
