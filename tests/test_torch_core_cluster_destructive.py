"""The port's runtime, case for case as the JAX package's
``tests/test_core_cluster_destructive.py``.

Destructive multi-node tests that build their own clusters.

Split from test_core_cluster.py: these tear nodes down (or need a custom
head shape), so they cannot share the module-scoped cluster there — and as
their own module they land on a separate pytest-xdist worker.
"""

import time

import pytest  # noqa: F401

import ray_tpu_torch
from ray_tpu_torch import api
from ray_tpu_torch.cluster_utils import Cluster


def test_actor_failover_on_node_death():
    """A restartable actor on a dying node is rescheduled elsewhere."""
    cluster = Cluster(head_node_args={"num_cpus": 2})
    node2 = cluster.add_node(num_cpus=2, resources={"pin": 1})
    ray_tpu_torch.init(address=cluster.address)
    try:
        @ray_tpu_torch.remote(max_restarts=-1, resources={"pin": 0.1})
        class Survivor:
            def ping(self):
                return "pong"

        s = Survivor.remote()
        assert ray_tpu_torch.get(s.ping.remote(), timeout=60) == "pong"
        # Node 2 dies; pin resource is gone, but CPU-only restart can land on
        # the head node once the failed-actor reschedule drops... it can't —
        # pin exists only on node2. Add a new node with the resource:
        cluster.remove_node(node2)
        cluster.add_node(num_cpus=2, resources={"pin": 1})
        deadline = time.time() + 60
        ok = False
        while time.time() < deadline:
            try:
                assert ray_tpu_torch.get(s.ping.remote(), timeout=30) == "pong"
                ok = True
                break
            except api.RayTaskError:
                time.sleep(1)
        assert ok, "actor did not fail over to the replacement node"
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()


def test_cross_client_dep_does_not_hold_worker():
    """Producer-consumer deadlock, cross-client variant (r2 known
    limitation): an ACTOR-submitted task (actors are their own core
    clients) whose arg is the driver's not-yet-produced task output must
    resolve correctly: dispatch gates on the GCS directory
    (client._await_local_deps foreign-ref tier), so the consumer does not
    occupy the lone CPU worker while the producer still needs it."""
    cluster = Cluster(head_node_args={"num_cpus": 1})
    ray_tpu_torch.init(address=cluster.address)
    try:
        @ray_tpu_torch.remote
        def warm():
            return 1

        assert ray_tpu_torch.get(warm.remote(), timeout=60) == 1  # pool warm

        @ray_tpu_torch.remote(num_cpus=0)
        def slow_gate():
            import time as _t

            _t.sleep(1.0)
            return 1

        @ray_tpu_torch.remote
        def produce(_gate):
            return 41

        @ray_tpu_torch.remote(num_cpus=0)
        class Submitter:
            def consume(self, dep):
                @ray_tpu_torch.remote
                def use(x):
                    return x + 1

                return ray_tpu_torch.get(use.remote(dep), timeout=90)

        sub = Submitter.remote()
        dep = produce.remote(slow_gate.remote())  # dispatch gated ~1s
        out_ref = sub.consume.remote(dep)         # races for the CPU worker
        assert ray_tpu_torch.get(out_ref, timeout=90) == 42
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()
