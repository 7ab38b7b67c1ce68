"""The port's runtime, case for case as the JAX package's
``tests/test_core_cluster.py``.

Multi-node tests: spillback scheduling, object transfer, fault tolerance.

Mirrors the reference's multi-node-without-a-cluster approach
(`python/ray/tests/test_multi_node*.py` +
`cluster_utils.py:99`): several raylet processes on one machine, one GCS.
"""

import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import api
from ray_tpu_torch.cluster_utils import Cluster


@pytest.fixture(scope="module")
def two_node_cluster():
    """One shared 2-node cluster for the whole module: per-test cluster
    boots cost ~30s each on this box and dominated CI wall time. Tests
    that kill nodes bring their OWN extra node (or cluster) — the shared
    head + "special" node must stay intact."""
    cluster = Cluster(head_node_args={"num_cpus": 2})
    cluster.add_node(num_cpus=2, resources={"special": 1})
    ray_tpu_torch.init(address=cluster.address)
    yield cluster
    ray_tpu_torch.shutdown()
    cluster.shutdown()


def test_spillback_to_remote_node(two_node_cluster):
    """Tasks needing a resource only the second node has must spill there."""

    @ray_tpu_torch.remote(resources={"special": 0.1})
    def where():
        import os

        return os.getpid()

    pids = set(ray_tpu_torch.get([where.remote() for _ in range(4)], timeout=60))
    assert len(pids) >= 1  # ran somewhere — on the special node

    @ray_tpu_torch.remote
    def anywhere():
        import os

        return os.getpid()

    all_pids = set(ray_tpu_torch.get([anywhere.remote() for _ in range(8)], timeout=60))
    assert not pids & all_pids or len(all_pids) > 1


def test_infeasible_task_errors(two_node_cluster):
    @ray_tpu_torch.remote(resources={"nonexistent": 1})
    def f():
        return 1

    with pytest.raises(api.RayTaskError):
        ray_tpu_torch.get(f.remote(), timeout=30)


def test_object_transfer_between_nodes(two_node_cluster):
    """A large object produced on node B must be pullable from node A."""

    @ray_tpu_torch.remote(resources={"special": 0.1})
    def produce():
        return np.arange(500_000, dtype=np.float64)

    ref = produce.remote()
    out = ray_tpu_torch.get(ref, timeout=60)   # driver is on head node → pull
    np.testing.assert_array_equal(out[:5], [0, 1, 2, 3, 4])
    assert out.shape == (500_000,)


def test_cluster_resources_aggregate(two_node_cluster):
    total = ray_tpu_torch.cluster_resources()
    assert total["CPU"] == 4
    assert total["special"] == 1
    assert sum(1 for n in ray_tpu_torch.nodes() if n["Alive"]) == 2


def test_task_retry_on_worker_crash(two_node_cluster):
    """A task that kills its worker on first attempt succeeds via retry
    (ref: task_manager.h retries)."""

    @ray_tpu_torch.remote(max_retries=2)
    def flaky(path):
        import os

        if not os.path.exists(path):
            open(path, "w").write("x")
            os._exit(1)  # simulate worker crash
        return "survived"

    import tempfile

    path = tempfile.mktemp()
    assert ray_tpu_torch.get(flaky.remote(path), timeout=60) == "survived"


def test_task_failure_after_retries_exhausted(two_node_cluster):
    @ray_tpu_torch.remote(max_retries=1)
    def always_dies():
        import os

        os._exit(1)

    with pytest.raises(api.RayTaskError) as ei:
        ray_tpu_torch.get(always_dies.remote(), timeout=60)
    assert "WorkerCrashed" in ei.value.exc_type


def test_actor_restart(two_node_cluster):
    """max_restarts>0: actor comes back after its process dies
    (ref: gcs_actor_manager.cc:1068-1079)."""

    @ray_tpu_torch.remote(max_restarts=2)
    class Phoenix:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

        def die(self):
            import os

            os._exit(1)

    p = Phoenix.remote()
    assert ray_tpu_torch.get(p.incr.remote(), timeout=30) == 1
    p.die.remote()
    time.sleep(1.0)
    # restarted: state reset (fresh __init__), but alive
    out = ray_tpu_torch.get(p.incr.remote(), timeout=60)
    assert out == 1


def test_actor_no_restart_death(two_node_cluster):
    @ray_tpu_torch.remote
    class Mortal:
        def die(self):
            import os

            os._exit(1)

        def ping(self):
            return "pong"

    m = Mortal.remote()
    assert ray_tpu_torch.get(m.ping.remote(), timeout=30) == "pong"
    m.die.remote()
    time.sleep(0.5)
    with pytest.raises(api.RayTaskError):
        ray_tpu_torch.get(m.ping.remote(), timeout=30)


def test_node_death_detection(two_node_cluster):
    """Killing a node flips it dead in the cluster view
    (ref: gcs_heartbeat_manager.cc death detection). Uses a sacrificial
    third node so the shared module cluster stays intact."""
    cluster = two_node_cluster
    doomed = cluster.add_node(num_cpus=1, resources={"doomed": 1})
    deadline = time.time() + 30
    while time.time() < deadline:
        if sum(1 for n in ray_tpu_torch.nodes() if n["Alive"]) == 3:
            break
        time.sleep(0.2)
    assert sum(1 for n in ray_tpu_torch.nodes() if n["Alive"]) == 3
    cluster.remove_node(doomed)
    deadline = time.time() + 30
    while time.time() < deadline:
        alive = sum(1 for n in ray_tpu_torch.nodes() if n["Alive"])
        if alive == 2:
            break
        time.sleep(0.5)
    assert sum(1 for n in ray_tpu_torch.nodes() if n["Alive"]) == 2


def test_saturation_queues_instead_of_erroring(two_node_cluster):
    """Cluster-wide saturation must queue leases, not bounce them between
    equally-busy nodes until the spillback hop cap errors (r2 verify bug:
    ping-ponged leases raised 'spillback loop exceeded 8 hops')."""
    import numpy as np

    @ray_tpu_torch.remote
    def chunk(i):
        time.sleep(0.2)
        return np.full(1 << 14, i % 120, np.uint8)

    # 24 tasks onto 4 total CPUs: most of the queue waits under saturation.
    refs = [chunk.remote(i) for i in range(24)]
    out = ray_tpu_torch.get(refs, timeout=120)
    assert [int(a[0]) for a in out] == [i % 120 for i in range(24)]


def test_large_object_transfer_and_broadcast(two_node_cluster):
    """64 MiB object pulled cross-node (windowed parallel chunks) and read
    by tasks on both nodes (broadcast path, ref: object_manager push/pull)."""
    import numpy as np

    arr = np.random.default_rng(0).integers(0, 255, 64 << 20, np.uint8)
    ref = ray_tpu_torch.put(arr)

    @ray_tpu_torch.remote(resources={"special": 0.01})
    def on_special(x):
        return int(x[123]), int(x.sum() % 1000)

    @ray_tpu_torch.remote
    def anywhere(x):
        return int(x[123])

    want = int(arr[123])
    a, b = ray_tpu_torch.get(
        [on_special.remote(ref), anywhere.remote(ref)], timeout=180)
    assert a[0] == want and b == want
