"""The port's runtime, case for case as the JAX package's
``tests/test_lineage.py``.

Lineage reconstruction: lost objects rebuilt by re-executing their
creating tasks (ref: object_recovery_manager.h:41,90): kill a node holding blocks mid-get; the get completes.

The cluster fixture is module-scoped (per-test cluster boots dominated CI
wall time); each test sacrifices its OWN victim node tagged with a
test-unique resource, so an earlier test's replacement node can never
absorb a later test's "special" tasks and mask the reconstruction path.
"""

import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core.client import _release_views


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(head_node_args={"num_cpus": 2})
    ray_tpu_torch.init(address=c.address)
    yield c
    ray_tpu_torch.shutdown()
    c.shutdown()


def _alive() -> int:
    return sum(1 for n in ray_tpu_torch.nodes() if n["Alive"])


def _wait_alive(k: int, timeout: float = 30.0) -> None:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if _alive() == k:
            return
        time.sleep(0.2)
    raise TimeoutError(f"alive nodes never reached {k} (now {_alive()})")


def _on(res: str, **extra):
    return ray_tpu_torch.remote(resources={res: 0.01}, **extra)


def _drop_local_copies(refs) -> None:
    """Force the driver to refetch from the cluster."""
    client = ray_tpu_torch.api._client
    for r in refs:
        client._memory_store.pop(r.id.binary(), None)
        entry = client._mmaps.pop(r.id.binary(), None)
        if entry is not None:
            _release_views(entry)


def test_node_death_rebuilds_task_output(cluster):
    """Outputs stored only on a dead node are rebuilt from lineage."""
    base_alive = _alive()
    victim = cluster.add_node(num_cpus=2, resources={"sp_rebuild": 1})
    _wait_alive(base_alive + 1)

    @_on("sp_rebuild")
    def blob(tag):
        return np.full(1 << 17, tag, np.uint8)  # 128 KiB → stored in shm

    refs = [blob.remote(i) for i in range(3)]
    ray_tpu_torch.get(refs, timeout=60)  # materialized on the victim node
    cluster.remove_node(victim)
    spare = cluster.add_node(num_cpus=2, resources={"sp_rebuild": 1})
    _wait_alive(base_alive + 1)
    _drop_local_copies(refs)
    out = ray_tpu_torch.get(refs, timeout=90)
    assert [int(a[0]) for a in out] == [0, 1, 2]
    cluster.remove_node(spare)     # the module's cluster keeps its size
    _wait_alive(base_alive)


def test_transitive_reconstruction(cluster):
    """A lost object whose creating task's *argument* is also lost rebuilds
    the whole chain."""
    base_alive = _alive()
    victim = cluster.add_node(num_cpus=2, resources={"sp_trans": 1})
    _wait_alive(base_alive + 1)

    @_on("sp_trans")
    def base():
        return np.arange(1 << 15, dtype=np.int64)  # 256 KiB

    @_on("sp_trans")
    def double(x):
        return x * 2

    b = base.remote()
    c = double.remote(b)
    assert int(ray_tpu_torch.get(c, timeout=60)[3]) == 6
    cluster.remove_node(victim)
    spare = cluster.add_node(num_cpus=2, resources={"sp_trans": 1})
    _wait_alive(base_alive + 1)
    _drop_local_copies([b, c])
    out = ray_tpu_torch.get(c, timeout=90)
    assert int(out[5]) == 10
    cluster.remove_node(spare)
    _wait_alive(base_alive)


def test_chain_survives_dropped_intermediate_ref(cluster):
    """`del b` after submitting double(b): b's lineage stays pinned through
    c's spec (lineage deps), so c still reconstructs after loss."""
    base_alive = _alive()
    victim = cluster.add_node(num_cpus=2, resources={"sp_chain": 1})
    _wait_alive(base_alive + 1)

    @_on("sp_chain")
    def base():
        return np.ones(1 << 15, np.int64)

    @_on("sp_chain")
    def tripled(x):
        return x * 3

    b = base.remote()
    c = tripled.remote(b)
    del b
    assert int(ray_tpu_torch.get(c, timeout=60)[0]) == 3
    cluster.remove_node(victim)
    spare = cluster.add_node(num_cpus=2, resources={"sp_chain": 1})
    _wait_alive(base_alive + 1)
    _drop_local_copies([c])
    assert int(ray_tpu_torch.get(c, timeout=90)[1]) == 3
    cluster.remove_node(spare)
    _wait_alive(base_alive)


def test_lost_put_restored_from_owner_copy(cluster):
    """put() objects aren't task-recreatable, but the owner holds the value
    and re-stores it (strictly better than the reference, which fails)."""
    ref = ray_tpu_torch.put(np.arange(64, dtype=np.int64))
    client = ray_tpu_torch.api._client
    # Simulate loss: free in the node store + directory, keep our ref.
    client._run(client.raylet.call(
        "store_free", {"object_ids": [ref.id.binary()]}))
    # The local memory-store cache makes get() trivially succeed; the real
    # restore path is exercised when a *worker* needs the object:

    @ray_tpu_torch.remote
    def reads(x):
        return int(x[7])

    assert ray_tpu_torch.get(reads.remote(ref), timeout=60) == 7


def test_dynamic_generator_items_recover(cluster):
    """Items of a num_returns="dynamic" generator heal after node death:
    their ids derive from the creating task, so replaying the generator
    re-stores them."""
    base_alive = _alive()
    victim = cluster.add_node(num_cpus=2, resources={"sp_dyn": 1})
    _wait_alive(base_alive + 1)

    @_on("sp_dyn", num_returns="dynamic", max_retries=2)
    def gen(n):
        for i in range(n):
            yield np.full(1 << 17, i, np.uint8)  # each item in shm

    item_refs = ray_tpu_torch.get(gen.remote(3), timeout=60)
    assert len(item_refs) == 3
    # Materialize one item pre-death to prove normal reads work.
    assert int(ray_tpu_torch.get(item_refs[1], timeout=60)[0]) == 1

    cluster.remove_node(victim)
    spare = cluster.add_node(num_cpus=2, resources={"sp_dyn": 1})
    _wait_alive(base_alive + 1)
    _drop_local_copies(item_refs)

    vals = ray_tpu_torch.get(list(item_refs), timeout=120)
    assert [int(v[0]) for v in vals] == [0, 1, 2]
    cluster.remove_node(spare)
    _wait_alive(base_alive)
