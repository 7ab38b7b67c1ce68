"""The port's runtime, case for case as the JAX package's
``tests/test_placement_groups.py``.

Placement groups: 2PC bundle reservation, strategies, bundle-backed
leases, removal. Mirrors `python/ray/tests/
test_placement_group*.py` behaviors at small scale."""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core.placement_group import (
    list_placement_groups,
    placement_group,
    remove_placement_group,
)


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
def where():
    import os

    return os.environ.get("RAY_TPU_TORCH_RAYLET_ADDRESS")


class TestSingleNode:
    def test_reservation_consumes_capacity(self, cluster):
        before = ray_tpu_torch.available_resources()["CPU"]
        pg = placement_group([{"CPU": 2}], strategy="STRICT_PACK")
        assert ray_tpu_torch.get(pg.ready(), timeout=30)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if ray_tpu_torch.available_resources()["CPU"] == before - 2:
                break
            time.sleep(0.2)
        assert ray_tpu_torch.available_resources()["CPU"] == before - 2
        remove_placement_group(pg)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if ray_tpu_torch.available_resources()["CPU"] == before:
                break
            time.sleep(0.2)
        assert ray_tpu_torch.available_resources()["CPU"] == before

    def test_infeasible_raises(self, cluster):
        with pytest.raises(RuntimeError, match="infeasible"):
            placement_group([{"CPU": 64}])

    def test_task_runs_in_bundle(self, cluster):
        pg = placement_group([{"CPU": 2}])
        out = ray_tpu_torch.get(
            where.options(placement_group=pg, num_cpus=1).remote(),
            timeout=60)
        assert out is not None
        assert any(p["pg_id"] == pg.id.binary()
                   for p in list_placement_groups())
        remove_placement_group(pg)

    def test_bundle_capacity_enforced(self, cluster):
        """Leases beyond the bundle's capacity queue until one frees."""
        pg = placement_group([{"CPU": 1}])

        @ray_tpu_torch.remote
        def hold(sec):
            import time as _t

            _t.sleep(sec)
            return time.time()

        t0 = time.time()
        refs = [hold.options(placement_group=pg, num_cpus=1).remote(1.0)
                for _ in range(2)]
        ends = ray_tpu_torch.get(refs, timeout=120)
        # Two 1s tasks through a 1-CPU bundle must serialize (≥2s total).
        assert max(ends) - t0 >= 2.0
        remove_placement_group(pg)

    def test_actor_in_bundle_holds_and_releases(self, cluster):
        pg = placement_group([{"CPU": 2}])

        @ray_tpu_torch.remote
        class A:
            def ping(self):
                return "pong"

        a = A.options(placement_group=pg, num_cpus=1).remote()
        assert ray_tpu_torch.get(a.ping.remote(), timeout=60) == "pong"
        ray_tpu_torch.kill(a)
        time.sleep(0.5)
        remove_placement_group(pg)


class TestMultiNode:
    def test_spread_and_strict_strategies(self):
        ray_tpu_torch.shutdown()  # detach from the single-node module fixture
        cluster = Cluster(head_node_args={"num_cpus": 2})
        ray_tpu_torch.init(address=cluster.address)
        try:
            cluster.add_node(num_cpus=2)
            cluster.add_node(num_cpus=2)
            cluster.wait_for_nodes(3)

            pg = placement_group([{"CPU": 1}] * 3, strategy="STRICT_SPREAD")
            rows = list_placement_groups()
            mine = next(p for p in rows if p["pg_id"] == pg.id.binary())
            nodes = {b["node_id"] for b in mine["bundles"]}
            assert len(nodes) == 3  # one bundle per distinct node
            remove_placement_group(pg)

            pg2 = placement_group([{"CPU": 1}] * 2, strategy="STRICT_PACK")
            rows = list_placement_groups()
            mine = next(p for p in rows if p["pg_id"] == pg2.id.binary())
            nodes = {b["node_id"] for b in mine["bundles"]}
            assert len(nodes) == 1  # all bundles co-located
            # A task binding a specific bundle lands on that bundle's node.
            out = ray_tpu_torch.get(
                where.options(placement_group=pg2, num_cpus=1,
                              placement_group_bundle_index=1).remote(),
                timeout=60)
            assert out is not None
            remove_placement_group(pg2)

            with pytest.raises(RuntimeError):
                placement_group([{"CPU": 1}] * 4, strategy="STRICT_SPREAD")
        finally:
            ray_tpu_torch.shutdown()
            cluster.shutdown()
