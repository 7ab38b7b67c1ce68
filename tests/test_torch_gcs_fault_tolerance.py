"""The port's runtime, case for case as the JAX package's
``tests/test_gcs_fault_tolerance.py``.

GCS fault tolerance: kill + restart the control plane; the cluster
heals. Mirrors `python/ray/tests/test_gcs_fault_tolerance.
py` + `gcs_client_reconnection_test.cc` behaviors."""

import time

import numpy as np
import pytest

import ray_tpu_torch


@pytest.fixture()
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def _restart_gcs():
    from ray_tpu_torch import api

    api._node.restart_gcs()


class TestGcsFailover:
    def test_tasks_survive_gcs_restart(self, cluster):
        @ray_tpu_torch.remote
        def add(a, b):
            return a + b

        assert ray_tpu_torch.get(add.remote(1, 2), timeout=60) == 3
        _restart_gcs()
        # New work flows as soon as everyone reconnects.
        out = ray_tpu_torch.get([add.remote(i, i) for i in range(5)], timeout=120)
        assert out == [0, 2, 4, 6, 8]

    def test_actor_and_kv_state_survive(self, cluster):
        @ray_tpu_torch.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def incr(self):
                self.n += 1
                return self.n

        c = Counter.options(name="ft_counter").remote()
        assert ray_tpu_torch.get(c.incr.remote(), timeout=60) == 1
        from ray_tpu_torch import api

        client = api._ensure_client()
        client.kv_put("userspace", b"k1", b"v1")
        time.sleep(1.5)  # let the snapshot loop persist the state
        _restart_gcs()
        # Actor directory recovered: the named handle still resolves and
        # the actor (which never died) kept its in-memory state.
        c2 = ray_tpu_torch.get_actor("ft_counter")
        assert ray_tpu_torch.get(c2.incr.remote(), timeout=120) == 2
        assert client.kv_get("userspace", b"k1") == b"v1"

    def test_objects_resolvable_after_restart(self, cluster):
        big = np.arange(200_000, dtype=np.float64)
        ref = ray_tpu_torch.put(big)
        time.sleep(1.5)
        _restart_gcs()

        @ray_tpu_torch.remote
        def total(x):
            return float(x.sum())

        # The object directory healed (snapshot + re-announce), so a task
        # can still consume the pre-restart object.
        out = ray_tpu_torch.get(total.remote(ref), timeout=120)
        assert out == float(big.sum())


class TestWalDurability:
    """Per-mutation WAL: kill -9 the GCS immediately
    after mutations — before any snapshot tick — and nothing is lost."""

    def test_kv_and_pg_survive_immediate_kill(self):
        ray_tpu_torch.init(num_cpus=4, _system_config={
            # Snapshot compaction effectively disabled: only the WAL can
            # preserve these mutations across the kill.
            "gcs_snapshot_interval_s": 3600.0,
        })
        try:
            from ray_tpu_torch import api
            from ray_tpu_torch.core.placement_group import placement_group

            client = api._client
            client.kv_put("t", b"k1", b"v1")
            pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
            pg.ready()
            _restart_gcs()
            assert client.kv_get("t", b"k1") == b"v1"
            pgs = client.list_placement_groups()
            assert any(p["pg_id"] == pg.id.binary() for p in pgs)
            # And the cluster still schedules through the recovered state.

            @ray_tpu_torch.remote(placement_group=pg)
            def inside():
                return "ok"

            assert ray_tpu_torch.get(inside.remote(), timeout=60) == "ok"
        finally:
            ray_tpu_torch.shutdown()

    def test_named_actor_rebuilt_from_wal(self):
        ray_tpu_torch.init(num_cpus=4, _system_config={
            "gcs_snapshot_interval_s": 3600.0,
        })
        try:
            @ray_tpu_torch.remote
            class Counter:
                def __init__(self):
                    self.n = 0

                def incr(self):
                    self.n += 1
                    return self.n

            c = Counter.options(name="walled").remote()
            assert ray_tpu_torch.get(c.incr.remote(), timeout=60) == 1
            _restart_gcs()
            time.sleep(1.0)
            c2 = ray_tpu_torch.get_actor("walled")
            assert ray_tpu_torch.get(c2.incr.remote(), timeout=60) == 2
        finally:
            ray_tpu_torch.shutdown()
