"""The port's runtime, case for case as the JAX package's
``tests/test_core_api.py``.

Single-node integration tests for the tasks/actors/objects API.

Mirrors the reference's `python/ray/tests/test_basic*.py` coverage: remote
functions, options, multiple returns, object passing, actors, named actors,
errors, wait, kill.
"""

import gc
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import api


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
def plus_one(x):
    return x + 1


@ray_tpu_torch.remote
class Counter:
    def __init__(self, start=0):
        self.n = start

    def incr(self, k=1):
        self.n += k
        return self.n

    def get(self):
        return self.n

    def boom(self):
        raise RuntimeError("actor error")


def test_task_basic(cluster):
    assert ray_tpu_torch.get(plus_one.remote(1), timeout=30) == 2


def test_task_kwargs_and_closure(cluster):
    y = 100

    @ray_tpu_torch.remote
    def f(a, b=10):
        return a + b + y

    assert ray_tpu_torch.get(f.remote(1), timeout=30) == 111
    assert ray_tpu_torch.get(f.remote(1, b=20), timeout=30) == 121


def test_many_parallel_tasks(cluster):
    refs = [plus_one.remote(i) for i in range(50)]
    assert sum(ray_tpu_torch.get(refs, timeout=60)) == sum(range(1, 51))


def test_num_returns(cluster):
    @ray_tpu_torch.remote(num_returns=3)
    def three():
        return 1, 2, 3

    a, b, c = three.remote()
    assert ray_tpu_torch.get([a, b, c], timeout=30) == [1, 2, 3]


def test_put_get_roundtrip(cluster):
    ref = ray_tpu_torch.put({"k": [1, 2, 3]})
    assert ray_tpu_torch.get(ref, timeout=30) == {"k": [1, 2, 3]}


def test_large_object_via_shm(cluster):
    arr = np.random.default_rng(0).standard_normal(500_000)
    ref = ray_tpu_torch.put(arr)

    @ray_tpu_torch.remote
    def mean(a):
        return float(a.mean())

    assert abs(ray_tpu_torch.get(mean.remote(ref), timeout=30) - arr.mean()) < 1e-12


def test_large_task_return(cluster):
    @ray_tpu_torch.remote
    def big():
        return np.ones(300_000)

    out = ray_tpu_torch.get(big.remote(), timeout=30)
    assert out.shape == (300_000,)
    assert out.sum() == 300_000


def test_zero_copy_value_outlives_its_ref(cluster):
    """A got array is a zero-copy view of its extent: the extent stays
    pinned while the array lives, after its ObjectRef died (here at
    once), so the next objects' extents never overwrite it (the JAX
    runtime unpins at the ref's death and corrupts such arrays)."""
    @ray_tpu_torch.remote
    def filled(v):
        return {"a": np.full(1 << 18, v, np.float32)}

    kept = []
    for v in range(8):
        kept.append(ray_tpu_torch.get(filled.remote(v), timeout=30)["a"])
        gc.collect()    # the ref's death releases its extent view
    time.sleep(0.5)     # the unpins of dead refs are fire-and-forget
    assert [v for v, a in enumerate(kept) if not (a == v).all()] == []
    del kept            # then the extents go back to the store
    for v in range(8):
        assert ray_tpu_torch.get(filled.remote(v), timeout=30)["a"][0] == v


def test_object_ref_args_chain(cluster):
    @ray_tpu_torch.remote
    def add(a, b):
        return a + b

    r = add.remote(plus_one.remote(1), plus_one.remote(2))
    assert ray_tpu_torch.get(r, timeout=30) == 5


def test_error_propagation(cluster):
    @ray_tpu_torch.remote
    def boom():
        raise ValueError("xyz")

    with pytest.raises(api.RayTaskError) as ei:
        ray_tpu_torch.get(boom.remote(), timeout=30)
    assert ei.value.exc_type == "ValueError"
    assert "xyz" in str(ei.value)


def test_error_through_dependency(cluster):
    @ray_tpu_torch.remote
    def boom():
        raise ValueError("dep failed")

    @ray_tpu_torch.remote
    def consume(x):
        return x

    with pytest.raises(api.RayTaskError):
        ray_tpu_torch.get(consume.remote(boom.remote()), timeout=30)


def test_wait(cluster):
    @ray_tpu_torch.remote
    def slow(t):
        time.sleep(t)
        return t

    refs = [slow.remote(0.05), slow.remote(10)]
    ready, pending = ray_tpu_torch.wait(refs, num_returns=1, timeout=5)
    assert len(ready) == 1 and len(pending) == 1
    assert ray_tpu_torch.get(ready[0], timeout=10) == 0.05


def test_nested_tasks(cluster):
    @ray_tpu_torch.remote
    def inner(x):
        return x * 2

    @ray_tpu_torch.remote
    def outer(x):
        import ray_tpu_torch as rt

        return rt.get(inner.remote(x), timeout=30) + 1

    assert ray_tpu_torch.get(outer.remote(10), timeout=60) == 21


def test_actor_basic(cluster):
    c = Counter.remote(5)
    assert ray_tpu_torch.get(c.incr.remote(), timeout=30) == 6
    assert ray_tpu_torch.get(c.incr.remote(10), timeout=30) == 16
    assert ray_tpu_torch.get(c.get.remote(), timeout=30) == 16


def test_actor_method_ordering(cluster):
    c = Counter.remote(0)
    refs = [c.incr.remote() for _ in range(20)]
    vals = ray_tpu_torch.get(refs, timeout=30)
    assert vals == list(range(1, 21))


def test_actor_error(cluster):
    c = Counter.remote(0)
    with pytest.raises(api.RayTaskError):
        ray_tpu_torch.get(c.boom.remote(), timeout=30)
    # actor survives method errors
    assert ray_tpu_torch.get(c.incr.remote(), timeout=30) == 1


def test_actor_handle_passing(cluster):
    c = Counter.remote(0)

    @ray_tpu_torch.remote
    def use_actor(h):
        import ray_tpu_torch as rt

        return rt.get(h.incr.remote(7), timeout=30)

    assert ray_tpu_torch.get(use_actor.remote(c), timeout=60) == 7


def test_named_actor(cluster):
    Counter.options(name="named-1").remote(42)
    h = ray_tpu_torch.get_actor("named-1")
    assert ray_tpu_torch.get(h.get.remote(), timeout=30) == 42
    with pytest.raises(ValueError):
        ray_tpu_torch.get_actor("does-not-exist")


def test_kill_actor(cluster):
    c = Counter.options(name="to-kill").remote(0)
    assert ray_tpu_torch.get(c.get.remote(), timeout=30) == 0
    ray_tpu_torch.kill(c)
    time.sleep(0.3)
    with pytest.raises(api.RayTaskError):
        ray_tpu_torch.get(c.get.remote(), timeout=10)


def test_options_validation(cluster):
    with pytest.raises(ValueError):
        plus_one.options(bogus=1)
    with pytest.raises(TypeError):
        plus_one(1)  # direct call forbidden


def test_cluster_resources(cluster):
    total = ray_tpu_torch.cluster_resources()
    assert total.get("CPU", 0) >= 4


def test_free(cluster):
    ref = ray_tpu_torch.put(np.ones(200_000))
    assert ray_tpu_torch.get(ref, timeout=10) is not None
    ray_tpu_torch.free([ref])


class TestDynamicReturns:
    def test_generator_returns_list_of_refs(self, cluster):
        """num_returns="dynamic" (ref: dynamic generator returns,
        _raylet.pyx:602): a generator task yields N objects; the single
        return resolves to their refs."""
        import numpy as np

        @ray_tpu_torch.remote(num_returns="dynamic")
        def gen(n):
            for i in range(n):
                yield np.full(8, i, np.int64)

        ref = gen.remote(5)
        item_refs = ray_tpu_torch.get(ref, timeout=60)
        assert len(item_refs) == 5
        vals = ray_tpu_torch.get(item_refs, timeout=60)
        assert [int(v[0]) for v in vals] == [0, 1, 2, 3, 4]

    def test_dynamic_items_gcd_with_outer(self, cluster):
        """Dropping the outer ref (and item refs) reclaims the items via
        refs-in-refs containment."""
        import gc
        import time

        import numpy as np
        from ray_tpu_torch import api

        @ray_tpu_torch.remote(num_returns="dynamic")
        def gen():
            for i in range(3):
                yield np.zeros(1 << 17, np.uint8)  # 128 KiB each, in shm

        client = api._client

        def shm():
            return client._run(client.raylet.call("store_stats", {}))["shm_bytes"]

        base = shm()
        ref = gen.remote()
        items = ray_tpu_torch.get(ref, timeout=60)
        assert shm() >= base + 3 * (1 << 17)
        oids = [r.id.binary() for r in items]
        del ref, items
        gc.collect()
        client.refcounter.flush_now()
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and shm() > base + 4096:
            client.refcounter.flush_now()
            time.sleep(0.3)
        assert shm() <= base + 4096, shm()
        # GCS-side introspection agrees: no holders remain on any item.
        dbg = client._run(client.gcs.call(
            "ref_debug", {"object_ids": oids}))
        for oid, info in dbg.items():
            assert not info["holders"], (oid.hex()[:12], info)


def test_max_task_retries_resubmits_after_actor_restart(cluster, tmp_path):
    """max_task_retries (distinct from task max_retries, ref:
    ray_option_utils.py:158-159): a method call in flight when the actor
    dies is resubmitted to the restarted instance."""
    import os

    marker = str(tmp_path / "died-once")

    @ray_tpu_torch.remote(max_restarts=2, max_task_retries=2)
    class Fragile:
        def risky(self, marker):
            if not os.path.exists(marker):
                open(marker, "w").close()
                os._exit(1)  # die mid-call, first time only
            return "recovered"

    f = Fragile.remote()
    assert ray_tpu_torch.get(f.risky.remote(marker), timeout=120) == "recovered"


def test_actor_task_default_no_retry(cluster, tmp_path):
    """Without max_task_retries, a call in flight when the actor dies fails
    (it may have partially executed)."""
    import os

    marker = str(tmp_path / "died-once-2")

    @ray_tpu_torch.remote(max_restarts=2)
    class Fragile:
        def risky(self, marker):
            if not os.path.exists(marker):
                open(marker, "w").close()
                os._exit(1)
            return "recovered"

    f = Fragile.remote()
    with pytest.raises(ray_tpu_torch.api.RayTaskError):
        ray_tpu_torch.get(f.risky.remote(marker), timeout=120)
