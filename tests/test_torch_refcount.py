"""The port's runtime, case for case as the JAX package's
``tests/test_refcount.py``.

Distributed reference counting / automatic object GC.

Covers task outputs reclaimed with no explicit
`ray_tpu_torch.free`, store usage returning to baseline, plus borrower semantics
(actor-held refs survive the owner dropping its handle) and refs-in-refs
containment. Parity target: reference_count.h:61,511-556 semantics.
"""

import gc
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import api


def _store_stats(client):
    return client._run(client.raylet.call("store_stats", {}))


def _flush(client):
    client.refcounter.flush_now()


def _wait_for(pred, timeout=15.0, every=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(every)
    return pred()


@pytest.fixture(scope="module")
def client():
    ray_tpu_torch.init(num_cpus=4)
    yield api._client
    ray_tpu_torch.shutdown()


def test_put_drop_reclaims_shm(client):
    base = _store_stats(client)["shm_bytes"]
    ref = ray_tpu_torch.put(np.zeros(1 << 20, np.uint8))  # 1 MiB, in shm
    assert _store_stats(client)["shm_bytes"] >= base + (1 << 20)
    del ref
    gc.collect()
    _flush(client)
    assert _wait_for(
        lambda: _store_stats(client)["shm_bytes"] <= base + 4096
    ), _store_stats(client)


def test_inline_put_drop_removes_entry(client):
    n0 = _store_stats(client)["objects"]
    refs = [ray_tpu_torch.put(i) for i in range(50)]
    assert _store_stats(client)["objects"] >= n0 + 50
    del refs
    gc.collect()
    _flush(client)
    assert _wait_for(lambda: _store_stats(client)["objects"] <= n0 + 2)


def test_get_then_drop_releases_pin_and_entry(client):
    base = _store_stats(client)["shm_bytes"]
    ref = ray_tpu_torch.put(np.arange(1 << 18, dtype=np.int64))  # 2 MiB
    arr = ray_tpu_torch.get(ref)
    assert arr[5] == 5
    # Value holds a zero-copy view; dropping both must release pin + extent.
    del ref, arr
    gc.collect()
    _flush(client)
    # Deferred mmap release is retried on flush ticks.
    assert _wait_for(
        lambda: (_flush(client) or True)
        and _store_stats(client)["shm_bytes"] <= base + 4096
    ), _store_stats(client)


def test_task_output_soak_reclaimed(client):
    """Many task outputs with refs dropped immediately → store returns to
    baseline without any ray_tpu_torch.free."""

    @ray_tpu_torch.remote
    def blob():
        return np.zeros(1 << 17, np.uint8)  # 128 KiB, above inline cutoff

    base = _store_stats(client)["shm_bytes"]
    for _ in range(8):
        refs = [blob.remote() for _ in range(8)]
        ray_tpu_torch.get(refs)
        del refs
        gc.collect()
    _flush(client)
    assert _wait_for(
        lambda: _store_stats(client)["shm_bytes"] <= base + (1 << 18),
        timeout=20,
    ), _store_stats(client)


def test_fire_and_forget_output_reclaimed(client):
    """Dropping the return ref before the task finishes must still reclaim
    the output after it lands (escrow covers the in-flight window)."""

    @ray_tpu_torch.remote
    def slowblob():
        time.sleep(0.3)
        return np.zeros(1 << 18, np.uint8)

    base = _store_stats(client)["shm_bytes"]
    ref = slowblob.remote()
    del ref
    gc.collect()
    assert _wait_for(
        lambda: (_flush(client) or True)
        and _store_stats(client)["shm_bytes"] <= base + 4096,
        timeout=20,
    ), _store_stats(client)


def test_borrower_keeps_object_alive(client):
    """An actor storing a borrowed ref keeps the object alive after the
    owner drops its handle (ref: reference_count.h borrower registration)."""

    @ray_tpu_torch.remote
    class Holder:
        def __init__(self):
            self.ref = None

        def keep(self, refs):
            self.ref = refs[0]
            return True

        def read(self):
            return int(ray_tpu_torch.get(self.ref)[0])

        def drop(self):
            self.ref = None
            return True

    h = Holder.remote()
    ref = ray_tpu_torch.put(np.arange(1 << 16, dtype=np.int64))
    # Pass the ref *inside a container* so the actor receives the ObjectRef
    # itself (a bare top-level ref arg is resolved to its value).
    assert ray_tpu_torch.get(h.keep.remote([ref]))
    oid = ref.id.binary()
    del ref
    gc.collect()
    _flush(client)
    time.sleep(1.0)
    # Still resolvable through the actor's borrow.
    assert ray_tpu_torch.get(h.read.remote()) == 0
    # Actor drops it → reclaimed.
    assert ray_tpu_torch.get(h.drop.remote())
    assert _wait_for(
        lambda: not client._run(
            client.raylet.call("store_contains", {"object_ids": [oid]})
        )[0],
        timeout=20,
    )


def test_refs_in_refs_containment(client):
    """put(list-of-refs): inner objects live while the outer object lives."""
    inner = ray_tpu_torch.put(np.arange(1 << 16, dtype=np.int64))
    inner_oid = inner.id.binary()
    outer = ray_tpu_torch.put([inner])
    del inner
    gc.collect()
    _flush(client)
    time.sleep(0.8)
    assert client._run(
        client.raylet.call("store_contains", {"object_ids": [inner_oid]})
    )[0]
    # Getting the outer returns a usable inner ref.
    inner2 = ray_tpu_torch.get(outer)[0]
    assert ray_tpu_torch.get(inner2)[1] == 1
    del inner2
    del outer
    gc.collect()
    _flush(client)
    assert _wait_for(
        lambda: (_flush(client) or True)
        and not client._run(
            client.raylet.call("store_contains", {"object_ids": [inner_oid]})
        )[0],
        timeout=20,
    )


def test_arg_ref_alive_during_pending_task(client):
    """Submitter escrow: dropping an arg ref right after submit must not
    free the argument before the (slow) task reads it."""

    @ray_tpu_torch.remote
    def consume(x):
        time.sleep(0.5)
        return int(x[7])

    ref = ray_tpu_torch.put(np.arange(1 << 16, dtype=np.int64))
    out = consume.remote(ref)
    del ref
    gc.collect()
    _flush(client)
    assert ray_tpu_torch.get(out) == 7
