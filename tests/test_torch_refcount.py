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


def test_fresh_return_outlives_a_borrowers_release(client):
    """A task's return passed on before the owner's acquire reached the
    GCS (the periodic flush stopped here, so that window stays open): the
    borrower's release after its task must find the owner among the
    object's holders. The submitter publishes its holds on a task's ref
    arguments before the spec leaves the process; without that the GCS
    freed the object on the borrower's release (owner unknown, holders
    empty) and, where its task's own arguments were gone, the next reader
    hung (the data plane's chained repartitions waited 300 s)."""

    @ray_tpu_torch.remote
    def ident(x):
        return x

    @ray_tpu_torch.remote
    def total(x):
        return int(x.sum())

    rc = client.refcounter
    client._loop.call_soon_threadsafe(rc._flush_task.cancel)
    try:
        src = ray_tpu_torch.put(np.arange(1 << 17, dtype=np.int64))
        x = ident.remote(src)
        del src
        gc.collect()
        oid = x.id.binary()
        for _ in range(3):
            assert ray_tpu_torch.get(total.remote(x), timeout=30) == (
                (1 << 17) * ((1 << 17) - 1) // 2)
            time.sleep(0.3)     # the workers' own flushes send releases
            held = client._run(client.gcs.call(
                "ref_debug", {"object_ids": [oid]}))[oid]["holders"]
            assert rc.holder_id in held, held
    finally:
        client._run(client._start_ref_flusher())
        _flush(client)


def test_actor_task_fresh_arg_outlives_a_borrowers_release(client):
    """The same window for an actor task: a fresh actor-task return,
    whose owner's acquire has not reached the GCS (the periodic flush
    stopped), handed to another actor's method. The submitter publishes
    its holds on the ref arguments before the spec is queued for the
    actor; without that the borrower's release after each call left the
    object with no holder the GCS knew of."""

    @ray_tpu_torch.remote
    class Source:
        def make(self, n):
            return np.arange(n, dtype=np.int64)

    @ray_tpu_torch.remote
    class Summer:
        def total(self, x):
            return int(x.sum())

    src, summer = Source.remote(), Summer.remote()
    n = 1 << 17
    assert ray_tpu_torch.get(summer.total.remote(np.arange(4)),
                             timeout=30) == 6
    rc = client.refcounter
    client._loop.call_soon_threadsafe(rc._flush_task.cancel)
    try:
        x = src.make.remote(n)
        oid = x.id.binary()
        for _ in range(3):
            assert ray_tpu_torch.get(summer.total.remote(x), timeout=30) == (
                n * (n - 1) // 2)
            time.sleep(0.3)     # the actor's own flushes send releases
            held = client._run(client.gcs.call(
                "ref_debug", {"object_ids": [oid]}))[oid]["holders"]
            assert rc.holder_id in held, held
    finally:
        client._run(client._start_ref_flusher())
        _flush(client)


def test_actor_tasks_submitted_on_the_client_loop_keep_order(client):
    """A submission made on the client's own event loop, where waiting
    for the publication would block the loop it runs on: the dispatch is
    chained behind the publication, later calls to the actor behind it,
    so the calls run in submission order and the fresh argument's holds
    reach the GCS."""

    @ray_tpu_torch.remote
    class Source:
        def make(self, n):
            return np.arange(n, dtype=np.int64)

    @ray_tpu_torch.remote
    class Log:
        def __init__(self):
            self.seen = []

        def add(self, x):
            self.seen.append(int(np.asarray(x).sum()))
            return len(self.seen)

        def log(self):
            return self.seen

    src, log = Source.remote(), Log.remote()
    assert ray_tpu_torch.get(log.log.remote(), timeout=30) == []
    rc = client.refcounter
    client._loop.call_soon_threadsafe(rc._flush_task.cancel)
    try:
        x = src.make.remote(1 << 10)
        oid = x.id.binary()

        async def submit():
            return [log.add.remote(x), log.add.remote(np.arange(3)),
                    log.add.remote(x)]

        refs = client._run(submit())
        assert ray_tpu_torch.get(refs, timeout=30) == [1, 2, 3]
        total = (1 << 10) * ((1 << 10) - 1) // 2
        assert ray_tpu_torch.get(log.log.remote(), timeout=30) == [
            total, 3, total]
        held = client._run(client.gcs.call(
            "ref_debug", {"object_ids": [oid]}))[oid]["holders"]
        assert rc.holder_id in held, held
    finally:
        client._run(client._start_ref_flusher())
        _flush(client)
