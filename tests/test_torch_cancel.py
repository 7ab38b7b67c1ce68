"""The port's runtime, case for case as the JAX package's
``tests/test_cancel.py``.

ray_tpu_torch.cancel + async actors + concurrency groups.

Cancel covering queued/running/force plus an
async actor test. Ref: _private/worker.py:2389 (cancel),
core_worker/fiber.h (async actors),
transport/concurrency_group_manager.cc (named groups).
"""

import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.api import TaskCancelledError


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=2)
    yield
    ray_tpu_torch.shutdown()


def test_cancel_queued_task(cluster):
    """Only 2 CPUs: the tail of the burst is still queued when cancelled."""

    @ray_tpu_torch.remote
    def slow():
        time.sleep(1.0)
        return 1

    refs = [slow.remote() for _ in range(6)]
    victim = refs[-1]
    assert ray_tpu_torch.cancel(victim)
    with pytest.raises(TaskCancelledError):
        ray_tpu_torch.get(victim, timeout=60)
    assert ray_tpu_torch.get(refs[:2], timeout=60) == [1, 1]


def test_cancel_running_task(cluster):
    """Cooperative cancel interrupts Python-level execution between
    bytecodes (a single C-level sleep(60) is only interruptible with
    force=True — same CPython limitation as the reference's KeyboardInterrupt
    delivery)."""

    @ray_tpu_torch.remote(max_retries=0)
    def parked():
        for _ in range(600):
            time.sleep(0.1)
        return -1

    ref = parked.remote()
    time.sleep(1.5)  # ensure it is executing
    assert ray_tpu_torch.cancel(ref)
    t0 = time.monotonic()
    with pytest.raises(TaskCancelledError):
        ray_tpu_torch.get(ref, timeout=60)
    assert time.monotonic() - t0 < 30  # did not wait out the sleep


def test_cancel_force_kills_worker(cluster):
    @ray_tpu_torch.remote(max_retries=0)
    def hard_locked():
        # Cooperative cancel can't interrupt C-level sleep loops promptly in
        # all cases; force must kill the process.
        while True:
            time.sleep(0.2)

    ref = hard_locked.remote()
    time.sleep(1.5)
    assert ray_tpu_torch.cancel(ref, force=True)
    with pytest.raises(ray_tpu_torch.api.RayTaskError):
        ray_tpu_torch.get(ref, timeout=60)


def test_async_actor_concurrent_methods(cluster):
    """async def methods run concurrently on the actor's event loop up to
    max_concurrency — two parked awaits overlap instead of serializing."""

    @ray_tpu_torch.remote(max_concurrency=4)
    class AsyncActor:
        def __init__(self):
            self.events = []

        async def wait_a_bit(self, tag):
            import asyncio

            self.events.append(("start", tag))
            await asyncio.sleep(0.5)
            self.events.append(("end", tag))
            return tag

        def log(self):
            return list(self.events)

    a = AsyncActor.remote()
    ray_tpu_torch.get(a.log.remote(), timeout=60)  # wait for the actor to be up
    t0 = time.monotonic()
    out = ray_tpu_torch.get([a.wait_a_bit.remote(i) for i in range(4)], timeout=60)
    dt = time.monotonic() - t0
    assert sorted(out) == [0, 1, 2, 3]
    # 4 × 0.5s sleeps overlapped: well under the 2s serial time.
    assert dt < 1.8, dt
    log = ray_tpu_torch.get(a.log.remote(), timeout=60)
    kinds = [kind for kind, _t in log]
    # at least two "start"s before the first "end": calls overlapped
    assert kinds.index("end") >= 2


def test_cancel_async_actor_call(cluster):
    @ray_tpu_torch.remote(max_concurrency=2)
    class Sleeper:
        async def park(self):
            import asyncio

            await asyncio.sleep(60)
            return -1

        def ping(self):
            return "pong"

    s = Sleeper.remote()
    ref = s.park.remote()
    time.sleep(1.0)
    assert ray_tpu_torch.cancel(ref)
    with pytest.raises(TaskCancelledError):
        ray_tpu_torch.get(ref, timeout=60)
    # actor still alive and serving
    assert ray_tpu_torch.get(s.ping.remote(), timeout=60) == "pong"


def test_concurrency_groups_isolate_lanes(cluster):
    """A saturated "io" group must not block "compute" group calls
    (ref: concurrency_group_manager.cc named pools)."""

    @ray_tpu_torch.remote(concurrency_groups={"io": 1, "compute": 1})
    class Grouped:
        def __init__(self):
            self.done = []

        @ray_tpu_torch.method(concurrency_group="io")
        def slow_io(self):
            time.sleep(3.0)
            self.done.append(("io", time.monotonic()))
            return "io"

        @ray_tpu_torch.method(concurrency_group="compute")
        def quick(self):
            self.done.append(("compute", time.monotonic()))
            return "compute"

        def log(self):
            return list(self.done)

    g = Grouped.remote()
    ray_tpu_torch.get(g.log.remote(), timeout=60)  # actor up
    slow_ref = g.slow_io.remote()
    time.sleep(0.3)
    assert ray_tpu_torch.get(g.quick.remote(), timeout=60) == "compute"
    assert ray_tpu_torch.get(slow_ref, timeout=60) == "io"
    # Actor-side ordering (immune to driver/RPC load): quick finished while
    # slow_io still held the io lane.
    log = ray_tpu_torch.get(g.log.remote(), timeout=60)
    times = dict(log)
    assert times["compute"] < times["io"], log
