"""The port's actor pool, queue and multiprocessing shim
(``ray_tpu_torch/utils/{actor_pool,queue,multiprocessing}.py``) against
the JAX package's, case for case.

The cases of ``tests/test_util.py:68-150`` (``TestActorPool``,
``TestQueue``, ``TestMultiprocessingPool``) and one of the pool's
free-actor bookkeeping run the same values through both packages, each
on its own module-scoped cluster (``num_cpus=4``). The results are
compared with each other and with the reference's expected values.
Tolerance: exact.
"""

import threading
import types

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import utils as j_utils
from ray_tpu.utils import multiprocessing as j_mp
from ray_tpu_torch import utils as t_utils
from ray_tpu_torch.utils import multiprocessing as t_mp

PACKAGES = {"jax": (ray_tpu, j_utils, j_mp),
            "torch": (ray_tpu_torch, t_utils, t_mp)}


@pytest.fixture(scope="module")
def clusters():
    ray_tpu.init(num_cpus=4)
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def _both(case):
    """``case(p)`` under each package → the port's result, asserted equal
    to the JAX package's."""
    got = {}
    for name, (rt, utils, mp) in PACKAGES.items():
        got[name] = case(types.SimpleNamespace(rt=rt, utils=utils, mp=mp))
    assert got["torch"] == got["jax"], got
    return got["torch"]


def _doublers(p, n):
    class Doubler:
        def double(self, x):
            return 2 * x

    cls = p.rt.remote(Doubler)
    return [cls.remote() for _ in range(n)]


# ------------------------------------------------------------ ActorPool

def test_map_ordered_and_unordered(clusters):
    def case(p):
        pool = p.utils.ActorPool(_doublers(p, 2))
        ordered = list(pool.map(lambda a, v: a.double.remote(v), range(6)))
        unordered = sorted(pool.map_unordered(
            lambda a, v: a.double.remote(v), range(6)))
        return ordered, unordered

    assert _both(case) == ([0, 2, 4, 6, 8, 10], [0, 2, 4, 6, 8, 10])


def test_submit_more_than_actors_queues(clusters):
    def case(p):
        class Id:
            def f(self, x):
                return x

        pool = p.utils.ActorPool([p.rt.remote(Id).remote()])
        for i in range(5):
            pool.submit(lambda a, v: a.f.remote(v), i)
        return [pool.get_next() for _ in range(5)], pool.has_next()

    assert _both(case) == ([0, 1, 2, 3, 4], False)


def test_pop_idle_push_and_get_next_unordered(clusters):
    def case(p):
        pool = p.utils.ActorPool(_doublers(p, 2))
        spare = pool.pop_idle()
        free = [pool.has_free()]
        for v in (1, 2, 3):
            pool.submit(lambda a, v: a.double.remote(v), v)
        free.append(pool.has_free())     # one actor, busy; two queued
        pool.push(spare)                 # dispatches a queued value
        got = sorted(pool.get_next_unordered(timeout=60) for _ in range(3))
        with pytest.raises(StopIteration):
            pool.get_next()
        return free, got, pool.has_free(), pool.pop_idle() is not None

    assert _both(case) == ([True, False], [2, 4, 6], True, True)


# ---------------------------------------------------------------- Queue

def test_fifo_and_nowait(clusters):
    def case(p):
        q = p.utils.Queue()
        for i in range(3):
            q.put(i)
        size = q.qsize()
        got = [q.get() for _ in range(3)]
        with pytest.raises(p.utils.Empty):
            q.get_nowait()
        q.put_nowait_batch([5, 6, 7])
        batch = q.get_nowait_batch(2), q.get_nowait(), q.empty()
        q.shutdown()
        return size, got, batch

    assert _both(case) == (3, [0, 1, 2], ([5, 6], 7, True))


def test_maxsize_blocks_and_timeout(clusters):
    def case(p):
        q = p.utils.Queue(maxsize=2)
        q.put(1)
        q.put(2)
        full = q.full()
        with pytest.raises(p.utils.Full):
            q.put(3, timeout=0.2)
        with pytest.raises(p.utils.Full):
            q.put_nowait_batch([3])
        # A consumer unblocks the producer.
        t = threading.Thread(target=lambda: q.put(3, timeout=10))
        t.start()
        first = q.get()
        t.join(10)
        assert not t.is_alive()
        rest = sorted([q.get(), q.get()])
        with pytest.raises(p.utils.Empty):
            q.get(timeout=0.1)
        q.shutdown()
        return full, first, rest

    assert _both(case) == (True, 1, [2, 3])


def test_cross_task_queue(clusters):
    def case(p):
        q = p.utils.Queue()

        def producer(q, n):
            for i in range(n):
                q.put(i * i)
            return True

        ref = p.rt.remote(producer).remote(q, 4)
        got = sorted(q.get(timeout=30) for _ in range(4))
        done = p.rt.get(ref, timeout=60)
        q.shutdown()
        return got, done

    assert _both(case) == ([0, 1, 4, 9], True)


# ----------------------------------------------------- multiprocessing

def test_map_and_starmap(clusters):
    def case(p):
        with p.mp.Pool(processes=2) as pool:
            squares = pool.map(lambda x: x * x, range(8))
            sums = pool.starmap(lambda a, b: a + b, [(1, 2), (3, 4)])
            chunked = pool.map(lambda x: x + 1, range(7), chunksize=3)
            res = pool.map_async(lambda x: -x, range(5))
            res.wait(60)
            asynced = res.ready(), res.successful(), res.get(60)
        return squares, sums, chunked, asynced

    assert _both(case) == ([0, 1, 4, 9, 16, 25, 36, 49], [3, 7],
                           [1, 2, 3, 4, 5, 6, 7],
                           (True, True, [0, -1, -2, -3, -4]))


def test_apply_and_imap(clusters):
    def case(p):
        pool = p.mp.Pool(processes=2)
        applied = pool.apply(lambda a, b=0: a + b, (5,), {"b": 3})
        imapped = list(pool.imap(lambda x: -x, range(4)))
        unordered = sorted(pool.imap_unordered(lambda x: -x, range(4)))
        pool.close()
        pool.join()
        with pytest.raises(ValueError, match="closed"):
            pool.map(abs, [1])
        return applied, imapped, unordered

    assert _both(case) == (8, [0, -1, -2, -3], [-3, -2, -1, 0])
