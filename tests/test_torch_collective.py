"""The port's host collectives (``ray_tpu_torch/utils/collective.py``),
case for case as ``tests/test_util.py``'s ``TestCollective``, on the
port's runtime: numpy payloads and CPU tensors exchanged through the
named rendezvous actor."""

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


class TestCollective:
    def test_allreduce_allgather_across_tasks(self, cluster):
        @rt.remote
        def worker(rank, world):
            from ray_tpu_torch.utils import collective as col

            col.init_collective_group(world, rank, group_name="g1")
            s = col.allreduce(np.full(4, rank + 1.0), group_name="g1")
            g = col.allgather(np.array([rank]), group_name="g1")
            t = col.allreduce(torch.full((2,), float(rank)),
                              group_name="g1")
            col.barrier(group_name="g1")
            return s, [int(x) for x in g], t

        out = rt.get([worker.remote(r, 3) for r in range(3)])
        for s, g, t in out:
            np.testing.assert_array_equal(s, np.full(4, 6.0))  # 1+2+3
            assert g == [0, 1, 2]
            np.testing.assert_array_equal(t, np.full(2, 3.0))  # 0+1+2

    def test_reducescatter_broadcast_sendrecv(self, cluster):
        @rt.remote
        def worker(rank, world):
            from ray_tpu_torch.utils import collective as col

            col.init_collective_group(world, rank, group_name="g2")
            rs = col.reducescatter(np.arange(4, dtype=np.float64),
                                   group_name="g2")
            bc = col.broadcast(
                np.array([42.0]) if rank == 0 else None,
                src_rank=0, group_name="g2")
            if rank == 0:
                col.send(np.array([7.0]), dst_rank=1, group_name="g2")
                p2p = None
            elif rank == 1:
                p2p = col.recv(src_rank=0, group_name="g2")
            else:
                p2p = None
            return rs, float(bc[0]), p2p

        out = rt.get([worker.remote(r, 2) for r in range(2)])
        # reduce: [0,2,4,6]; rank0 slice [0,2], rank1 [4,6]
        np.testing.assert_array_equal(out[0][0], [0.0, 2.0])
        np.testing.assert_array_equal(out[1][0], [4.0, 6.0])
        assert out[0][1] == out[1][1] == 42.0
        np.testing.assert_array_equal(out[1][2], [7.0])
