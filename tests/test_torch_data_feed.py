"""The data plane feeding the port's training and batch inference.

- ``iter_cuda_batches(device="cpu")`` equals ``iter_batches`` (the dtype
  cast included), on datasets and pipelines, and takes the port's batch
  sharding (a rank's rows of each global batch); the default device
  raises without a GPU, and anything but the port's batch sharding
  raises. (The card's pinned, side-stream path is held in
  ``tests/test_torch_cuda.py``.)
- ``TorchTrainer(datasets=...)`` on two gloo ranks (``device="cpu"``, the
  tiny GPT, fp32): each rank's rows equal the JAX package's ``split(2)``
  rows of the same dataset, and its losses equal a single-controller
  loop over the two ranks' batches joined, to ``1e-5 + 1e-5 |ref|``.
- ``BatchPredictor`` on the tiny GPT (fp32), through tasks and through
  an ``ActorPoolStrategy`` pool asking ``{"GPU": 0.5}`` a actor: the
  scores equal the same forward in this process bitwise, and the JAX
  package's ``BatchPredictor`` running ``ray_tpu.models.gpt`` on the same
  weights (``_bridge.params_from_jax``) to ``1e-5 + 1e-5 |ref|``.
"""

import os

import numpy as np
import pytest
import torch

import jax

import ray_tpu
import ray_tpu_torch
from ray_tpu import air as jair
from ray_tpu import data as J
from ray_tpu.models import gpt as jgpt
from ray_tpu_torch import _bridge
from ray_tpu_torch import air as tair
from ray_tpu_torch import data as T
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.parallel.mesh import Sharding, Split

B, S, STEPS, WORLD = 4, 32, 3, 2       # per rank: 3 steps of 4 rows


@pytest.fixture(scope="module")
def clusters():
    ray_tpu.init(num_cpus=4)
    ray_tpu_torch.init(num_cpus=4, resources={"GPU": 1})
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def token_matrix(rows, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(
        0, vocab, (rows, S + 1)).astype(np.int32)


def token_dataset(d, rows, parallelism, seed=0, shuffle=0):
    def cut(b):
        """A row of S + 1 tokens → tokens and next-token targets (the
        reference's from_numpy column is an object array of rows). A
        nested function: the workers take it by value."""
        x = np.stack(b["data"]) if b["data"].dtype == object else b["data"]
        return {"tokens": x[:, :-1], "targets": x[:, 1:]}

    ds = d.from_numpy(token_matrix(rows, seed), parallelism=parallelism
                      ).map_batches(cut)
    return ds if shuffle is None else ds.random_shuffle(seed=shuffle)


# --------------------------------------------------- iter_cuda_batches


@pytest.mark.parametrize("dtype", [None, torch.int64, torch.float32,
                                   np.int16, torch.bfloat16])
@pytest.mark.parametrize("drop_last", [True, False])
def test_iter_cuda_batches_on_the_cpu_equal_iter_batches(
        clusters, dtype, drop_last):
    ds = token_dataset(T, 22, 3)
    ref = list(ds.iter_batches(batch_size=8, drop_last=drop_last))
    it = ds.iter_cuda_batches(batch_size=8, dtype=dtype, device="cpu",
                              drop_last=drop_last, prefetch=1)
    got = list(it)
    assert len(got) == len(ref) == (2 if drop_last else 3)
    want_dtype = (dtype if isinstance(dtype, torch.dtype) or dtype is None
                  else torch.int16)
    for g, r in zip(got, ref):
        assert list(g) == ["tokens", "targets"]
        for k, t in g.items():
            assert t.device.type == "cpu"
            assert t.dtype == (want_dtype or torch.int32)
            want = torch.from_numpy(np.array(r[k]))
            assert torch.equal(t, want if dtype is None else want.to(t.dtype))
    stats = it.stats()
    assert stats["batches"] == len(ref) and stats["copies"] == 0
    assert stats["wait_s"] > 0


def test_iter_cuda_batches_simple_blocks_and_pipelines(clusters):
    got = [t.tolist() for t in T.from_items(list(range(10))).iter_cuda_batches(
        batch_size=4, device="cpu", drop_last=False)]
    assert got == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]
    pipe = T.range(20, parallelism=4).window(blocks_per_window=2)
    ref = [b["id"].tolist() for b in pipe.iter_batches(batch_size=4,
                                                       drop_last=True)]
    it = pipe.iter_cuda_batches(batch_size=4, device="cpu",
                                dtype=torch.float64)
    got = [b["id"] for b in it]
    assert [t.tolist() for t in got] == [[float(v) for v in r] for r in ref]
    assert all(t.dtype == torch.float64 for t in got)
    assert it.stats()["batches"] == len(ref) == 4


def test_iter_cuda_batches_takes_the_ports_batch_sharding(clusters):
    ds = token_dataset(T, 24, 4)
    ref = list(ds.iter_batches(batch_size=8))
    for index in range(2):
        sh = Sharding(spec=(("dp", "fsdp"),),
                      splits=(Split(0, ("dp",), index, 2),),
                      device=torch.device("cpu"), writer=True)
        got = list(ds.iter_cuda_batches(batch_size=8, sharding=sh))
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(
                g["tokens"].numpy(), r["tokens"][index * 4:(index + 1) * 4])
    whole = Sharding(spec=((),), splits=(), device=torch.device("cpu"),
                     writer=True)
    assert [b["tokens"].shape[0] for b in ds.iter_cuda_batches(
        batch_size=8, sharding=whole)] == [8, 8, 8]


def test_iter_cuda_batches_refusals(clusters, monkeypatch):
    ds = T.range(8)
    with pytest.raises(TypeError, match="batch sharding"):
        next(ds.iter_cuda_batches(batch_size=4, sharding="dp"))
    cols = Sharding(spec=(None, "tp"), splits=(Split(1, ("tp",), 0, 2),),
                    device=torch.device("cpu"), writer=True)
    with pytest.raises(ValueError, match="dimension 0"):
        ds.iter_cuda_batches(batch_size=4, sharding=cols)
    with pytest.raises(TypeError, match="non-numeric"):
        list(T.from_items([{"s": "a"}, {"s": "b"}]).iter_cuda_batches(
            batch_size=2, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        ds.iter_cuda_batches(batch_size=4)
    with pytest.raises(RuntimeError, match="no GPU"):
        ds.window().iter_cuda_batches(batch_size=4)


# ------------------------------------------------ TorchTrainer(datasets=)


def _rank_loop(config):
    import torch

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.optim import adamw
    from ray_tpu_torch.train.spmd import build_training

    mesh = make_mesh(MeshConfig(dp=session.get_world_size(), fsdp=1))
    cfg = gpt.GPTConfig.tiny(dtype=torch.float32, max_seq=config["S"])
    gen = torch.Generator(device=mesh.device).manual_seed(0)
    params, opt_state, step = build_training(cfg, adamw(1e-3), gen,
                                             process_mesh=mesh)
    shard = session.get_dataset_shard("train")
    for b in shard.iter_cuda_batches(batch_size=config["B"],
                                     dtype=torch.int64,
                                     device=session.get_device()):
        params, opt_state, loss = step(params, opt_state,
                                       (b["tokens"], b["targets"]))
        session.report({"rank": mesh.rank, "loss": float(loss),
                        "tokens": b["tokens"].tolist(),
                        "targets": b["targets"].tolist(),
                        "device": str(b["tokens"].device)})


def test_torch_trainer_reads_its_dataset_shards(clusters):
    from ray_tpu_torch.train import (ScalingConfig, TorchBackendConfig,
                                     TorchTrainer)
    from ray_tpu_torch.train.optim import adamw
    from ray_tpu_torch.train.spmd import build_training

    rows = WORLD * STEPS * B
    result = TorchTrainer(
        _rank_loop, train_loop_config={"B": B, "S": S},
        scaling_config=ScalingConfig(num_workers=WORLD),
        backend_config=TorchBackendConfig(device="cpu"),
        datasets={"train": token_dataset(T, rows, 4)}).fit(timeout=300)
    runs = {r: [m for m in result.metrics_history if m["rank"] == r]
            for r in range(WORLD)}
    # Each rank's rows are the JAX package's split(2) rows, in order.
    parts = token_dataset(J, rows, 4).split(WORLD)
    for r, part in enumerate(parts):
        ref = part.take_all()
        got = [{"tokens": t, "targets": g} for m in runs[r]
               for t, g in zip(m["tokens"], m["targets"])]
        assert len(got) == len(ref) == STEPS * B
        assert got == [{k: list(map(int, v[k])) for k in ("tokens",
                                                          "targets")}
                       for v in ref]
        assert {m["device"] for m in runs[r]} == {"cpu"}
    # The losses: one controller over the two ranks' batches joined.
    cfg = tgpt.GPTConfig.tiny(dtype=torch.float32, max_seq=S)
    params, opt_state, step = build_training(
        cfg, adamw(1e-3), torch.Generator().manual_seed(0), "cpu")
    for i in range(STEPS):
        batch = tuple(torch.tensor(sum((runs[r][i][k] for r in range(WORLD)),
                                       []))
                      for k in ("tokens", "targets"))
        params, opt_state, loss = step(params, opt_state, batch)
        for r in range(WORLD):
            got = runs[r][i]["loss"]
            assert abs(got - float(loss)) <= 1e-5 + 1e-5 * abs(float(loss)), (
                i, r, got, float(loss))


# ------------------------------------------------------- BatchPredictor


def _tiny_cfgs():
    return (tgpt.GPTConfig.tiny(dtype=torch.float32, max_seq=S),
            jgpt.GPTConfig.tiny(dtype=jax.numpy.float32, max_seq=S))


def port_predictor_cls():
    """The port's predictor: each row's mean next-token log-likelihood
    under the tiny GPT, one forward per batch, on the CPU."""

    class PortScorer(tair.Predictor):
        def __init__(self, params, cfg):
            self.params, self.cfg = params, cfg
            self.pid = os.getpid()

        @classmethod
        def from_checkpoint(cls, checkpoint, **kwargs):
            cfg = tgpt.GPTConfig.tiny(dtype=torch.float32, max_seq=S)
            return cls(checkpoint.to_params(), cfg)

        def predict_batch(self, batch):
            # One thread: a CPU matmul's sums follow the thread count, and
            # this process and the workers must sum alike.
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                with torch.inference_mode():
                    tokens = torch.from_numpy(np.array(batch["tokens"]))
                    targets = torch.from_numpy(np.array(batch["targets"]))
                    logits = tgpt.forward(self.params, tokens, self.cfg)
                    logp = logits.log_softmax(-1).gather(
                        -1, targets.long()[..., None])[..., 0]
                    score = logp.mean(-1).numpy()
            finally:
                torch.set_num_threads(threads)
            return {"score": score,
                    "pid": np.full(len(score), self.pid)}

    return PortScorer


def jax_predictor_cls():
    class JaxScorer(jair.Predictor):
        def __init__(self, params, cfg):
            self.params, self.cfg = params, cfg

        @classmethod
        def from_checkpoint(cls, checkpoint, **kwargs):
            import jax.numpy as jnp

            cfg = jgpt.GPTConfig.tiny(dtype=jnp.float32, max_seq=S)
            params = {k: jnp.asarray(v)
                      for k, v in checkpoint.to_dict()["params"].items()}
            return cls(params, cfg)

        def predict_batch(self, batch):
            import jax
            import jax.numpy as jnp

            def rows(v):
                return np.stack(v) if v.dtype == object else v

            tokens = jnp.asarray(rows(batch["tokens"]))
            targets = jnp.asarray(rows(batch["targets"]))
            logits = jgpt.forward(self.params, tokens, self.cfg)
            logp = jnp.take_along_axis(jax.nn.log_softmax(logits, -1),
                                       targets[..., None], -1)[..., 0]
            return {"score": np.asarray(logp.mean(-1))}

    return JaxScorer


def in_process_scores(predictor, ds, batch_size):
    """The predictor's scores over ``ds``'s blocks, cut into batches of
    ``batch_size`` per block as map_batches cuts them."""
    out = []
    for ref in ds._materialized_refs():
        blk = ray_tpu_torch.get(ref, timeout=60)
        n = T.block.num_rows(blk)
        for s in range(0, n, batch_size):
            batch = T.block.to_batch(T.block.slice_block(
                blk, s, min(s + batch_size, n)))
            out.append(predictor.predict_batch(batch)["score"])
    return np.concatenate(out)


@pytest.mark.parametrize("route", ["tasks", "actor_pool"])
def test_batch_predictor_scores(clusters, route):
    tcfg, jcfg = _tiny_cfgs()
    np_params = {k: np.asarray(v) for k, v in jgpt.init_params(
        jcfg, jax.random.PRNGKey(0)).items()}
    params = _bridge.params_from_jax(np_params, tcfg, "cpu")
    ds = token_dataset(T, 32, 2, shuffle=None)      # blocks of 16 rows
    P = port_predictor_cls()
    bp = tair.BatchPredictor.from_checkpoint(
        tair.Checkpoint.from_params(params), P)
    compute = (None if route == "tasks" else T.ActorPoolStrategy(
        1, 2, resources={"GPU": 0.5}))
    rows = bp.predict(ds, batch_size=8, compute=compute).take_all()
    got = np.array([r["score"] for r in rows], dtype=np.float32)
    # Bitwise the same forward in this process, on the same batches.
    ref = in_process_scores(P.from_checkpoint(
        tair.Checkpoint.from_params(params)), ds, 8)
    assert got.tobytes() == ref.tobytes()
    assert len({r["pid"] for r in rows} - {os.getpid()}) >= 1
    # The JAX package's BatchPredictor on the same weights.
    jbp = jair.BatchPredictor.from_checkpoint(
        jair.Checkpoint.from_dict({"params": np_params}),
        jax_predictor_cls())
    jrows = jbp.predict(token_dataset(J, 32, 2, shuffle=None),
                        batch_size=8).take_all()
    jscore = np.array([r["score"] for r in jrows], dtype=np.float32)
    np.testing.assert_allclose(got, jscore, rtol=1e-5, atol=1e-5)


def test_actor_with_a_large_constructor_argument(clusters):
    """An actor whose constructor argument is above the inline limit
    (its bytes go through the object store, as a pool actor's packed
    transform with a checkpoint does) is created: the runtime builds the
    arguments before its event loop takes the call, where put() would
    wait on that same loop."""
    from ray_tpu_torch.core.config import runtime_config

    limit = runtime_config().max_inline_object_size

    class Holder:
        def __init__(self, blob):
            self.n = len(blob)

        def size(self):
            return self.n

    import threading

    blob = np.ones(limit + 1, dtype=np.uint8).tobytes()
    made = []
    t = threading.Thread(target=lambda: made.append(
        ray_tpu_torch.remote(Holder).remote(blob)), daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "actor creation waits on its own event loop"
    assert ray_tpu_torch.get(made[0].size.remote(), timeout=60) == limit + 1
    ray_tpu_torch.kill(made[0])
