"""PyTorch port vs the JAX package: training across processes.

`TorchTrainer` with ``TorchBackendConfig(device="cpu")`` on gloo ranks,
worker actors of one module-scoped port cluster, mirroring
``tests/test_train.py`` (linreg at dp = 2, one worker without a process
group, a failing loop, streamed reports) and training tiny GPT at
dp = 2, fsdp = 2 and dp 2 x fsdp 2. The GPT runs start from the JAX
package's parameters (``_bridge.params_from_jax``, each rank keeping its
pieces with ``shard_tree``) and the same global batch, and are held to
``spmd.build_training`` of the JAX package on the same mesh shape over
the forced host devices of ``tests/conftest.py``, computed in this
process with ``optax.adamw``: the per-step losses, and each rank's
parameters (under fsdp its shards) against the JAX array's shard on the
device at the rank's mesh position.

Tolerance, as ``tests/test_torch_train.py::test_build_training_matches_jax``
(fp32, three AdamW steps): the losses within 1e-5 relative; of each
leaf, all but 0.1% of the elements within 2e-5 and every element within
the steps taken (3 x 2 lr). Adam divides each gradient element by the
root of its own second moment, so an element whose gradient is within
fp32 noise of zero (the two sides sum in different orders, here also
across ranks) turns that noise into an update anywhere in about +-lr.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import ray_tpu_torch as rt
from ray_tpu.models import gpt as jgpt
from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig
from ray_tpu.parallel.mesh import make_mesh as jmake_mesh
from ray_tpu.train import spmd as jspmd
from ray_tpu_torch.parallel.mesh import MESH_AXES
from ray_tpu_torch.train import (
    Checkpoint,
    ScalingConfig,
    TorchBackendConfig,
    TorchTrainer,
    TrainingFailedError,
)

CPU_BACKEND = TorchBackendConfig(device="cpu")
LR, STEPS, B, S = 1e-2, 3, 8, 32


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def _linreg_loop(config):
    import numpy as np
    import torch

    from ray_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from ray_tpu_torch.train import session, spmd
    from ray_tpu_torch.train.checkpoint import Checkpoint
    from ray_tpu_torch.train.optim import GradientTransformation

    world = session.get_world_size()
    mesh = make_mesh(MeshConfig(dp=world, fsdp=1))
    rng = np.random.default_rng(0)
    W_true = rng.standard_normal((10, 3)).astype(np.float32)
    params = {"w": torch.zeros(10, 3, requires_grad=True),
              "b": torch.zeros(3, requires_grad=True)}
    sgd = GradientTransformation(
        lambda p: None, lambda g, s, p: ({k: -0.5 * v for k, v in g.items()},
                                         s))
    step = spmd.make_train_step(
        lambda p, x, y: ((x @ p["w"] + p["b"] - y) ** 2).mean(), sgd,
        process_mesh=mesh, shardings={})
    state = None
    n_local = config.get("n_local", 64)
    for it in range(config.get("iters", 25)):
        xs = rng.standard_normal((n_local, 10)).astype(np.float32)
        ys = xs @ W_true
        params, state, loss = step(params, state, (torch.from_numpy(xs),
                                                   torch.from_numpy(ys)))
        session.report({"iter": it, "loss": float(loss)})
    session.report(
        {"iter": -1, "loss": float(loss)},
        checkpoint=Checkpoint.from_params(params),
    )


def test_ddp_two_workers_converges(cluster):
    trainer = TorchTrainer(
        _linreg_loop,
        train_loop_config={"iters": 25},
        scaling_config=ScalingConfig(num_workers=2),
        backend_config=CPU_BACKEND,
    )
    result = trainer.fit(timeout=240)
    assert result.metrics["loss"] < 1e-4
    # both ranks reported, the same global mean each step
    ranks = {r["_world_rank"] for r in result.metrics_history}
    assert ranks == {0, 1}
    by_rank = [[r["loss"] for r in result.metrics_history
                if r["_world_rank"] == k] for k in (0, 1)]
    assert by_rank[0] == by_rank[1]
    # checkpoint carries the trained params
    w = result.checkpoint.to_params()["w"]
    assert w.shape == (10, 3)
    assert w.abs().sum() > 0


def test_single_worker_local(cluster):
    trainer = TorchTrainer(
        _linreg_loop,
        train_loop_config={"iters": 10},
        scaling_config=ScalingConfig(num_workers=1),
        backend_config=TorchBackendConfig(device="cpu",
                                          init_distributed=False),
    )
    result = trainer.fit(timeout=180)
    assert result.metrics["loss"] < 1.0


def test_train_error_propagates(cluster):
    def bad_loop(config):
        raise RuntimeError("train exploded")

    trainer = TorchTrainer(
        bad_loop,
        scaling_config=ScalingConfig(num_workers=1),
        backend_config=TorchBackendConfig(device="cpu",
                                          init_distributed=False),
    )
    with pytest.raises(TrainingFailedError, match="train exploded"):
        trainer.fit(timeout=120)


def test_report_callback_streaming(cluster):
    seen = []

    def slow_loop(config):
        import time

        from ray_tpu_torch.train import session

        for i in range(5):
            session.report({"i": i})
            time.sleep(0.1)

    trainer = TorchTrainer(
        slow_loop,
        scaling_config=ScalingConfig(num_workers=1),
        backend_config=TorchBackendConfig(device="cpu",
                                          init_distributed=False),
    )
    trainer.add_report_callback(lambda reports: seen.append(len(reports)))
    result = trainer.fit(timeout=120)
    assert sum(seen) == 5
    assert len(seen) > 1, "reports should stream in over multiple polls"
    assert isinstance(result.checkpoint, (Checkpoint, type(None)))


def test_default_backend_raises_without_a_gpu(cluster):
    """TorchTrainer's default backend config is cuda with NCCL: without a
    GPU the rank's setup raises, and fit raises with it (no CPU
    fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default backend runs")
    trainer = TorchTrainer(lambda: None,
                           scaling_config=ScalingConfig(num_workers=1))
    with pytest.raises(Exception, match="no GPU is available"):
        trainer.fit(timeout=120)


# ------------------------------------------------------------ tiny GPT


def _gpt_loop(config):
    """Each mesh of ``config["meshes"]`` in turn on the same ranks: the
    JAX parameters' pieces, STEPS steps on the rank's rows of the global
    batch; reports the losses, the rank's coordinates and its pieces."""
    import torch

    from ray_tpu_torch._bridge import params_from_jax
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import attention as fa
    from ray_tpu_torch.parallel.mesh import (MeshConfig, batch_sharding,
                                             make_mesh)
    from ray_tpu_torch.parallel.sharding import shard_tree
    from ray_tpu_torch.train import session, spmd
    from ray_tpu_torch.train.optim import adamw

    cfg = gpt.GPTConfig.tiny(dtype=torch.float32, attn_impl="xla")
    whole = params_from_jax(config["params"], cfg, device="cpu")
    runs = {}
    for name, shape in config["meshes"].items():
        mesh = make_mesh(MeshConfig(**shape))
        params, opt_state, step = spmd.build_training(
            cfg, adamw(config["lr"], weight_decay=0.1), process_mesh=mesh)
        shardings = spmd.param_shardings(gpt.logical_axes(cfg), mesh)
        with torch.no_grad():
            for k, v in shard_tree(whole, shardings).items():
                params[k].copy_(v)
        rows = batch_sharding(mesh)
        batch = tuple(rows.shard(torch.from_numpy(a))
                      for a in config["batch"])
        fa.reset_launch_counts()
        losses = []
        for _ in range(config["steps"]):
            params, opt_state, loss = step(params, opt_state, batch)
            losses.append(float(loss))
        runs[name] = {
            "losses": losses, "coords": mesh.coords,
            "params": {k: v.detach().numpy() for k, v in params.items()},
            "moments": {k: tuple(v.shape) for k, v in opt_state.mu.items()},
            "launches": fa.flash_fwd.launches, "collectives": mesh.stats.calls}
    session.report({"runs": runs})


def _jax_reference(dp, fsdp, batch):
    """JAX build_training on the (dp, fsdp) mesh of forced host devices:
    the initial parameters (numpy), the per-step losses, the final
    parameters."""
    jcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32, attn_impl="xla")
    mesh = jmake_mesh(JMeshConfig(dp=dp, fsdp=fsdp, sp=1, tp=1),
                      devices=jax.devices()[:dp * fsdp])
    jp, js, jstep = jspmd.build_training(
        jcfg, mesh, optax.adamw(LR, weight_decay=0.1), jax.random.key(7))
    init = {k: np.asarray(v) for k, v in jp.items()}
    jt, jtg = (jnp.asarray(a, jnp.int32) for a in batch)
    losses = []
    for _ in range(STEPS):
        jp, js, jl = jstep(jp, js, (jt, jtg))
        losses.append(float(jl))
    return init, losses, jp, mesh


def _batch(vocab, seed=6):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S))
    return toks, np.roll(toks, -1, axis=1)


def _run_gpt(meshes, n_ranks):
    batch = _batch(jgpt.GPTConfig.tiny().vocab_size)
    refs = {name: _jax_reference(m["dp"], m["fsdp"], batch)
            for name, m in meshes.items()}
    init = next(iter(refs.values()))[0]
    result = TorchTrainer(
        _gpt_loop,
        train_loop_config={"meshes": meshes, "params": init, "lr": LR,
                           "steps": STEPS, "batch": batch},
        scaling_config=ScalingConfig(num_workers=n_ranks),
        backend_config=CPU_BACKEND,
    ).fit(timeout=300)
    ranks = {r["_world_rank"]: r["runs"] for r in result.metrics_history}
    assert sorted(ranks) == list(range(n_ranks))
    return ranks, refs


def _check_against_jax(ranks, ref, name):
    _init, jlosses, jp, jmesh = ref
    for rank, runs in ranks.items():
        run = runs[name]
        np.testing.assert_allclose(run["losses"], jlosses, rtol=1e-5)
        assert run["launches"] == 0      # CPU tensors: the plain versions
        dev = jmesh.devices[tuple(run["coords"][a] for a in MESH_AXES)]
        assert dev.id == rank
        for k, v in jp.items():
            index = v.sharding.devices_indices_map(v.shape)[dev]
            want = np.asarray(v, np.float32)[index]
            got = run["params"][k]
            assert got.shape == want.shape, (rank, k)
            assert run["moments"][k] == want.shape, (rank, k)
            diff = np.abs(got - want)
            assert float(np.mean(diff > 2e-5)) <= 1e-3, (rank, k)
            assert float(diff.max()) <= STEPS * 2 * LR, (rank, k)


@pytest.fixture(scope="module")
def two_rank_runs(cluster):
    """dp = 2 and fsdp = 2, one after the other on the same two ranks."""
    return _run_gpt({"dp": {"dp": 2, "fsdp": 1},
                     "fsdp": {"dp": 1, "fsdp": 2}}, 2)


@pytest.mark.parametrize("name", ["dp", "fsdp"])
def test_gpt_matches_jax_on_two_ranks(two_rank_runs, name):
    ranks, refs = two_rank_runs
    _check_against_jax(ranks, refs[name], name)
    shapes = {r: runs[name]["params"]["w_up"].shape
              for r, runs in ranks.items()}
    if name == "fsdp":     # each rank holds half of embed, the dp ranks all
        assert shapes == {0: (2, 32, 128), 1: (2, 32, 128)}
        assert all(runs[name]["collectives"] > 0 for runs in ranks.values())
    else:
        assert shapes == {0: (2, 64, 128), 1: (2, 64, 128)}
        for k in ranks[0]["dp"]["params"]:    # replicas stay identical
            np.testing.assert_array_equal(ranks[0]["dp"]["params"][k],
                                          ranks[1]["dp"]["params"][k])


def test_gpt_dp2_fsdp2_on_four_ranks_matches_jax(cluster):
    ranks, refs = _run_gpt({"dp2xfsdp2": {"dp": 2, "fsdp": 2}}, 4)
    _check_against_jax(ranks, refs["dp2xfsdp2"], "dp2xfsdp2")
    assert {r: runs["dp2xfsdp2"]["coords"]["fsdp"]
            for r, runs in ranks.items()} == {0: 0, 1: 1, 2: 0, 3: 1}
