"""PyTorch port vs the JAX package: megatron tp and the 3D hybrid across
processes, fsdp inside the step and Adafactor under fsdp.

One module-scoped `TorchTrainer` fit of eight gloo CPU ranks (worker
actors of a port cluster) runs three meshes in turn on the same ranks,
as ``tests/test_torch_train_dist.py`` does for dp and fsdp: tp = 8, the
hybrid dp 2 x fsdp 2 x tp 2 (``w_up`` split on embed over fsdp and on
mlp over tp), and Adafactor at fsdp 2 (under dp 4, the fit's eight
ranks). Each starts from the JAX package's parameters
(``_bridge.params_from_jax``, each rank keeping its pieces with
``shard_tree``) and the same global batch, and is held to
``spmd.build_training`` of the JAX package on the same mesh of the forced
host devices of ``tests/conftest.py`` with the same optimizer
(``optax.adamw``; ``optax.adafactor``, factoring dims of 32 and more so
that the embed dimension fsdp splits is factored): the per-step losses,
and each rank's final pieces against the JAX array's shard on the
device at the rank's mesh position. The port trains with
``attn_impl="flash"``, whose wrappers take their plain versions on CPU
tensors (the launch counters stay 0); the JAX side with "xla".

Tolerance. AdamW, as ``test_torch_train_dist.py``: the losses within
1e-5 relative; of each leaf all but 0.1% of the elements within 2e-5
and every element within the steps taken (3 x 2 lr): Adam turns fp32
noise in a near-zero gradient element into an update anywhere in about
+-lr. Adafactor normalizes by factored means and block RMS instead, so
no element's noise is amplified that way: every element within 1e-6
(the sums run in other orders, here across ranks; the port against
itself on one controller reads 1.2e-7).

The hybrid's pieces round-trip through ``save_sharded``/``load_sharded``
bitwise on the eight ranks, and load whole at world 1 here, where every
rank's pieces are the whole leaf's at the rank's JAX shard. Under fsdp
the per-layer gather holds at most one layer's leaves whole at a time
(``mesh.stats.whole_peak``: the 11 fsdp-split leaves of a block).
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
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.parallel.mesh import MESH_AXES, make_mesh
from ray_tpu_torch.parallel.mesh import MeshConfig as TMeshConfig
from ray_tpu_torch.parallel.sharding import tree_to_shardings
from ray_tpu_torch.train import ScalingConfig, TorchBackendConfig, TorchTrainer
from ray_tpu_torch.train.checkpoint import load_sharded

LR, STEPS, B, S, RANKS = 1e-2, 3, 8, 32, 8
FACTOR_MIN = 32
MESHES = {
    "tp8": {"shape": {"dp": 1, "fsdp": 1, "tp": 8}, "opt": "adamw"},
    "dp2xfsdp2xtp2": {"shape": {"dp": 2, "fsdp": 2, "tp": 2}, "opt": "adamw"},
    "fsdp2_adafactor": {"shape": {"dp": 4, "fsdp": 2, "tp": 1},
                        "opt": "adafactor"},
}
HYBRID = "dp2xfsdp2xtp2"
# The leaves of one block that fsdp splits (every block leaf but b_up).
LAYER_FSDP_LEAVES = 11


def _tp_loop(config):
    """Each mesh of ``config["meshes"]`` in turn on the same ranks: the
    JAX parameters' pieces, STEPS steps on the rank's rows of the global
    batch; reports the losses, the rank's coordinates, its pieces and
    the hybrid's checkpoint round trip."""
    import os

    import torch

    from ray_tpu_torch._bridge import params_from_jax
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import attention as fa
    from ray_tpu_torch.parallel.mesh import (CollectiveStats, MeshConfig,
                                             batch_sharding, make_mesh)
    from ray_tpu_torch.parallel.sharding import shard_tree
    from ray_tpu_torch.train import session, spmd
    from ray_tpu_torch.train.checkpoint import load_sharded, save_sharded
    from ray_tpu_torch.train.optim import adafactor, adamw

    cfg = gpt.GPTConfig.tiny(dtype=torch.float32, attn_impl="flash")
    whole = params_from_jax(config["params"], cfg, device="cpu")
    runs = {}
    for name, run in config["meshes"].items():
        mesh = make_mesh(MeshConfig(**run["shape"]))
        opt = (adamw(config["lr"], weight_decay=0.1) if run["opt"] == "adamw"
               else adafactor(config["lr"],
                              min_dim_size_to_factor=config["factor_min"]))
        params, opt_state, step = spmd.build_training(cfg, opt,
                                                      process_mesh=mesh)
        shardings = spmd.param_shardings(gpt.logical_axes(cfg), mesh)
        with torch.no_grad():
            for k, v in shard_tree(whole, shardings).items():
                params[k].copy_(v)
        rows = batch_sharding(mesh)
        batch = tuple(rows.shard(torch.from_numpy(a))
                      for a in config["batch"])
        fa.reset_launch_counts()
        mesh.stats = CollectiveStats()
        losses = []
        for _ in range(config["steps"]):
            params, opt_state, loss = step(params, opt_state, batch)
            losses.append(float(loss))
        out = {
            "losses": losses, "coords": mesh.coords,
            "params": {k: v.detach().numpy() for k, v in params.items()},
            "launches": sum(f.launches for f in (
                fa.flash_fwd, fa.flash_delta, fa.flash_dq, fa.flash_dkv)),
            "collectives": mesh.stats.calls,
            "whole_peak": mesh.stats.whole_peak}
        if run["opt"] == "adamw":
            out["moments"] = {k: tuple(v.shape)
                              for k, v in opt_state.mu.items()}
        if name == config["save"]:
            path = os.path.join(config["path"], name)
            save_sharded(params, path, shardings)
            back = load_sharded(path, shardings)
            out["round_trip_bitwise"] = all(
                back[k].dtype == p.dtype and torch.equal(back[k], p.detach())
                for k, p in params.items())
        runs[name] = out
    session.report({"runs": runs})


def _jax_reference(shape, opt, batch):
    """JAX build_training on ``shape`` over the forced host devices: the
    initial parameters (numpy), the per-step losses, the final
    parameters and the mesh."""
    jcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32, attn_impl="xla")
    n = int(np.prod(list(shape.values())))
    mesh = jmake_mesh(JMeshConfig(sp=1, **shape), devices=jax.devices()[:n])
    jp, js, jstep = jspmd.build_training(jcfg, mesh, opt, jax.random.key(7))
    init = {k: np.asarray(v) for k, v in jp.items()}
    jt, jtg = (jnp.asarray(a, jnp.int32) for a in batch)
    losses = []
    for _ in range(STEPS):
        jp, js, jl = jstep(jp, js, (jt, jtg))
        losses.append(float(jl))
    return init, losses, jp, mesh


def _optax(name):
    if name == "adamw":
        return optax.adamw(LR, weight_decay=0.1)
    return optax.adafactor(LR, min_dim_size_to_factor=FACTOR_MIN)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    toks = np.random.default_rng(6).integers(
        0, jgpt.GPTConfig.tiny().vocab_size, (B, S))
    batch = toks, np.roll(toks, -1, axis=1)
    refs = {name: _jax_reference(m["shape"], _optax(m["opt"]), batch)
            for name, m in MESHES.items()}
    init = refs["tp8"][0]
    for ref in refs.values():       # one init, whatever the mesh
        for k, v in ref[0].items():
            np.testing.assert_array_equal(v, init[k])
    path = str(tmp_path_factory.mktemp("hybrid_ckpt"))
    rt.init(num_cpus=RANKS)
    try:
        result = TorchTrainer(
            _tp_loop,
            train_loop_config={"meshes": MESHES, "params": init, "lr": LR,
                               "steps": STEPS, "batch": batch,
                               "factor_min": FACTOR_MIN, "save": HYBRID,
                               "path": path},
            scaling_config=ScalingConfig(num_workers=RANKS),
            backend_config=TorchBackendConfig(device="cpu"),
        ).fit(timeout=300)
    finally:
        rt.shutdown()
    ranks = {r["_world_rank"]: r["runs"] for r in result.metrics_history}
    assert sorted(ranks) == list(range(RANKS))
    return ranks, refs, path


def _shard_index(jmesh, v, coords, rank):
    dev = jmesh.devices[tuple(coords[a] for a in MESH_AXES)]
    assert dev.id == rank
    return v.sharding.devices_indices_map(v.shape)[dev]


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_matches_jax_build_training(runs, name):
    ranks, refs, _ = runs
    _init, jlosses, jp, jmesh = refs[name]
    adam = MESHES[name]["opt"] == "adamw"
    for rank, rank_runs in ranks.items():
        run = rank_runs[name]
        np.testing.assert_allclose(run["losses"], jlosses, rtol=1e-5)
        assert run["launches"] == 0      # CPU tensors: the plain versions
        assert run["collectives"] > 0
        for k, v in jp.items():
            want = np.asarray(v, np.float32)[
                _shard_index(jmesh, v, run["coords"], rank)]
            got = run["params"][k]
            assert got.shape == want.shape, (rank, k)
            diff = np.abs(got - want)
            if adam:
                assert run["moments"][k] == want.shape, (rank, k)
                assert float(np.mean(diff > 2e-5)) <= 1e-3, (rank, k)
                assert float(diff.max()) <= STEPS * 2 * LR, (rank, k)
            else:
                assert float(diff.max()) <= 1e-6, (rank, k)


def test_hybrid_splits_w_up_in_two_and_gathers_one_layer_at_a_time(runs):
    """Under dp 2 x fsdp 2 x tp 2 each rank holds a quarter of ``w_up``
    (half of embed, half of mlp); fsdp runs hold at most one layer's
    leaves whole at once, tp = 8 gathers nothing."""
    ranks, _, _ = runs
    for rank, rank_runs in ranks.items():
        assert rank_runs[HYBRID]["params"]["w_up"].shape == (2, 32, 64)
        assert rank_runs["tp8"]["params"]["wq"].shape == (2, 64, 1, 8)
        assert rank_runs["tp8"]["params"]["wte"].shape == (32, 64)
        assert rank_runs["tp8"]["whole_peak"] == 0
        for name in (HYBRID, "fsdp2_adafactor"):
            assert rank_runs[name]["whole_peak"] == LAYER_FSDP_LEAVES, (
                rank, name)


def test_hybrid_checkpoint_round_trips_its_two_dimensional_pieces(runs):
    ranks, refs, path = runs
    assert all(r[HYBRID]["round_trip_bitwise"] for r in ranks.values())
    cfg = tgpt.GPTConfig.tiny(dtype=torch.float32)
    target = tree_to_shardings(tgpt.logical_axes(cfg),
                               make_mesh(TMeshConfig(dp=1, fsdp=1),
                                         device="cpu"))
    whole = load_sharded(f"{path}/{HYBRID}", target)
    _init, _losses, jp, jmesh = refs[HYBRID]
    for rank, rank_runs in ranks.items():
        run = rank_runs[HYBRID]
        for k, v in jp.items():
            index = _shard_index(jmesh, v, run["coords"], rank)
            np.testing.assert_array_equal(whole[k].numpy()[index],
                                          run["params"][k],
                                          err_msg=f"{rank} {k}")
