"""PyTorch port vs the JAX package: GPipe pipeline parallelism.

Mirrors the pipeline half of tests/test_pipeline_moe.py. The JAX
pipeline runs on a pp = 2 mesh of the forced host devices; the port's on
a pp mesh of repeated ``cpu`` devices, on the same JAX ``init_params``
weights (``params_from_jax``) and the same seeded numpy tokens. On CPU
tensors the flash path takes the kernels' plain versions, and every test
asserts that no kernel launched.

Tolerances (fp32, GPT tiny with 4 layers): the pipeline's logits within
1e-5 of the port's sequential forward and of JAX's pipeline (the JAX
test's own bound against sequential is 2e-2); gradients within 1e-5
absolute plus 1e-4 relative (reassociated fp32 sums; the JAX test's own
bound is 5e-2); the training steps by tests/test_torch_train.py's rule
(Adam turns a gradient element within fp32 noise of zero into an update
anywhere in about ±lr): losses within 1e-5 relative, all but 0.1% of
each leaf's elements within 2e-5, every element within 2 lr per step.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import gpt as jgpt
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel.mesh import MeshConfig, make_mesh
from ray_tpu.parallel.pipeline import split_microbatch_count as jsplit
from ray_tpu.train import spmd as jspmd
from ray_tpu_torch._bridge import params_from_jax
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import partition as tpart
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import pipeline as tpipe
from ray_tpu_torch.train import optim as toptim
from ray_tpu_torch.train import spmd as tspmd

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def counters():
    tattn.reset_launch_counts()
    yield
    assert (tattn.flash_fwd.launches, tattn.flash_dq.launches,
            tattn.flash_dkv.launches) == (0, 0, 0)


@pytest.fixture(scope="module")
def pp_mesh(cpu_devices):
    return make_mesh(MeshConfig(dp=2, pp=2, fsdp=1, sp=1, tp=2))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _setup(seed):
    jcfg = jgpt.GPTConfig.tiny(n_layers=4, dtype=jnp.float32)
    tcfg = tgpt.GPTConfig.tiny(n_layers=4, dtype=torch.float32)
    jp = jax.jit(jgpt.init_params, static_argnums=0)(jcfg,
                                                      jax.random.key(seed))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tcfg,
                         device="cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (8, 32))
    tg = np.roll(toks, -1, axis=1)
    return (jcfg, tcfg, jp, tp, (jnp.asarray(toks, jnp.int32),
                                 jnp.asarray(tg, jnp.int32)),
            (torch.from_numpy(toks), torch.from_numpy(tg)))


def _placed(tp, tcfg, pp):
    return tpart.place_on_axis(tp, tgpt.logical_axes(tcfg), [CPU] * pp, "pp",
                               tmesh.PIPELINE_LOGICAL_RULES)


def _joined(tree, n):
    """Placed ``name@r`` layer leaves joined back along the layers axis."""
    out = {k: v for k, v in tree.items() if "@" not in k}
    for k in {k.partition("@")[0] for k in tree if "@" in k}:
        out[k] = torch.cat([tree[f"{k}@{r}"] for r in range(n)])
    return out


def test_mesh_rules_match_jax():
    assert tmesh.MESH_AXES == jmesh.MESH_AXES
    assert tmesh.DEFAULT_LOGICAL_RULES == jmesh.DEFAULT_LOGICAL_RULES
    assert tmesh.PIPELINE_LOGICAL_RULES == jmesh.PIPELINE_LOGICAL_RULES
    assert tmesh.device_mesh(2, axis="ep", devices=["cpu", "cpu"]) == [CPU] * 2
    with pytest.raises(ValueError, match="unknown mesh axis"):
        tmesh.device_mesh(1, axis="xp", devices=["cpu"])


def test_placement_matches_jax_shardings(cpu_devices):
    """The split dimension of every leaf under the pp rules (GPT) and the
    default rules over ep (MoE-GPT) is where JAX's tree_to_shardings
    puts the mesh axis; unsplit leaves stay whole."""
    from ray_tpu.models import moe_gpt as jmoe_gpt
    from ray_tpu.parallel.sharding import tree_to_shardings
    from ray_tpu_torch.models import moe_gpt as tmoe_gpt

    cases = [
        (jgpt.logical_axes(jgpt.GPTConfig.tiny(n_layers=4)),
         MeshConfig(dp=4, pp=2, fsdp=1, tp=1), "pp",
         tmesh.PIPELINE_LOGICAL_RULES, jmesh.PIPELINE_LOGICAL_RULES),
        (jmoe_gpt.logical_axes(jmoe_gpt.MoEGPTConfig.tiny()),
         MeshConfig(dp=4, ep=2, fsdp=1, tp=1), "ep",
         tmesh.DEFAULT_LOGICAL_RULES, jmesh.DEFAULT_LOGICAL_RULES),
    ]
    for logical, mcfg, axis, trules, jrules in cases:
        shard = tree_to_shardings(logical, make_mesh(mcfg), jrules)
        for name, axes in logical.items():
            spec = tuple(shard[name].spec)
            want = spec.index(axis) if axis in spec else None
            assert tpart._split_dim(axes, axis, 2, trules) == want, name
    cfg = tmoe_gpt.MoEGPTConfig.tiny()
    params = tmoe_gpt.init_params(cfg, device="cpu")
    placed = tpart.place_on_axis(params, tmoe_gpt.logical_axes(cfg),
                                 [CPU] * 2, "ep")
    assert placed["moe_b_up@1"].shape == (2, 2, 128)
    assert torch.equal(placed["moe_b_up@1"], params["moe_b_up"][:, 2:])
    assert placed["wg"] is params["wg"]
    one = tpart.place_on_axis(params, tmoe_gpt.logical_axes(cfg), [CPU], "ep")
    assert one.keys() == params.keys()
    with pytest.raises(ValueError, match="does not divide evenly"):
        tpart.place_on_axis(params, tmoe_gpt.logical_axes(cfg), [CPU] * 3,
                            "ep")
    with pytest.raises(ValueError, match="not placed on 4 shards"):
        tmesh.axis_shards(placed, "moe_b_up", [CPU] * 4)


@pytest.mark.parametrize("axis", ["ep", "pp"])
def test_axis_shards_whole_and_placed_agree(axis):
    """`axis_shards` splits a whole leaf along dim 0, the split axis of
    every leaf it reads (one layer's expert stack over ep, a layer stack
    over pp), into the shards `place_on_axis` places."""
    from ray_tpu_torch.models import moe_gpt as tmoe_gpt

    if axis == "ep":
        cfg = tmoe_gpt.MoEGPTConfig.tiny()
        params = tmoe_gpt.init_params(cfg, device="cpu")
        logical, rules, name = (tmoe_gpt.logical_axes(cfg),
                                tmesh.DEFAULT_LOGICAL_RULES, "moe_w_up")
        cases = [(lambda t, i=i: t[i]) for i in range(cfg.n_layers)]
    else:
        cfg = tgpt.GPTConfig.tiny(n_layers=4)
        params = tgpt.init_params(cfg, device="cpu")
        logical, rules, name = (tgpt.logical_axes(cfg),
                                tmesh.PIPELINE_LOGICAL_RULES, "wq")
        cases = [lambda t: t]
    mesh = [CPU] * 2
    placed = tpart.place_on_axis(params, logical, mesh, axis, rules)
    for take in cases:
        whole = {name: take(params[name])}
        shards = {f"{name}@{s}": take(placed[f"{name}@{s}"])
                  for s in range(2)}
        got = tmesh.axis_shards(whole, name, mesh)
        for a, b in zip(got, tmesh.axis_shards(shards, name, mesh)):
            assert torch.equal(a, b)
        assert sum(a.shape[0] for a in got) == whole[name].shape[0]
    with pytest.raises(ValueError, match="into 3 shards along dim 0"):
        tmesh.axis_shards(whole, name, [CPU] * 3)


@pytest.mark.parametrize("pp", [2, 4])
def test_pipeline_forward_matches_sequential(pp_mesh, pp):
    """The port's pipeline (whole and placed layer stacks) against its
    sequential forward, and at pp = 2 against JAX's forward_pipeline."""
    jcfg, tcfg, jp, tp, (jt, _), (tt, _) = _setup(0)
    ref = tgpt.forward(tp, tt, tcfg)
    for params in (tp, _placed(tp, tcfg, pp)):
        out = tgpt.forward_pipeline(params, tt, tcfg, [CPU] * pp, n_micro=4)
        np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5)
    if pp == 2:
        want = jax.jit(lambda p, t: jgpt.forward_pipeline(
            p, t, jcfg, pp_mesh, n_micro=4))(jp, jt)
        np.testing.assert_allclose(_np(out), _np(want), atol=1e-5)


def _grads(params, fn):
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = fn(leaves)
    names = list(leaves)
    return loss.detach(), dict(zip(names, torch.autograd.grad(
        loss, [leaves[k] for k in names])))


@pytest.mark.parametrize("pp", [2, 4])
def test_pipeline_grads_match_sequential(pp_mesh, pp):
    """Autograd through the schedule (placed stacks, remat on) against
    the sequential loss's gradients, and at pp = 2 against jax.grad of
    JAX's pipeline_loss_fn."""
    jcfg, tcfg, jp, tp, (jt, jtg), (tt, ttg) = _setup(1)
    l_ref, g_ref = _grads(tp, lambda p: tgpt.loss_fn(p, tt, ttg, tcfg))
    remat = tgpt.GPTConfig.tiny(n_layers=4, dtype=torch.float32, remat=True)
    l_pp, g_pp = _grads(_placed(tp, tcfg, pp), lambda p: tgpt.pipeline_loss_fn(
        p, tt, ttg, remat, [CPU] * pp, 4))
    g_pp = _joined(g_pp, pp)
    np.testing.assert_allclose(float(l_pp), float(l_ref), atol=1e-5)
    assert set(g_pp) == set(g_ref)
    for k in g_ref:
        np.testing.assert_allclose(_np(g_pp[k]), _np(g_ref[k]), atol=1e-5,
                                   rtol=1e-4, err_msg=k)
    if pp == 2:
        jl, jg = jax.jit(jax.value_and_grad(lambda p: jgpt.pipeline_loss_fn(
            p, jt, jtg, jcfg, pp_mesh, 4)))(jp)
        np.testing.assert_allclose(float(l_pp), float(jl), atol=1e-5)
        for k in jg:
            np.testing.assert_allclose(_np(g_pp[k]), _np(jg[k]), atol=1e-5,
                                       rtol=1e-4, err_msg=k)


def test_pipeline_training_step_matches_jax(pp_mesh):
    """The mirror of test_pipeline_training_step_runs: two steps of
    build_pipeline_training (pp = 2, the layer stacks on their stages)
    from the JAX weights against JAX's build_pipeline_training; it
    learns."""
    jcfg, tcfg, _, _, (jt, jtg), (tt, ttg) = _setup(0)
    jparams, jstate, jstep = jspmd.build_pipeline_training(
        jcfg, pp_mesh, optax.adamw(1e-3), jax.random.key(0))
    start = {k: np.asarray(v) for k, v in jparams.items()}
    tp, ts, tstep = tspmd.build_pipeline_training(
        tcfg, toptim.adamw(1e-3), device="cpu", mesh=[CPU] * 2)
    assert tp["wq@1"].shape == (2, 64, 8, 8) and "wq" not in tp
    with torch.no_grad():
        for k, v in _placed(params_from_jax(start, tcfg, device="cpu"),
                            tcfg, 2).items():
            tp[k].copy_(v)
    losses = []
    for _ in range(2):
        jparams, jstate, jl = jstep(jparams, jstate, (jt, jtg))
        tp, ts, tl = tstep(tp, ts, (tt, ttg))
        losses.append(float(tl))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        whole = _joined(tp, 2)
        for k in jparams:
            diff = np.abs(_np(whole[k]) - _np(jparams[k]))
            assert float(np.mean(diff > 2e-5)) <= 1e-3, k
            assert float(diff.max()) <= 2 * 2 * 1e-3, k
    assert np.isfinite(losses).all() and losses[1] < losses[0]


def test_split_microbatch_count_matches_jax():
    for batch in (1, 2, 3, 6, 8, 12, 16, 17, 64):
        for pp in (1, 2, 3, 4, 8):
            for target in (None, 1, 3, 4, 32):
                assert tpipe.split_microbatch_count(batch, pp, target) == \
                    jsplit(batch, pp, target), (batch, pp, target)


def test_layers_not_divisible_by_pp_raises(cpu_devices):
    jcfg = jgpt.GPTConfig.tiny(n_layers=4, dtype=jnp.float32)
    mesh = make_mesh(MeshConfig(dp=1, pp=3, fsdp=1, sp=1, tp=1),
                     devices=cpu_devices[:3])
    with pytest.raises(ValueError) as want:
        jspmd.build_pipeline_training(jcfg, mesh, optax.adamw(1e-3),
                                      jax.random.key(0))
    with pytest.raises(ValueError) as got:
        tspmd.build_pipeline_training(
            tgpt.GPTConfig.tiny(n_layers=4), toptim.adamw(1e-3),
            device="cpu", mesh=[CPU] * 3)
    assert str(got.value) == str(want.value) == \
        "n_layers=4 not divisible by pp=3"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            tspmd.build_pipeline_training(
                tgpt.GPTConfig.tiny(n_layers=4), toptim.adamw(1e-3),
                mesh=[CPU] * 2)


def test_schedule_runs_only_the_real_stage_applications():
    """pp stages, n_micro microbatches: stage r sees microbatches
    0 .. n_micro - 1 in order, n_micro x pp applications in all (the
    bubble runs nothing); pp = 1 is stage_fn itself; a batch that does
    not split into n_micro raises."""
    pp, n_micro = 3, 4
    calls = []

    def stage(stack, act):
        calls.append((stack["r"], int(act[0, 0])))
        return act + 10 ** stack["r"]

    x = torch.arange(8.0).reshape(8, 1) * 1000
    stacks = [{"r": r} for r in range(pp)]
    out = tpipe.pipeline_apply(stage, stacks, x, mesh=[CPU] * pp,
                               n_micro=n_micro)
    assert torch.equal(out, x + 111)
    assert len(calls) == n_micro * pp
    for r in range(pp):
        firsts = [a for s, a in calls if s == r]
        assert firsts == [2000 * m + sum(10 ** i for i in range(r))
                          for m in range(n_micro)]
    assert torch.equal(tpipe.pipeline_apply(stage, stacks[:1], x,
                                            mesh=[CPU], n_micro=3), x + 1)
    with pytest.raises(ValueError, match="not divisible by n_micro=3"):
        tpipe.pipeline_apply(stage, stacks, x, mesh=[CPU] * pp, n_micro=3)
