"""PyTorch port vs the JAX package: the MoE layer and the MoE-GPT family,
with expert parallelism.

Mirrors tests/test_moe_gpt.py and the MoE half of
tests/test_pipeline_moe.py. The same JAX ``init_params`` weights
(carried over by ``params_from_jax``), gates and inputs made from a
numpy seed go through ``ray_tpu.ops.moe`` / ``ray_tpu.models.moe_gpt``
and their counterparts in ``ray_tpu_torch``. The port's ep meshes
repeat the ``cpu`` device; the JAX ep runs on the forced host devices.
On CPU tensors the flash path takes the kernels' plain versions, and
every test asserts that no kernel launched.

Tolerances:
- `_top2_dispatch`: bitwise, on the same gates;
- fp32 `moe_mlp` outputs and aux within 1e-5 absolute, gradients within
  1e-5 absolute plus 1e-4 relative (reassociated fp32 sums);
- bf16 `moe_mlp`: the output's mean absolute error within 2e-3 of
  outputs of size ~0.1 (each side rounds the expert inputs, GELU and
  outputs to bf16 at its own places), the aux within 1e-5 (fp32 gates);
- ep = 2 and 4 against ep = 1: within 1e-6 absolute (fp32 reassociation
  of the partials' sum), gradients bitwise on the experts each shard
  holds;
- MoE-GPT fp32 logits within 2e-5, aux and loss within 1e-5, gradients
  within 1e-5 absolute plus 1e-4 relative; remat bitwise to non-remat;
- training steps by tests/test_torch_train.py's rule (Adam turns a
  gradient element within fp32 noise of zero into an update anywhere in
  about ±lr): the losses within 1e-5 relative, all but 0.1% of each
  leaf's elements within 2e-5, every element within 2 lr per step.
"""

import dataclasses
import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import moe_gpt as jmoe_gpt
from ray_tpu.ops import moe as jmoe
from ray_tpu.parallel.mesh import MeshConfig, make_mesh
from ray_tpu.parallel.sharding import shard_tree, tree_to_shardings
from ray_tpu_torch._bridge import params_from_jax
from ray_tpu_torch.models import moe_gpt as tmoe_gpt
from ray_tpu_torch.models import partition as tpart
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import moe as tmoe
from ray_tpu_torch.train import optim as toptim
from ray_tpu_torch.train import spmd as tspmd

CPU = torch.device("cpu")
EXPERT_KEYS = ("w_up", "b_up", "w_down", "b_down")


@pytest.fixture(autouse=True)
def counters():
    tattn.reset_launch_counts()
    yield
    assert (tattn.flash_fwd.launches, tattn.flash_dq.launches,
            tattn.flash_dkv.launches) == (0, 0, 0)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _to_port(jp, dtype=torch.float32):
    return {k: torch.from_numpy(np.array(v, np.float32)).to(dtype)
            for k, v in jp.items()}


def _layer_cfgs(dt="fp32", **kw):
    kw = {"d_model": 16, "d_ff": 32, "n_experts": 4, **kw}
    jd, td = {"fp32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    return jmoe.MoEConfig(dtype=jd, **kw), tmoe.MoEConfig(dtype=td, **kw)


def _joined(tree, logical, n):
    """Placed ``name@s`` leaves joined back along their split dim."""
    out = {}
    for name, axes in logical.items():
        if name in tree:
            out[name] = tree[name]
            continue
        dim = tpart._split_dim(axes, "ep", n, tpart.DEFAULT_LOGICAL_RULES)
        out[name] = torch.cat([tree[f"{name}@{s}"] for s in range(n)], dim)
    return out


# --------------------------------------------------------------- the layer


def test_config_specs_and_params_match_jax():
    for n in (1, 7, 64, 8192):
        for e, cf in ((4, 1.5), (8, 0.5), (8, 4.0), (3, 1.0)):
            assert tmoe.MoEConfig(8, 8, e, cf).capacity(n) == \
                jmoe.MoEConfig(8, 8, e, cf).capacity(n)
    jc, tc = _layer_cfgs()
    assert tmoe.moe_param_specs(tc) == jmoe.moe_param_specs(jc)
    assert tmoe.moe_logical_axes(tc) == jmoe.moe_logical_axes(jc)
    for name in jmoe_gpt.MoEGPTConfig._REGISTRY:
        j = jmoe_gpt.MoEGPTConfig.by_name(name)
        t = tmoe_gpt.MoEGPTConfig.by_name(name)
        for f in dataclasses.fields(j):
            if f.name not in ("dtype", "param_dtype"):
                assert getattr(t, f.name) == getattr(j, f.name), (name, f)
        assert tmoe_gpt.param_specs(t) == jmoe_gpt.param_specs(j)
        assert tmoe_gpt.logical_axes(t) == jmoe_gpt.logical_axes(j)
        total, active = tmoe_gpt.num_params(t)
        assert (total, active) == jmoe_gpt.num_params(j)
        # top-2 of E experts: the sparse count sits below the total.
        assert total > active > total - (total - active) * 2
    assert tmoe_gpt.param_specs(tmoe_gpt.MoEGPTConfig.tiny()).keys() == \
        tmoe_gpt.init_params(tmoe_gpt.MoEGPTConfig.tiny(), device="cpu").keys()
    with pytest.raises(KeyError, match="unknown model"):
        tmoe_gpt.MoEGPTConfig.by_name("moe_8x7b")


def _gates(G, E, seed, ties=True):
    """fp32 softmax gates [G, E]; with ``ties`` the first rows hold an
    exact tie for the first choice, one a near tie (1 fp32 ulp), and
    one an exact tie for the second choice."""
    rng = np.random.default_rng(seed)
    g = np.array(jax.nn.softmax(jnp.asarray(
        2 * rng.normal(size=(G, E)), jnp.float32), axis=-1))
    if ties:
        g[0] = 0.0
        g[0, 1] = g[0, 2] = 0.3
        g[0, 0] = 0.4 / (E - 2) if E > 2 else 0.0
        g[1, 2] = g[1].max() + np.float32(0.05)
        g[1, 3] = np.nextafter(g[1, 2], np.float32(1), dtype=np.float32)
        g[2] = np.float32(0.1)
        g[2, 0] = 0.7
    return np.ascontiguousarray(g, np.float32)


@pytest.mark.parametrize("cf", [1.5, 0.5])
def test_top2_dispatch_bitwise(cf):
    """The port's dispatch and combine equal JAX's bit for bit on the
    same gates: near-tie rows, and at factor 0.5 a binding capacity that
    drops tokens (their slots run past C, where F.one_hot would raise)."""
    G, E = 96, 4
    gates = _gates(G, E, seed=int(cf * 10))
    C = jmoe.MoEConfig(8, 8, E, cf).capacity(G)
    jd, jc = jmoe._top2_dispatch(jnp.asarray(gates), C)
    td, tc = tmoe._top2_dispatch(torch.from_numpy(gates), C)
    for t, j in ((td, jd), (tc, jc)):
        assert t.dtype == torch.float32 and t.shape == (G, E, C)
        assert np.array_equal(t.numpy().view(np.uint32),
                              np.asarray(j).view(np.uint32))
    dropped = 2 * G - int(td.sum())
    assert (dropped > 0) == (cf < 1)


@functools.partial(jax.jit, static_argnums=0)
def _init_layer(jc, key):
    jp = jmoe.init_moe_params(jc, key)
    # Nonzero biases, so their gradients and their shard slicing show.
    return {k: v + 0.01 * jnp.arange(v.size, dtype=v.dtype).reshape(v.shape)
            / v.size if k.startswith("b_") else v for k, v in jp.items()}


def _layer_inputs(jc, shape=(2, 12, 16), seed=0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return _init_layer(jc, jax.random.key(seed)), x


def _port_value_and_grads(x, params, cfg, mesh=None):
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    xt = torch.from_numpy(x).to(cfg.dtype).requires_grad_(True)
    y, aux = tmoe.moe_mlp(xt, leaves, cfg, mesh=mesh)
    yf = y.float()
    loss = (yf * torch.cos(yf)).sum() + aux
    names = list(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names] + [xt])
    return y, aux, dict(zip(names + ["x"], grads))


def _jax_value_and_grads(x, params, cfg):
    def f(p, x):
        y, aux = jmoe.moe_mlp(x, p, cfg)
        yf = y.astype(jnp.float32)
        return jnp.sum(yf * jnp.cos(yf)) + aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x, cfg.dtype))
    return y, aux, {**gp, "x": gx}


@pytest.mark.parametrize("cf", [1.5, 0.5])
def test_moe_mlp_matches_jax_fp32(cf):
    """moe_mlp's output, aux and gradients (of sum(y·cos y) + aux, to
    every parameter and x) against JAX's, with and without drops."""
    jc, tc = _layer_cfgs(capacity_factor=cf)
    jp, x = _layer_inputs(jc)
    jy, jaux, jg = _jax_value_and_grads(x, jp, jc)
    ty, taux, tg = _port_value_and_grads(x, _to_port(jp), tc)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-5)
    np.testing.assert_allclose(float(taux.detach()), float(jaux), atol=1e-5)
    assert set(tg) == set(jg)
    for k in jg:
        np.testing.assert_allclose(_np(tg[k]), _np(jg[k]), atol=1e-5,
                                   rtol=1e-4, err_msg=k)


def test_moe_mlp_bf16():
    jc, tc = _layer_cfgs("bf16")
    jp, x = _layer_inputs(jc, seed=1)
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_mlp(x, p, jc))(
        jp, jnp.asarray(x, jnp.bfloat16))
    ty, taux = tmoe.moe_mlp(torch.from_numpy(x).bfloat16(), _to_port(jp), tc)
    assert ty.dtype == torch.bfloat16 and taux.dtype == torch.float32
    assert float(np.mean(np.abs(_np(ty) - _np(jy)))) <= 2e-3
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-5)


def _dense_top2_reference(x, params):
    """Naive mixture (the port's copy of the JAX test's reference): per
    token, its top-2 experts' MLP outputs weighted by the renormalized
    gates; capacity unconstrained. numpy fp32, tanh GELU."""
    B, S, D = x.shape
    xf = x.reshape(-1, D).astype(np.float32)
    logits = xf @ params["wg"]
    gates = np.exp(logits - logits.max(-1, keepdims=True))
    gates /= gates.sum(-1, keepdims=True)
    gelu = lambda u: 0.5 * u * (1 + np.tanh(
        np.sqrt(2 / np.pi) * (u + 0.044715 * u ** 3)))
    out = np.zeros_like(xf)
    for g in range(xf.shape[0]):
        e1, e2 = np.argsort(-gates[g], kind="stable")[:2]
        w1, w2 = gates[g, e1], gates[g, e2]
        for e, w in ((e1, w1 / (w1 + w2)), (e2, w2 / (w1 + w2))):
            up = gelu(xf[g] @ params["w_up"][e] + params["b_up"][e])
            out[g] += w * (up @ params["w_down"][e] + params["b_down"][e])
    return out.reshape(B, S, D)


def test_moe_matches_dense_reference():
    """With generous capacity moe_mlp equals the dense top-2 mixture
    (the JAX test's bound, 1e-3), and JAX's moe_mlp within 1e-5."""
    jc, tc = _layer_cfgs(capacity_factor=4.0)
    jp, x = _layer_inputs(jc, shape=(2, 6, 16))
    y, aux = tmoe.moe_mlp(torch.from_numpy(x), _to_port(jp), tc)
    assert np.isfinite(float(aux))
    ref = _dense_top2_reference(x, {k: np.asarray(v) for k, v in jp.items()})
    np.testing.assert_allclose(_np(y), ref, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(
        _np(y), _np(jax.jit(lambda p, x: jmoe.moe_mlp(x, p, jc)[0])(
            jp, jnp.asarray(x))), atol=1e-5)


@pytest.mark.parametrize("ep", [2, 4])
def test_ep_matches_ep1(ep):
    """ep shards on a repeated cpu mesh, with whole and with placed
    expert leaves, against ep = 1: outputs within fp32 reassociation,
    the aux and every shard's gradients bitwise (each expert's gradient
    comes from its own shard's products alone)."""
    jc, tc = _layer_cfgs(n_experts=8)
    jp, x = _layer_inputs(jc, seed=2)
    whole = _to_port(jp)
    y1, aux1, g1 = _port_value_and_grads(x, whole, tc)
    mesh = [CPU] * ep
    placed = tpart.place_on_axis(whole, tmoe.moe_logical_axes(tc), mesh, "ep")
    assert placed["w_up@0"].shape == (8 // ep, 16, 32)
    assert "wg" in placed and "w_up" not in placed
    for params in (whole, placed):
        y, aux, g = _port_value_and_grads(x, params, tc, mesh)
        np.testing.assert_allclose(_np(y), _np(y1), atol=1e-6)
        assert torch.equal(aux, aux1)
        g = _joined(g, {**tmoe.moe_logical_axes(tc), "x": ()}, ep)
        for k in EXPERT_KEYS:
            assert torch.equal(g[k], g1[k]), k
        for k in ("wg", "x"):
            np.testing.assert_allclose(_np(g[k]), _np(g1[k]), atol=1e-6)
    with pytest.raises(ValueError, match="not divisible by ep=3"):
        tmoe.moe_mlp(torch.from_numpy(x), whole, tc, mesh=[CPU] * 3)


def test_moe_expert_parallel_grads():
    """The JAX test's ep = 4 case: E 8, bf16 x over a dp × ep mesh there,
    an ep = 4 cpu mesh in the port; the value and every gradient finite
    and against JAX's at the bf16 bar (value within 1e-3 relative,
    gradients' mean absolute error within 1e-2 of their mean size)."""
    mesh = make_mesh(MeshConfig(dp=2, fsdp=1, ep=4, tp=1))
    jc = jmoe.MoEConfig(d_model=16, d_ff=32, n_experts=8)
    tc = tmoe.MoEConfig(d_model=16, d_ff=32, n_experts=8)
    jp = jax.jit(jmoe.init_moe_params, static_argnums=0)(
        jc, jax.random.key(1))
    x = np.random.default_rng(1).normal(size=(8, 16, 16)).astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe.moe_mlp(x, p, jc)
        return jnp.mean(jnp.square(y.astype(jnp.float32))) + 0.01 * aux

    shardings = tree_to_shardings(jmoe.moe_logical_axes(jc), mesh)
    jval, jg = jax.jit(jax.value_and_grad(jloss))(
        jax.device_put(jp, shardings), jnp.asarray(x, jnp.bfloat16))
    placed = tpart.place_on_axis(_to_port(jp), tmoe.moe_logical_axes(tc),
                                 [CPU] * 4, "ep")
    leaves = {k: v.requires_grad_(True) for k, v in placed.items()}
    y, aux = tmoe.moe_mlp(torch.from_numpy(x).bfloat16(), leaves, tc,
                          mesh=[CPU] * 4)
    val = (y.float().square()).mean() + 0.01 * aux
    names = list(leaves)
    tg = _joined(dict(zip(names, torch.autograd.grad(
        val, [leaves[k] for k in names]))), tmoe.moe_logical_axes(tc), 4)
    assert np.isfinite(float(val))
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-3)
    for k, g in jg.items():
        t, j = _np(tg[k]), _np(g)
        assert np.isfinite(t).all(), k
        assert np.mean(np.abs(t - j)) <= 1e-2 * np.mean(np.abs(j)), k


# --------------------------------------------------------------- the model


def _model(seed=0, **kw):
    jcfg = jmoe_gpt.MoEGPTConfig.tiny(dtype=jnp.float32, **kw)
    tcfg = tmoe_gpt.MoEGPTConfig.tiny(dtype=torch.float32, **kw)
    jp = jax.jit(jmoe_gpt.init_params, static_argnums=0)(
        jcfg, jax.random.key(seed))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tcfg,
                         device="cpu")
    return jcfg, tcfg, jp, tp


def _tokens(vocab, B=2, S=16, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S))
    tg = np.roll(toks, -1, axis=1)
    return ((jnp.asarray(toks, jnp.int32), jnp.asarray(tg, jnp.int32)),
            (torch.from_numpy(toks), torch.from_numpy(tg)))


def _grads(tp, tcfg, toks, tg, **kw):
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    loss = tmoe_gpt.loss_fn(leaves, toks, tg, tcfg, **kw)
    names = list(leaves)
    return loss.detach(), dict(zip(names, torch.autograd.grad(
        loss, [leaves[k] for k in names])))


def test_bridge_carries_the_moe_leaves():
    jcfg, tcfg, jp, tp = _model()
    assert set(tp) == set(jp)
    for k in ("wg", "moe_w_up", "moe_b_up", "moe_w_down", "moe_b_down"):
        assert tp[k].dtype == torch.float32
        assert np.array_equal(tp[k].numpy(), np.asarray(jp[k]))


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_matches_jax(impl):
    """The mirror of test_forward_shapes_and_aux, against JAX's logits,
    aux and loss."""
    jcfg, tcfg, jp, tp = _model(attn_impl=impl)
    (jt, jtg), (tt, ttg) = _tokens(jcfg.vocab_size)
    logits, aux = tmoe_gpt.forward(tp, tt, tcfg)
    assert logits.shape == (2, 16, tcfg.vocab_size)
    assert logits.dtype == torch.float32
    # Balanced routing gives aux == 1; at init it must sit near it.
    assert 0.5 < float(aux) < float(tcfg.n_experts)
    jlogits, jaux = jax.jit(lambda p, t: jmoe_gpt.forward(p, t, jcfg))(jp, jt)
    np.testing.assert_allclose(_np(logits), _np(jlogits), atol=2e-5)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-5)
    np.testing.assert_allclose(
        float(tmoe_gpt.loss_fn(tp, tt, ttg, tcfg)),
        float(jmoe_gpt.loss_fn(jp, jt, jtg, jcfg)), atol=1e-5)


def test_grads_match_jax_and_remat():
    """jax.grad of loss_fn against autograd through the port (capacity
    0.5: tokens are dropped), and the port's remat gradients bitwise
    equal to its non-remat ones (the recompute routes alike)."""
    jcfg, tcfg, jp, tp = _model(seed=4, capacity_factor=0.5)
    (jt, jtg), (tt, ttg) = _tokens(jcfg.vocab_size, seed=3)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jmoe_gpt.loss_fn(p, jt, jtg, jcfg)))(jp)
    tl, tg = _grads(tp, tcfg, tt, ttg)
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-5)
    assert set(tg) == set(jg)
    for k in jg:
        np.testing.assert_allclose(_np(tg[k]), _np(jg[k]), atol=1e-5,
                                   rtol=1e-4, err_msg=k)
    rl, rg = _grads(tp, dataclasses.replace(tcfg, remat=True), tt, ttg)
    assert float(rl) == float(tl)
    for k in tg:
        assert torch.equal(rg[k], tg[k]), k


@pytest.mark.parametrize("ep", [2, 4])
def test_model_ep_matches_ep1(ep):
    """MoE-GPT (E 4) with ep_mesh over placed expert stacks against
    ep = 1: loss within fp32 reassociation, gradients within it."""
    _j, tcfg, _jp, tp = _model(seed=5)
    (_, _), (tt, ttg) = _tokens(tcfg.vocab_size, seed=5)
    l1, g1 = _grads(tp, tcfg, tt, ttg)
    mesh = [CPU] * ep
    placed = tpart.place_on_axis(tp, tmoe_gpt.logical_axes(tcfg), mesh, "ep")
    assert placed["moe_w_up@1"].shape == (2, 4 // ep, 64, 128)
    l, g = _grads(placed, tcfg, tt, ttg, ep_mesh=mesh)
    np.testing.assert_allclose(float(l), float(l1), atol=1e-6)
    g = _joined(g, tmoe_gpt.logical_axes(tcfg), ep)
    for k in g1:
        np.testing.assert_allclose(_np(g[k]), _np(g1[k]), atol=1e-6,
                                   rtol=1e-5, err_msg=k)


def test_loss_decreases():
    """The mirror of test_loss_decreases: 25 Adam steps (optax.adam as
    the port's adamw with weight_decay 0) on one batch; both losses fall
    by 0.5 and the first steps agree."""
    jcfg, tcfg, jp, tp = _model()
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 32, (4, 32))
    tg = np.roll(toks, -1, axis=1)
    jt, jtg = jnp.asarray(toks), jnp.asarray(tg)
    opt = optax.adam(1e-2)
    js = opt.init(jp)

    @jax.jit
    def jstep(params, opt_state):
        loss, grads = jax.value_and_grad(jmoe_gpt.loss_fn)(
            params, jt, jtg, jcfg)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    topt = toptim.adamw(1e-2, weight_decay=0.0)
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    ts = topt.init(tp)
    tstep = tspmd.make_train_step(
        lambda p, a, b: tmoe_gpt.loss_fn(p, a, b, tcfg), topt)
    jl, tl = [], []
    batch = (torch.from_numpy(toks), torch.from_numpy(tg))
    for _ in range(25):
        jp, js, loss = jstep(jp, js)
        jl.append(float(loss))
        tp, ts, loss = tstep(tp, ts, batch)
        tl.append(float(loss))
    np.testing.assert_allclose(tl[:3], jl[:3], rtol=1e-5)
    for losses in (jl, tl):
        assert losses[-1] < losses[0] - 0.5, losses


def test_ep_sharded_training_step(cpu_devices):
    """The mirror of test_ep_sharded_training_step: build_training with
    an ep = 2 mesh puts the expert stacks on their shards; two steps
    from the JAX weights against the JAX step on a dp × ep mesh."""
    jcfg, tcfg, jp, _ = _model()
    mesh = make_mesh(MeshConfig(dp=4, ep=2, fsdp=1, tp=1),
                     devices=cpu_devices)
    shardings = tree_to_shardings(jmoe_gpt.logical_axes(jcfg), mesh)
    assert "ep" in str(shardings["moe_w_up"].spec)
    opt = optax.adam(1e-2)
    ep_mesh = [CPU] * 2
    tp, ts, tstep = tspmd.build_training(
        tcfg, toptim.adamw(1e-2, weight_decay=0.0), device="cpu",
        model=tmoe_gpt, ep_mesh=ep_mesh)
    assert tp["moe_w_up@0"].shape == (2, 2, 64, 128)
    assert "moe_w_up" not in tp and tp["wg"].shape == (2, 64, 4)
    placed = tpart.place_on_axis(
        params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tcfg,
                        device="cpu"), tmoe_gpt.logical_axes(tcfg), ep_mesh,
        "ep")
    with torch.no_grad():
        for k, v in placed.items():
            tp[k].copy_(v)
    (jt, jtg), (tt, ttg) = _tokens(jcfg.vocab_size, B=8, seed=1)

    @jax.jit
    def jstep(params, opt_state, toks, tgts):
        loss, grads = jax.value_and_grad(jmoe_gpt.loss_fn)(
            params, toks, tgts, jcfg)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    with mesh:
        jparams = shard_tree(jp, shardings)
        js = opt.init(jparams)
        for _ in range(2):
            jparams, js, jl = jstep(jparams, js, jt, jtg)
            tp, ts, tl = tstep(tp, ts, (tt, ttg))
            np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
            whole = _joined(tp, tmoe_gpt.logical_axes(tcfg), 2)
            for k in jparams:
                diff = np.abs(_np(whole[k]) - _np(jparams[k]))
                assert float(np.mean(diff > 2e-5)) <= 1e-3, k
                assert float(diff.max()) <= 2 * 2 * 1e-2, k


def test_default_device_is_cuda():
    """Without a GPU every entry point's default device raises; the CPU
    is taken only when asked for."""
    cfg = tmoe_gpt.MoEGPTConfig.tiny()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            tmoe_gpt.init_params(cfg)
        with pytest.raises(RuntimeError, match="no GPU"):
            tmoe.init_moe_params(cfg.moe_cfg())
        with pytest.raises(RuntimeError, match="no GPU"):
            tspmd.build_training(cfg, toptim.adamw(1e-3), model=tmoe_gpt)
    p = tmoe.init_moe_params(cfg.moe_cfg(), device="cpu")
    assert all(v.device.type == "cpu" for v in p.values())
