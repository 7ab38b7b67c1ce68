"""PyTorch port vs the JAX package: the Llama family (RMSNorm, SwiGLU,
grouped-query attention).

Mirrors tests/test_llama.py. The same JAX ``init_params`` weights
(carried over by ``params_from_jax``) and the same seeded numpy tokens
go through ``ray_tpu.models.llama`` and ``ray_tpu_torch.models.llama``
on `tiny` (8 query heads over 4 kv heads, head dim 8). The JAX flash
path runs its Pallas kernels in interpret mode; on CPU tensors the port
takes the kernels' plain versions, and every test asserts that no
kernel launched.

Tolerances: fp32 logits within 2e-5 absolute and losses within 1e-5
relative (reassociated fp32 sums over a 256-word vocabulary); fp32
gradients within 1e-5 absolute plus 1e-4 relative; bf16 logits by the
repo's bf16 bar (mean absolute error <= 5e-3, tests/test_torch_model.py)
and the bf16 loss within 1e-2; a train step by tests/test_torch_train.py's
rule (Adam turns a gradient element within fp32 noise of zero into an
update anywhere in about ±lr): the losses within 1e-5 relative, all but
1% of each leaf within 2e-5 at lr 1e-2 (GPT's test allows 0.1%; tiny
Llama's wq holds more near-zero gradient elements: 0.13% after three
steps), every element within the steps taken (3 × 2 lr).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import llama as jllama
from ray_tpu.parallel.mesh import MeshConfig, make_mesh
from ray_tpu.train import spmd as jspmd
from ray_tpu_torch._bridge import params_from_jax
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.train import optim as toptim
from ray_tpu_torch.train import spmd as tspmd

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
CPU4 = [torch.device("cpu")] * 4


@pytest.fixture(autouse=True)
def counters():
    tattn.reset_launch_counts()
    yield
    assert (tattn.flash_fwd.launches, tattn.flash_dq.launches,
            tattn.flash_dkv.launches) == (0, 0, 0)


def _setup(dt="fp32", seed=0, **kw):
    jd, td = DTYPES[dt]
    jcfg = jllama.LlamaConfig.tiny(dtype=jd, **kw)
    tcfg = tllama.LlamaConfig.tiny(dtype=td, **kw)
    jp = jllama.init_params(jcfg, jax.random.key(seed))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tcfg,
                         device="cpu")
    return jcfg, tcfg, jp, tp


def _tokens(vocab, B=2, S=32, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S))
    tg = np.roll(toks, -1, axis=1)
    return ((jnp.asarray(toks, jnp.int32), jnp.asarray(tg, jnp.int32)),
            (torch.from_numpy(toks), torch.from_numpy(tg)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def test_param_table_matches_jax():
    for name in ("tiny", "llama2_7b", "llama3_8b"):
        jcfg = getattr(jllama.LlamaConfig, name)()
        tcfg = getattr(tllama.LlamaConfig, name)()
        assert tllama.param_specs(tcfg) == jllama.param_specs(jcfg), name
        assert tllama.logical_axes(tcfg) == jllama.logical_axes(jcfg)
        assert tllama.num_params(tcfg) == jllama.num_params(jcfg)
    tp = tllama.init_params(tllama.LlamaConfig.tiny(), device="cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: s["shape"] for k, s in jllama.param_specs(
            jllama.LlamaConfig.tiny()).items()}


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_and_loss_match_jax_fp32(impl):
    jcfg, tcfg, jp, tp = _setup(attn_impl=impl)
    (jt, jg), (tt, tg) = _tokens(jcfg.vocab_size)
    want = np.asarray(jax.jit(lambda p, t: jllama.forward(p, t, jcfg))(jp, jt))
    got = _np(tllama.forward(tp, tt, tcfg))
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(
        float(tllama.loss_fn(tp, tt, tg, tcfg)),
        float(jllama.loss_fn(jp, jt, jg, jcfg)), rtol=1e-5)


def test_forward_and_loss_match_jax_bf16():
    jcfg, tcfg, jp, tp = _setup("bf16")
    (jt, jg), (tt, tg) = _tokens(jcfg.vocab_size)
    want = np.asarray(jllama.forward(jp, jt, jcfg), np.float32)
    got = _np(tllama.forward(tp, tt, tcfg))
    assert np.isfinite(got).all()
    assert float(np.mean(np.abs(got - want))) <= 5e-3
    np.testing.assert_allclose(
        float(tllama.loss_fn(tp, tt, tg, tcfg)),
        float(jllama.loss_fn(jp, jt, jg, jcfg)), atol=1e-2)


def test_gqa_equals_mha_when_kv_repeated():
    """GQA over 2 kv heads equals MHA whose kv weights repeat each kv
    head in place (jnp.repeat), in the port and in JAX alike."""
    jcfg, tcfg, jp, tp = _setup(seed=1, n_heads=8, n_kv_heads=2)
    (jt, _), (tt, _) = _tokens(jcfg.vocab_size, B=2, S=12, seed=2)
    jm = dict(jp, wk=jnp.repeat(jp["wk"], 4, axis=2),
              wv=jnp.repeat(jp["wv"], 4, axis=2))
    tm = dict(tp, wk=torch.repeat_interleave(tp["wk"], 4, dim=2),
              wv=torch.repeat_interleave(tp["wv"], 4, dim=2))
    jcfg_m = jllama.LlamaConfig.tiny(dtype=jnp.float32, n_kv_heads=8)
    tcfg_m = tllama.LlamaConfig.tiny(dtype=torch.float32, n_kv_heads=8)
    got = _np(tllama.forward(tp, tt, tcfg))
    np.testing.assert_allclose(got, _np(tllama.forward(tm, tt, tcfg_m)),
                               atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(
        jllama.forward(jm, jt, jcfg_m)), atol=2e-5)


def test_tiled_kv_repeat_fails(monkeypatch):
    """A planted fault: kv heads tiled (head h ← kv head h mod KV) in
    place of repeated in place. Same shapes, other heads: the logits
    must leave the JAX model's by far more than the fp32 tolerance."""
    jcfg, tcfg, jp, tp = _setup()
    (jt, _), (tt, _) = _tokens(jcfg.vocab_size)
    want = np.asarray(jllama.forward(jp, jt, jcfg))
    monkeypatch.setattr(tllama, "_repeat_kv",
                        lambda x, groups: x.repeat(1, 1, groups, 1))
    got = _np(tllama.forward(tp, tt, tcfg))
    assert got.shape == want.shape
    assert np.abs(got - want).max() > 100 * 2e-5


def test_causality():
    """Future tokens must not influence current logits."""
    _, tcfg, _, tp = _setup(seed=3)
    rng = np.random.default_rng(3)
    a = rng.integers(0, tcfg.vocab_size, (1, 16))
    b = a.copy()
    b[0, 10:] = rng.integers(0, tcfg.vocab_size, 6)
    la = _np(tllama.forward(tp, torch.from_numpy(a), tcfg))
    lb = _np(tllama.forward(tp, torch.from_numpy(b), tcfg))
    np.testing.assert_array_equal(la[0, :10], lb[0, :10])
    assert np.abs(la[0, 10:] - lb[0, 10:]).max() > 1e-3


@pytest.mark.parametrize("remat", [False, True])
def test_grads_match_jax(remat):
    jcfg, tcfg, jp, tp = _setup(remat=remat, attn_impl="flash")
    (jt, jg), (tt, tg) = _tokens(jcfg.vocab_size)
    want = jax.grad(lambda p: jllama.loss_fn(p, jt, jg, jcfg))(jp)
    leaves = {k: v.requires_grad_(True) for k, v in tp.items()}
    loss = tllama.loss_fn(leaves, tt, tg, tcfg)
    got = torch.autograd.grad(loss, list(leaves.values()))
    for k, g in zip(leaves, got):
        np.testing.assert_allclose(_np(g), np.asarray(want[k]), atol=1e-5,
                                   rtol=1e-4, err_msg=k)


def test_build_training_step_matches_jax():
    """Three steps of build_training(model=llama) against JAX's
    spmd.build_training(model=llama) on a one-device mesh, from the same
    parameters and batch."""
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    mesh = make_mesh(MeshConfig(dp=1, fsdp=1, sp=1, tp=1),
                     devices=jax.devices()[:1])
    jp, js, jstep = jspmd.build_training(
        jcfg, mesh, optax.adamw(1e-2), jax.random.key(0), model=jllama)
    tp, ts, tstep = tspmd.build_training(tcfg, toptim.adamw(1e-2),
                                         device="cpu", model=tllama)
    with torch.no_grad():
        for k, v in params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                                    tcfg, device="cpu").items():
            tp[k].copy_(v)
    (jt, jg), (tt, tg) = _tokens(jcfg.vocab_size, B=8, S=32)
    losses = []
    for _ in range(3):
        jp, js, jl = jstep(jp, js, (jt, jg))
        tp, ts, tl = tstep(tp, ts, (tt, tg))
        losses.append(float(tl))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        for k in jp:
            diff = np.abs(_np(tp[k]) - _np(jp[k]))
            assert float(np.mean(diff > 2e-5)) <= 1e-2, k
            assert float(diff.max()) <= 3 * 2 * 1e-2, k
    assert losses[-1] < losses[0]


def test_ring_path_matches_jax(cpu_devices):
    """attn_impl="ring" on an sp=4 mesh: the port's loss and gradients
    against the JAX ring's (its xla impl on the CPU, as the port's)."""
    jmesh = make_mesh(MeshConfig(dp=2, fsdp=1, sp=4, tp=1))
    jcfg, tcfg, jp, tp = _setup(attn_impl="ring")
    (jt, jg), (tt, tg) = _tokens(jcfg.vocab_size, B=2, S=64)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda p: jllama.loss_fn(p, jt, jg, jcfg, jmesh)))(jp)
    leaves = {k: v.requires_grad_(True) for k, v in tp.items()}
    loss = tllama.loss_fn(leaves, tt, tg, tcfg, CPU4)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    plain = tllama.loss_fn(tp, tt, tg, tllama.LlamaConfig.tiny(
        dtype=torch.float32))
    np.testing.assert_allclose(loss.item(), plain.item(), rtol=1e-5)
    got = torch.autograd.grad(loss, list(leaves.values()))
    for k, g in zip(leaves, got):
        np.testing.assert_allclose(_np(g), np.asarray(jgrad[k]), atol=1e-5,
                                   rtol=1e-4, err_msg=k)
    with pytest.raises(ValueError, match=r"requires forward\(\.\.\., mesh=\)"):
        tllama.loss_fn(tp, tt, tg, tcfg)
