"""PyTorch port vs the JAX package: the GPT training step.

Same weights (JAX ``init_params`` carried over by ``params_from_jax``),
the same seeded numpy tokens, and the same optimizer settings go through
``ray_tpu.models.gpt`` / ``ray_tpu.train.spmd`` / optax and their
counterparts in ``ray_tpu_torch``. The JAX flash path runs its Pallas
kernels in interpret mode (as the JAX tests run them); on CPU tensors the
port runs the kernels' plain versions, and every test asserts that the
three flash launch counters stay 0.

Tolerances: fp32 logits and losses within 1e-5 (reassociated fp32 sums);
fp32 gradients within 1e-5 absolute plus 1e-4 relative (the backward
sums over every token); bf16 logits by the repo's bf16 bar (mean abs
error <= 5e-3, as tests/test_torch_model.py) and the bf16 loss within
1e-2; the optimizer's parameters within 1e-6 (fp32 rounding of an update
of size lr = 3e-2) and its moments within 1e-6 relative; the train step
as stated at its test.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import gpt as jgpt
from ray_tpu.parallel.mesh import MeshConfig, make_mesh
from ray_tpu.train import spmd as jspmd
from ray_tpu_torch._bridge import params_from_jax
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.train import optim as toptim
from ray_tpu_torch.train import spmd as tspmd

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
B, S = 2, 32


@pytest.fixture(autouse=True)
def counters():
    tattn.reset_launch_counts()
    yield
    assert (tattn.flash_fwd.launches, tattn.flash_dq.launches,
            tattn.flash_dkv.launches) == (0, 0, 0)


def _setup(name="tiny", dt="fp32", seed=3, **kw):
    jd, td = DTYPES[dt]
    jcfg = getattr(jgpt.GPTConfig, name)(dtype=jd, **kw)
    tcfg = getattr(tgpt.GPTConfig, name)(dtype=td, **kw)
    jp = jgpt.init_params(jcfg, jax.random.key(seed))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tcfg,
                         device="cpu")
    return jcfg, tcfg, jp, tp


def _tokens(vocab, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S))
    tg = np.roll(toks, -1, axis=1)
    return ((jnp.asarray(toks, jnp.int32), jnp.asarray(tg, jnp.int32)),
            (torch.from_numpy(toks), torch.from_numpy(tg)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _torch_grads(tp, tcfg, toks, tg):
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    loss = tgpt.loss_fn(leaves, toks, tg, tcfg)
    names = list(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names])
    return loss.detach(), dict(zip(names, grads))


def test_config_training_fields_match():
    for name in jgpt.GPTConfig._REGISTRY:
        j = jgpt.GPTConfig.by_name(name)
        t = tgpt.GPTConfig.by_name(name)
        for f in ("remat", "attn_impl", "attn_block_q", "attn_block_kv",
                  "loss_chunk", "max_seq"):
            assert getattr(j, f) == getattr(t, f), (name, f)
    assert tgpt.num_params(tgpt.GPTConfig.gpt2_124m()) == jgpt.num_params(
        jgpt.GPTConfig.gpt2_124m())
    with pytest.raises(NotImplementedError, match="ring"):
        cfg = tgpt.GPTConfig.tiny(attn_impl="ring", dtype=torch.float32)
        tgpt.loss_fn(tgpt.init_params(cfg, device="cpu"),
                     torch.zeros(1, 4, dtype=torch.long),
                     torch.zeros(1, 4, dtype=torch.long), cfg)


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("name", ["tiny", "tiny_untied"])
def test_forward_and_loss_fp32(name, impl):
    jcfg, tcfg, jp, tp = _setup(name, attn_impl=impl)
    (jt, jtg), (tt, ttg) = _tokens(jcfg.vocab_size)
    np.testing.assert_allclose(_np(tgpt.forward(tp, tt, tcfg)),
                               _np(jgpt.forward(jp, jt, jcfg)), atol=1e-5)
    np.testing.assert_allclose(float(tgpt.loss_fn(tp, tt, ttg, tcfg)),
                               float(jgpt.loss_fn(jp, jt, jtg, jcfg)),
                               atol=1e-5)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_and_loss_bf16(impl):
    jcfg, tcfg, jp, tp = _setup("tiny", "bf16", attn_impl=impl)
    (jt, jtg), (tt, ttg) = _tokens(jcfg.vocab_size, seed=1)
    out = tgpt.forward(tp, tt, tcfg)
    assert out.dtype == torch.float32
    ref = _np(jgpt.forward(jp, jt, jcfg))
    assert float(np.mean(np.abs(_np(out) - ref))) <= 5e-3
    assert abs(float(tgpt.loss_fn(tp, tt, ttg, tcfg))
               - float(jgpt.loss_fn(jp, jt, jtg, jcfg))) <= 1e-2


def test_loss_chunk():
    """The chunked head gives the one-shot loss and the JAX chunked loss,
    and the same gradients; a chunk that does not divide S raises."""
    jcfg, tcfg, jp, tp = _setup("tiny_untied", loss_chunk=8)
    (jt, jtg), (tt, ttg) = _tokens(jcfg.vocab_size, seed=2)
    whole = dataclasses.replace(tcfg, loss_chunk=None)
    l_chunk, g_chunk = _torch_grads(tp, tcfg, tt, ttg)
    l_whole, g_whole = _torch_grads(tp, whole, tt, ttg)
    np.testing.assert_allclose(float(l_chunk), float(l_whole), atol=1e-6)
    np.testing.assert_allclose(float(l_chunk),
                               float(jgpt.loss_fn(jp, jt, jtg, jcfg)),
                               atol=1e-5)
    for k in g_whole:
        np.testing.assert_allclose(_np(g_chunk[k]), _np(g_whole[k]),
                                   atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError, match="loss_chunk"):
        tgpt.loss_fn(tp, tt[:, :30], ttg[:, :30],
                     dataclasses.replace(tcfg, loss_chunk=7))


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("name", ["tiny", "tiny_untied"])
def test_grads_match_jax(name, impl):
    """jax.grad of loss_fn against autograd through the port, tied and
    untied embeddings (the tied wte takes gradient from the embedding
    gather and from the head)."""
    jcfg, tcfg, jp, tp = _setup(name, attn_impl=impl, seed=4)
    (jt, jtg), (tt, ttg) = _tokens(jcfg.vocab_size, seed=3)
    jl, jg = jax.value_and_grad(jgpt.loss_fn)(jp, jt, jtg, jcfg)
    tl, tg = _torch_grads(tp, tcfg, tt, ttg)
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-5)
    assert set(tg) == set(jg)
    for k in jg:
        np.testing.assert_allclose(_np(tg[k]), _np(jg[k]), atol=1e-5,
                                   rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_remat_gives_the_same_gradients(impl):
    _j, tcfg, _jp, tp = _setup("tiny", attn_impl=impl, seed=5)
    toks = torch.from_numpy(
        np.random.default_rng(4).integers(0, tcfg.vocab_size, (B, S)))
    tg = torch.roll(toks, -1, dims=1)
    l0, g0 = _torch_grads(tp, tcfg, toks, tg)
    l1, g1 = _torch_grads(tp, dataclasses.replace(tcfg, remat=True), toks, tg)
    assert float(l0) == float(l1)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=0)


@pytest.mark.parametrize("mu", [None, "bfloat16"])
def test_adamw_matches_optax(mu):
    """Three updates from the same parameters and gradients: the
    parameters and both moments (mu in its dtype) against optax.adamw,
    jitted as the JAX train step runs it."""
    rng = np.random.default_rng(5)
    shapes = {"a": (7, 5), "b": (11,), "c": (3, 4, 2)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    jopt = optax.adamw(3e-2, weight_decay=0.1, mu_dtype=mu)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jopt.init(jp)
    topt = toptim.adamw(3e-2, weight_decay=0.1,
                        mu_dtype=None if mu is None else torch.bfloat16)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = topt.init(tp)
    for g in grads:
        upd, js = jax.jit(jopt.update)(
            {k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        tu, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             ts, tp)
        toptim.apply_updates(tp, tu)
    adam = js[0]
    assert ts.count == int(adam.count) == 3
    for k in shapes:
        assert ts.mu[k].dtype == (torch.float32 if mu is None
                                  else torch.bfloat16)
        np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(_np(ts.mu[k]), _np(adam.mu[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(_np(ts.nu[k]), _np(adam.nu[k]),
                                   rtol=1e-6, atol=1e-9)


# Adam divides each gradient element by the root of its own second moment,
# so an element whose gradient is within fp32 noise of zero (the two sides
# sum in different orders) turns that noise into an update anywhere in
# about ±lr; a bf16 first moment adds a flipped 8-bit rounding. So: the
# losses within 1e-5 relative, all but 0.1% of each leaf's elements within
# 2e-5, and every element within the steps taken (3 × 2 lr).
@pytest.mark.parametrize("impl,mu", [("xla", None), ("flash", "bfloat16")])
def test_build_training_matches_jax(impl, mu):
    """Three steps of build_training's step against JAX's
    spmd.build_training on a one-device mesh, from the same parameters
    and batch: the losses and the parameters after each step."""
    jcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32, attn_impl=impl)
    tcfg = tgpt.GPTConfig.tiny(dtype=torch.float32, attn_impl=impl)
    mesh = make_mesh(MeshConfig(dp=1, fsdp=1, sp=1, tp=1),
                     devices=jax.devices()[:1])
    jp, js, jstep = jspmd.build_training(
        jcfg, mesh, optax.adamw(1e-2, weight_decay=0.1, mu_dtype=mu),
        jax.random.key(7))
    tp, ts, tstep = tspmd.build_training(
        tcfg, toptim.adamw(1e-2, weight_decay=0.1,
                           mu_dtype=mu and torch.bfloat16), device="cpu")
    with torch.no_grad():
        for k, v in params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                                    tcfg, device="cpu").items():
            tp[k].copy_(v)
    (jt, jtg), (tt, ttg) = _tokens(jcfg.vocab_size, seed=6)
    losses = []
    for _ in range(3):
        jp, js, jl = jstep(jp, js, (jt, jtg))
        tp, ts, tl = tstep(tp, ts, (tt, ttg))
        assert not tl.requires_grad
        losses.append(float(tl))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        for k in jp:
            diff = np.abs(_np(tp[k]) - _np(jp[k]))
            assert float(np.mean(diff > 2e-5)) <= 1e-3, k
            assert float(diff.max()) <= 3 * 2 * 1e-2, k
    assert losses[-1] < losses[0]
