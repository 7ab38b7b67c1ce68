"""PyTorch port vs the JAX package: the model math of the serving path.

Same weights (``gpt.init_params`` with a JAX key, carried over by
``ray_tpu_torch._bridge.params_from_jax``) and the same numpy inputs go
through ``ray_tpu.models.{gpt,decode}`` and their counterparts in
``ray_tpu_torch.models``. fp32 agrees within 1e-5; bf16 logits within
the repo's bf16 bar (mean abs error <= 5e-3, as tests/test_quant.py).
The three numeric hazards of the port are pinned here: population
variance in the layer norm, interleaved rotary pairs, tanh GELU, and
fp32 logits from a bf16 head.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import decode as jdecode
from ray_tpu.models import gpt as jgpt
from ray_tpu_torch._bridge import params_from_jax
from ray_tpu_torch.models import decode as tdecode
from ray_tpu_torch.models import gpt as tgpt

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(name, dt):
    jd, td = DTYPES[dt]
    return (getattr(jgpt.GPTConfig, name)(dtype=jd),
            getattr(tgpt.GPTConfig, name)(dtype=td))


def _params(name, dt, seed=3):
    jcfg, tcfg = _cfgs(name, dt)
    jp = jgpt.init_params(jcfg, jax.random.key(seed))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tcfg,
                         device="cpu")
    return jcfg, tcfg, jp, tp


def _np(x):
    return np.asarray(x, np.float32)


def _t2np(t):
    return t.float().numpy()


def _inputs(shape, dt, seed=0):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    jd, td = DTYPES[dt]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def test_config_presets_match():
    for name in jgpt.GPTConfig._REGISTRY:
        j = jgpt.GPTConfig.by_name(name)
        t = tgpt.GPTConfig.by_name(name)
        for f in ("vocab_size", "d_model", "n_layers", "n_heads", "d_ff",
                  "rotary_dim", "tie_embeddings", "head_dim"):
            assert getattr(j, f) == getattr(t, f), (name, f)
    assert tgpt.GPTConfig.opt_1_3b().dtype == torch.bfloat16


def test_param_shapes_match_and_bridge_is_exact():
    jcfg, tcfg, jp, tp = _params("tiny_untied", "fp32")
    assert set(jp) == set(tp) == set(tgpt.param_specs(tcfg))
    for k in jp:
        assert tuple(jp[k].shape) == tuple(tp[k].shape), k
        np.testing.assert_array_equal(_np(jp[k]), _t2np(tp[k]))
    own = tgpt.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: v.shape for k, v in own.items()} == {
        k: v.shape for k, v in tp.items()}


def test_bridge_bf16_roundtrip_exact():
    a = np.random.default_rng(1).normal(size=(7, 5)).astype(np.float32)
    jb = np.asarray(jnp.asarray(a, jnp.bfloat16))    # ml_dtypes bfloat16
    cfg = tgpt.GPTConfig.tiny(param_dtype=torch.bfloat16)
    t = params_from_jax({"w": jb}, cfg, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(jb.astype(np.float32), _t2np(t))


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_layer_norm(dt):
    jx, tx = _inputs((3, 5, 64), dt)
    rng = np.random.default_rng(2)
    sc = rng.normal(size=64).astype(np.float32)
    bi = rng.normal(size=64).astype(np.float32)
    ref = jgpt._layer_norm(jx, jnp.asarray(sc), jnp.asarray(bi))
    out = tgpt._layer_norm(tx, torch.from_numpy(sc), torch.from_numpy(bi))
    assert out.dtype == tx.dtype
    atol = 1e-5 if dt == "fp32" else 2e-2
    np.testing.assert_allclose(_t2np(out), _np(ref), atol=atol)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("rotary_dim", [4, 8])
def test_rotary_interleaved_pairs(dt, rotary_dim):
    jx, tx = _inputs((2, 5, 3, 8), dt, seed=4)
    pos = np.random.default_rng(5).integers(0, 120, size=(2, 5)).astype(
        np.int32)
    ref = jdecode._rotary_pos(jx, rotary_dim, jnp.asarray(pos))
    out = tdecode._rotary_pos(tx, rotary_dim, torch.from_numpy(pos))
    atol = 1e-5 if dt == "fp32" else 2e-2
    np.testing.assert_allclose(_t2np(out), _np(ref), atol=atol)


@pytest.mark.parametrize("name", ["tiny", "tiny_untied"])
def test_qkv_and_mlp_fp32(name):
    jcfg, tcfg, jp, tp = _params(name, "fp32")
    jx, tx = _inputs((2, 6, jcfg.d_model), "fp32", seed=6)
    jl = {k: v[1] for k, v in jgpt.stack_block_params(jp).items()}
    tl = {k: v[1] for k, v in tgpt.stack_block_params(tp).items()}
    for a, b in zip(jdecode._qkv(jx, jl, jcfg), tdecode._qkv(tx, tl, tcfg)):
        np.testing.assert_allclose(_t2np(b), _np(a), atol=1e-5)
    np.testing.assert_allclose(
        _t2np(tdecode._mlp(tx, tl, tcfg)), _np(jdecode._mlp(jx, jl, jcfg)),
        atol=1e-5)


@pytest.mark.parametrize("name", ["tiny", "tiny_untied"])
def test_head_fp32(name):
    jcfg, tcfg, jp, tp = _params(name, "fp32")
    jx, tx = _inputs((2, 4, jcfg.d_model), "fp32", seed=7)
    ref = jdecode._head(jp, jcfg, jx)
    out = tdecode._head(tp, tcfg, tx)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_t2np(out), _np(ref), atol=1e-5)


@pytest.mark.parametrize("name", ["tiny", "tiny_untied"])
def test_bf16_block_and_head_logit_mae(name):
    """bf16 compute through one block + the head: fp32 logits, within
    the bf16 logit bar."""
    jcfg, tcfg, jp, tp = _params(name, "bf16")
    jx, tx = _inputs((2, 4, jcfg.d_model), "bf16", seed=8)
    jl = {k: v[0] for k, v in
          jgpt.stack_block_params(jp, jcfg.dtype).items()}
    tl = {k: v[0] for k, v in
          tgpt.stack_block_params(tp, tcfg.dtype).items()}
    ref = jdecode._head(jp, jcfg, jdecode._mlp(jx, jl, jcfg))
    out = tdecode._head(tp, tcfg, tdecode._mlp(tx, tl, tcfg))
    assert out.dtype == torch.float32
    assert float(np.mean(np.abs(_t2np(out) - _np(ref)))) <= 5e-3


def test_sample_token_greedy_and_topk():
    logits = torch.tensor([[0.1, 2.0, 2.0, -1.0], [3.0, 0.0, 1.0, 2.5]])
    np.testing.assert_array_equal(
        tdecode.sample_token(logits).numpy(),
        np.asarray(jdecode.sample_token(jnp.asarray(logits.numpy()))))
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([tdecode.sample_token(logits, temperature=1.0,
                                              top_k=2, generator=gen)
                         for _ in range(200)])
    assert set(draws[:, 0].tolist()) <= {1, 2}
    assert set(draws[:, 1].tolist()) <= {0, 3}
    with pytest.raises(ValueError):
        tdecode.sample_token(logits, temperature=1.0)


def test_gumbel_noise_is_finite_at_u_zero(monkeypatch):
    """torch.rand can return exactly 0.0; the reference draws u from
    [finfo(float32).tiny, 1) (jax.random.categorical → gumbel), so its
    least noise is -log(-log(tiny)), about -4.47, never -inf. The port's
    noise at u = 0 is that value, and above tiny it is -log(-log(u)) as
    before. With every u = 0 the noise is one constant and the draw is
    the argmax of the logits (with -inf noise everywhere it was index
    0)."""
    tiny = np.finfo(np.float32).tiny
    least = float(-jnp.log(-jnp.log(jnp.float32(tiny))))
    u = torch.tensor([0.0, tiny, 1e-30, 0.5, 1 - 2 ** -24])
    g = tdecode._gumbel(u)
    assert torch.isfinite(g).all()
    assert float(g[0]) == float(g[1]) and float(g[0]) >= least - 1e-6
    np.testing.assert_allclose(
        g[1:].numpy(), -np.log(-np.log(u[1:].numpy().astype(np.float64))),
        rtol=1e-6)
    logits = torch.tensor([[0.1, 2.0, -1.0], [3.0, 0.0, 5.0]])
    monkeypatch.setattr(torch, "rand", lambda shape, **kw: torch.zeros(shape))
    np.testing.assert_array_equal(
        tdecode._categorical(logits, torch.Generator()).numpy(), [1, 2])
