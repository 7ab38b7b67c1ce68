"""PyTorch port vs the JAX package: bf16 master weights with stochastic
rounding (``ray_tpu_torch.train.low_precision`` against
``ray_tpu.train.low_precision``, and the ``stochastic_round=True`` train
step of both packages).

The port cannot draw ``jax.random``'s bits, so the rounding is held to
the reference in three ways: the arithmetic bit for bit on the same
noise; the statistics the JAX test asks for (representable values never
move, the mean over 400 generators within 5e-3 relative of x); and one
step of the bf16-master train step from the same parameters, where both
packages round nearly the same fp32 values up or down, so every
parameter lies within two bf16 ulps (2 x 2^-7 relative: one when the
two sums fall between the same bf16 neighbours, two when they straddle
one) of the JAX step's, plus 2^-6 of the leaf's largest step (the
gradients are bf16 in both packages, rounded from fp32 sums taken in
another order, so an element's update can differ by a bf16 rounding).
Then the SR step learns and tracks an fp32-master run, as
tests/test_spmd_training.py::TestLowPrecision requires (40 steps of
adafactor(1e-2) on GPT tiny: the loss falls by at least 0.5 and ends
within 0.1 of the fp32 run's).
"""


import numpy as np
import optax
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import gpt as jgpt
from ray_tpu.parallel.mesh import MeshConfig, make_mesh
from ray_tpu.train import spmd as jspmd
from ray_tpu_torch._bridge import params_from_jax
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.train import low_precision as tlp
from ray_tpu_torch.train import optim as toptim
from ray_tpu_torch.train import spmd as tspmd


def _jax_round_with_noise(x: np.ndarray, noise: np.ndarray) -> np.ndarray:
    """The reference's stochastic_round_bf16 with its noise given: the
    bf16 bits as uint16."""
    bits = jax.lax.bitcast_convert_type(jnp.asarray(x, jnp.float32),
                                        jnp.uint32)
    bits = (bits + jnp.asarray(noise, jnp.uint32)) & jnp.uint32(0xFFFF0000)
    out = jax.lax.bitcast_convert_type(bits, jnp.float32).astype(jnp.bfloat16)
    return np.asarray(out).view(np.uint16)


def test_round_with_noise_is_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    f32 = np.finfo(np.float32)
    x = np.concatenate([
        rng.normal(size=4000) * 10.0 ** rng.integers(-30, 30, 4000),
        [0.0, -0.0, np.inf, -np.inf, f32.max, -f32.max, f32.tiny,
         -f32.tiny, f32.tiny / 8, 1.0, -1.0, 1 + 2**-8, 65504.0, 3e38],
    ]).astype(np.float32)
    noise = rng.integers(0, 1 << 16, x.shape, dtype=np.int64)
    noise[:16] = 0xFFFF
    want = _jax_round_with_noise(x, noise)
    got = tlp._round_with_noise(torch.from_numpy(x),
                                torch.from_numpy(noise.astype(np.int32)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(
        np.uint16), want)


def test_representable_values_never_move_and_mean_is_unbiased():
    y = torch.tensor([1.0, 0.5, -2.0, 0.0, 3.140625, -1e-3]).to(
        torch.bfloat16).float()
    for seed in range(50):
        gen = torch.Generator().manual_seed(seed)
        assert torch.equal(tlp.stochastic_round_bf16(y, gen).float(), y)
    x = torch.tensor([1.0 + 1 / 512, 3e-4, -2.5e-5], dtype=torch.float32)
    n = 400
    acc = np.zeros(3, np.float64)
    for i in range(n):
        gen = torch.Generator().manual_seed(i)
        acc += tlp.stochastic_round_bf16(x, gen).double().numpy()
    xs = x.double().numpy()
    assert (np.abs(acc / n - xs) / np.abs(xs)).max() < 5e-3
    # A plain cast is biased: every 1 + 1/512 lands on one neighbour.
    assert float(x[0].to(torch.bfloat16)) in (1.0, 1.0078125)


def test_sr_apply_updates():
    """bf16 leaves round stochastically and replay exactly from (count,
    leaf index); other leaves take the plain fp32 add and cast; lazy
    updates apply slice by slice."""
    base = {"a": torch.full((4, 300), 1.0, dtype=torch.bfloat16),
            "b": torch.full((300,), 1.0, dtype=torch.float32)}
    upd = {"a": torch.full((4, 300), 1e-3), "b": torch.full((300,), 1e-3)}

    def run(count, updates):
        p = {k: v.clone() for k, v in base.items()}
        tlp.sr_apply_updates(p, dict(updates), count)
        return p

    r0, r0b, r1 = run(0, upd), run(0, upd), run(1, upd)
    assert r0["a"].dtype == torch.bfloat16 and torch.equal(r0["a"], r0b["a"])
    assert not torch.equal(r0["a"], r1["a"])
    assert set(r0["a"].float().unique().tolist()) == {1.0, 1.0078125}
    assert abs(float(r0["a"].float().mean()) - 1.001) < 1e-3
    assert torch.equal(r0["b"], torch.full((300,), 1.001))
    sliced = run(0, {"a": ((i, upd["a"][i]) for i in range(4)),
                     "b": upd["b"]})
    assert torch.equal(sliced["a"], r0["a"])


def _tokens(vocab, B=8, S=64, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S))
    return toks, np.roll(toks, -1, axis=1)


def test_sr_step_matches_jax_within_two_ulps():
    """One bf16-master adafactor step of both packages from the same
    bf16 parameters: the losses agree and every parameter lies within
    two bf16 ulps of the JAX step's (each rounds nearly the same fp32
    sum up or down); the moments are bf16 in both."""
    jcfg = jgpt.GPTConfig.tiny(param_dtype=jnp.bfloat16, dtype=jnp.float32)
    tcfg = tgpt.GPTConfig.tiny(param_dtype=torch.bfloat16,
                               dtype=torch.float32)
    mesh = make_mesh(MeshConfig(dp=1, fsdp=1, sp=1, tp=1),
                     devices=jax.devices()[:1])
    jp, js, jstep = jspmd.build_training(jcfg, mesh, optax.adafactor(1e-2),
                                         jax.random.key(0),
                                         stochastic_round=True)
    tp, ts, tstep = tspmd.build_training(tcfg, toptim.adafactor(1e-2),
                                         device="cpu", stochastic_round=True)
    with torch.no_grad():
        for k, v in params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                                    tcfg, device="cpu").items():
            tp[k].copy_(v)
    toks, tg = _tokens(jcfg.vocab_size)
    before = {k: np.asarray(v, np.float32) for k, v in jp.items()}
    jp, js, jl = jstep(jp, js, (jnp.asarray(toks, jnp.int32),
                                jnp.asarray(tg, jnp.int32)))
    tp, ts, tl = tstep(tp, ts, (torch.from_numpy(toks), torch.from_numpy(tg)))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert ts[1] == 1 and int(js[1]) == 1
    for k in jp:
        assert tp[k].dtype == torch.bfloat16
        want = np.asarray(jp[k], np.float32)
        step = float(np.abs(want - before[k]).max())
        np.testing.assert_allclose(tp[k].detach().float().numpy(), want,
                                   rtol=2 * 2**-7, atol=2**-6 * step,
                                   err_msg=k)
    for k, v in ts[0].v.items():
        assert v.dtype == torch.bfloat16
        assert str(js[0][0].v[k].dtype) == "bfloat16"


def _run_port(param_dtype, sr, toks, tg, steps=40):
    cfg = tgpt.GPTConfig.tiny(param_dtype=param_dtype)
    params, state, step = tspmd.build_training(
        cfg, toptim.adafactor(1e-2), torch.Generator().manual_seed(0),
        device="cpu", stochastic_round=sr)
    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state, (toks, tg))
        losses.append(float(loss))
    assert all(p.dtype == param_dtype for p in params.values())
    return losses


def test_bf16_sr_training_tracks_fp32():
    toks, tg = map(torch.from_numpy, _tokens(256))
    f = _run_port(torch.float32, False, toks, tg)
    s = _run_port(torch.bfloat16, True, toks, tg)
    assert s[-1] < s[0] - 0.5
    assert abs(s[-1] - f[-1]) < 0.1
