"""PyTorch port vs optax: Adafactor (``ray_tpu_torch.train.optim.adafactor``
against ``optax.adafactor``, the JAX package's ``BENCH_OPT=adafactor``
and ``adafactor_sr`` optimizer).

Five steps on the same seeded fp32 gradients, from the same parameters,
with ``multiply_by_parameter_scale`` on and off, fp32 and bf16
parameters (bf16 with fp32 gradients, as the bf16-master step feeds
them). The leaves: stacked and factored ([2, 256, 384], [2, 160, 4, 128],
whose factored pair (128, 160) is not its last two dims), unfactored
([64], [2, 64]; every dim of the `tiny` models is under 128, so they
factor nothing) and tied dims that ``np.argsort`` decides ([256, 256],
[3, 200, 200]). optax's update runs jitted, as the train step runs it.

Tolerances. fp32: each step's update within 2e-6 of the leaf's largest
update, the parameters within 1e-7 and the moments within 1e-6 relative
(the port walks stacked leaves by layer slice, which changes only the
order of the fp32 sums of the two block RMS values and of the moments'
means). bf16: the moments are computed in fp32 and stored in bf16, equal
within one bf16 ulp (2^-7 relative); each update element within two bf16
ulps (2 x 2^-7 relative) plus 1e-6 of the leaf's largest update, since
the row and column factors are bf16 values whose last bit depends on
the backend's rsqrt and on XLA's fused excess precision; the bf16
parameters within 2^-6 relative (flipped roundings of p + u) plus the
sum over the steps taken of two bf16 ulps of the leaf's largest update.
"""

import numpy as np
import optax
import pytest
import torch
from optax._src.factorized import _factored_dims as optax_factored_dims

import jax
import jax.numpy as jnp

from ray_tpu_torch.train import optim as toptim

SHAPES = {"stacked": (2, 256, 384), "stacked4": (2, 160, 4, 128),
          "vec": (64,), "small": (2, 64), "tied": (256, 256),
          "tied3": (3, 200, 200)}
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
LR = 1e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _whole(u, shape):
    """A port update as one fp32 array (its slices put together)."""
    out = torch.empty(shape)
    for i, us in toptim.update_slices(u):
        out[i] = us
    return out


def test_factored_dims_match_optax():
    for shape in list(SHAPES.values()) + [(32, 4096, 14336), (128256, 4096),
                                          (32, 4096, 8, 128), (32, 4096)]:
        assert toptim._factored_dims(shape, 128) == optax_factored_dims(
            shape, True, 128), shape
    assert toptim._factored_dims((2, 160, 4, 128), 128) == (3, 1)


@pytest.mark.parametrize("scale", [True, False])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_adafactor_matches_optax(dt, scale):
    jd, td = DTYPES[dt]
    rng = np.random.default_rng(0)
    p0 = {k: (rng.normal(size=s) * 0.02).astype(np.float32)
          for k, s in SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * 1e-2).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(5)]

    jp = {k: jnp.asarray(v, jd) for k, v in p0.items()}
    tp = {k: torch.from_numpy(_np(jp[k]).copy()).to(td) for k in p0}
    jopt = optax.adafactor(LR, multiply_by_parameter_scale=scale)
    topt = toptim.adafactor(LR, multiply_by_parameter_scale=scale)
    js, ts = jopt.init(jp), topt.init(tp)
    jupdate = jax.jit(jopt.update)
    drift = dict.fromkeys(SHAPES, 0.0)     # bf16: the updates' allowance
    for g in grads:
        ju, js = jupdate({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             ts, tp)
        whole = {k: _whole(u, SHAPES[k]) for k, u in tu.items()}
        toptim.apply_updates(tp, whole)
        for k in SHAPES:
            want, got = _np(ju[k]), whole[k].numpy()
            big = float(np.abs(want).max())
            if dt == "fp32":
                assert np.abs(got - want).max() <= 2e-6 * big, k
                np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), rtol=0,
                                           atol=1e-7, err_msg=k)
            else:
                np.testing.assert_allclose(got, want, rtol=2 * 2**-7,
                                           atol=1e-6 * big, err_msg=k)
                drift[k] += 2 * 2**-7 * big
                np.testing.assert_allclose(_np(tp[k]), _np(jp[k]),
                                           rtol=2**-6, atol=drift[k],
                                           err_msg=k)
            assert tp[k].dtype == td
    assert ts.count == int(js[0].count) == 5
    rtol = 1e-6 if dt == "fp32" else 2**-7
    for name in ("v_row", "v_col", "v"):
        for k in SHAPES:
            jv, tv = getattr(js[0], name)[k], getattr(ts, name)[k]
            assert tv.dtype == td and jv.dtype == jd, (name, k)
            assert tuple(tv.shape) == tuple(jv.shape), (name, k)
            np.testing.assert_allclose(_np(tv), _np(jv), rtol=rtol,
                                       atol=0, err_msg=f"{name} {k}")


def test_lazy_updates_change_the_moments_when_consumed():
    """A leaf's moments update when its update is first iterated, and a
    stacked leaf's update comes out one layer slice at a time."""
    p = {"w": torch.zeros(3, 200, 200)}
    opt = toptim.adafactor(LR)
    state = opt.init(p)
    updates, state = opt.update({"w": torch.ones(3, 200, 200)}, state, p)
    assert state.count == 1 and not state.v_row["w"].any()
    slices = list(updates["w"])
    assert [i for i, _ in slices] == [0, 1, 2]
    assert all(tuple(u.shape) == (200, 200) for _, u in slices)
    assert state.v_row["w"].any()
