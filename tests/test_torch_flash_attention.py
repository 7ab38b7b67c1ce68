"""PyTorch port vs the JAX package: flash attention, forward and backward.

Mirrors tests/test_ops_attention.py. The same seeded numpy inputs go
through the JAX ``flash_attention`` (its Pallas kernels in interpret
mode on the CPU, as the JAX tests run them) and the port's
``flash_attention``, which on CPU tensors runs the kernels' plain
versions; every test asserts that the three kernel launch counters stay
0. fp32 forward within 2e-5 and gradients within 5e-5, the JAX tests'
own tolerances. bf16 by the rule the card checks use: both sides round
every probability and the output to bf16 (unit roundoff u = 2^-8), so
|o - o_jax| <= 8e-3 (|o_jax| + S) with S the attention of |V| in fp32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.ops import attention as jattn
from ray_tpu_torch.ops import attention as tattn

BF16_REL = 8e-3


@pytest.fixture(autouse=True)
def counters():
    tattn.reset_launch_counts()
    yield
    assert (tattn.flash_fwd.launches, tattn.flash_dq.launches,
            tattn.flash_dkv.launches) == (0, 0, 0)


def _arrays(B=2, S=192, T=None, H=3, K=32, seed=0):
    T = S if T is None else T
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, n, H, K)).astype(np.float32)
            for n in (S, T, T)]


def _jax(arrs, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrs]


def _torch(arrs, dtype=torch.float32, grad=False):
    return [torch.from_numpy(a).to(dtype).requires_grad_(grad) for a in arrs]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_jax(causal):
    arrs = _arrays()
    o_j, lse_j = jattn.flash_attention(*_jax(arrs), causal=causal,
                                       return_lse=True)
    o_t, lse_t = tattn.flash_attention(*_torch(arrs), causal=causal,
                                       return_lse=True)
    assert lse_t.shape == (2, 192, 3) and lse_t.dtype == torch.float32
    np.testing.assert_allclose(_np(o_t), _np(o_j), atol=2e-5)
    np.testing.assert_allclose(_np(lse_t), _np(lse_j), atol=2e-5)


@pytest.mark.parametrize("S,T", [(77, 130), (64, 256), (130, 77)])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_unpadded_and_cross_shapes(S, T, causal):
    """S and T off the JAX block sizes, and S != T (the mask is aligned at
    the top left)."""
    arrs = _arrays(S=S, T=T, seed=1)
    o_j, lse_j = jattn.flash_attention(*_jax(arrs), causal=causal,
                                       return_lse=True)
    o_t, lse_t = tattn.flash_attention(*_torch(arrs), causal=causal,
                                       return_lse=True)
    np.testing.assert_allclose(_np(o_t), _np(o_j), atol=2e-5)
    np.testing.assert_allclose(_np(lse_t), _np(lse_j), atol=2e-5)
    ref = tattn.reference_attention(*_torch(arrs), causal=causal)
    np.testing.assert_allclose(_np(o_t), _np(ref), atol=2e-5)


def _grads(module, causal, arrs, with_lse):
    def f(q, k, v):
        if with_lse:
            o, lse = module.flash_attention(q, k, v, causal=causal,
                                            return_lse=True)
            return (o.sum() + jnp.sin(lse).sum() if module is jattn
                    else o.sum() + torch.sin(lse).sum())
        o = module.flash_attention(q, k, v, causal=causal)
        return (jnp.sum(o * jnp.cos(o)) if module is jattn
                else (o * torch.cos(o)).sum())

    if module is jattn:
        return jax.grad(f, argnums=(0, 1, 2))(*_jax(arrs))
    ts = _torch(arrs, grad=True)
    f(*ts).backward()
    return [t.grad for t in ts]


@pytest.mark.parametrize("causal", [True, False])
def test_grads_match_jax(causal):
    arrs = _arrays(S=160, seed=2)
    for a, b in zip(_grads(tattn, causal, arrs, False),
                    _grads(jattn, causal, arrs, False)):
        np.testing.assert_allclose(_np(a), _np(b), atol=5e-5)


def test_lse_cotangent():
    """The backward folds the lse cotangent into delta (ring attention
    differentiates through lse)."""
    arrs = _arrays(S=96, seed=3)
    for a, b in zip(_grads(tattn, True, arrs, True),
                    _grads(jattn, True, arrs, True)):
        np.testing.assert_allclose(_np(a), _np(b), atol=5e-5)


def test_lse_only_and_unused_lse():
    """A caller may use only lse (do arrives as None) or only o (dlse
    arrives as None); both match the plain attention's gradients."""
    arrs = _arrays(S=64, seed=4)
    for use in ("o", "lse"):
        grads = {}
        for name, fn in (("flash", tattn.flash_attention),
                         ("plain", tattn.reference_attention)):
            ts = _torch(arrs, grad=True)
            o, lse = fn(*ts, causal=True, return_lse=True)
            (o.square().sum() if use == "o" else lse.exp().sum()).backward()
            grads[name] = [torch.zeros_like(t) if t.grad is None else t.grad
                           for t in ts]        # lse does not depend on v
        for a, b in zip(grads["flash"], grads["plain"]):
            np.testing.assert_allclose(_np(a), _np(b), atol=5e-5)


def test_reference_bwd_matches_jax_bwd_impl():
    """reference_flash_bwd against JAX's _bwd_impl on the same
    (o, lse, dO, dlse): the plain twin of the dq and dkv kernels."""
    B, S, H, K = 2, 96, 3, 32
    arrs = _arrays(B=B, S=S, H=H, K=K, seed=5)
    rng = np.random.default_rng(6)
    do = rng.normal(size=(B, S, H, K)).astype(np.float32)
    dlse = rng.normal(size=(B, S, H)).astype(np.float32)
    q, k, v = _jax(arrs)
    o, lse = jattn.flash_attention(q, k, v, causal=True, return_lse=True)
    sw = lambda x: jnp.swapaxes(x, 1, 2)
    scale = 1.0 / np.sqrt(K)
    ref = jattn._bwd_impl(sw(q), sw(k), sw(v), sw(o), sw(lse), sw(do),
                          sw(dlse), True, scale, 512, 512, True)
    tq, tk, tv = _torch(arrs)
    to, tlse = torch.tensor(_np(o)), torch.tensor(_np(lse))
    out = tattn.reference_flash_bwd(
        tq, tk, tv, to, tlse, torch.from_numpy(do), torch.from_numpy(dlse),
        True, scale)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(_np(a), _np(sw(b)), atol=5e-5)
    # The dispatching wrappers take the same plain versions on the CPU.
    via = tattn.flash_bwd(tq, tk, tv, to, tlse, torch.from_numpy(do),
                          torch.from_numpy(dlse), True, scale)
    for a, b in zip(via, out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_bf16_io():
    arrs = _arrays(seed=7)
    o_j = jattn.flash_attention(*_jax(arrs, jnp.bfloat16), causal=True)
    o_t = tattn.flash_attention(*_torch(arrs, torch.bfloat16), causal=True)
    assert o_t.dtype == torch.bfloat16
    q, k, v = _torch(arrs)
    s_abs, _ = tattn.reference_flash_fwd(q, k, v.abs(), True)
    ref = _np(o_j)
    share = np.abs(_np(o_t) - ref) / (BF16_REL * (np.abs(ref) + _np(s_abs)))
    assert float(share.max()) <= 1.0, float(share.max())


def test_rows_with_no_visible_key():
    """With T = 0 every row is empty: o = 0 and lse = -1e30, said
    explicitly (a softmax would give the mean of V), and dq = 0."""
    q = torch.randn(1, 5, 2, 32, requires_grad=True)
    kv = torch.zeros(1, 0, 2, 32, requires_grad=True)
    o, lse = tattn.flash_attention(q, kv, kv, causal=False, return_lse=True)
    assert torch.all(o == 0) and torch.all(lse == tattn.NEG_INF)
    o.sum().backward()
    assert torch.all(q.grad == 0)


def test_dispatch_is_by_device():
    """A CPU tensor takes the plain version (no launch); a tensor on any
    other non-CUDA device is refused, never computed by the plain path."""
    arrs = _arrays(S=32, seed=8)
    q, k, v = _torch(arrs)
    o, lse = tattn.flash_fwd(q, k, v, True)
    o2, lse2 = tattn.reference_flash_fwd(q, k, v, True)
    torch.testing.assert_close(o, o2, rtol=0, atol=0)
    torch.testing.assert_close(lse, lse2, rtol=0, atol=0)
    meta = [t.to("meta") for t in (q, k, v)]
    with pytest.raises(ValueError, match="unsupported device"):
        tattn.flash_fwd(*meta)
    with pytest.raises(ValueError, match="flash attention takes"):
        tattn.flash_attention(q, k[:, :, :1], v)
