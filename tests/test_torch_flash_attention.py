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
Head dims 80 and 256 (gpt2_2_7b's and gptj_6b's, which the CUDA kernels
take beside 64 and 128; the backward kernels at 80) are held the same
way.
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
    assert (tattn.flash_fwd.launches, tattn.flash_delta.launches,
            tattn.flash_dq.launches, tattn.flash_dkv.launches) == (0, 0, 0, 0)


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


def _bwd_impl_case(B, S, H, K, seed):
    """reference_flash_bwd against JAX's _bwd_impl (interpret mode) on the
    same (o, lse, dO, dlse), and flash_bwd's dispatch to the same plain
    versions on CPU tensors."""
    arrs = _arrays(B=B, S=S, H=H, K=K, seed=seed)
    rng = np.random.default_rng(seed + 1)
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


def test_reference_bwd_matches_jax_bwd_impl():
    """reference_flash_bwd against JAX's _bwd_impl on the same
    (o, lse, dO, dlse): the plain twin of the delta, dq and dkv
    kernels."""
    _bwd_impl_case(2, 96, 3, 32, 5)


def test_flash_bwd_matches_jax_bwd_impl_at_head_dim_256():
    """The same at gptj_6b's head dim, where the bf16 kernels walk other
    tiles (dq 64-key tiles in single K or V slots, dkv's warpgroups
    splitting the walked rows): the plain versions they are held to on
    the card still compute JAX's backward."""
    _bwd_impl_case(1, 96, 2, 256, 55)


def _jax_delta(o, do, dlse):
    """The JAX package's delta (ray_tpu/ops/attention.py `_bwd_impl`),
    by jnp on the same arrays."""
    delta = jnp.sum(jnp.asarray(do).astype(jnp.float32)
                    * jnp.asarray(o).astype(jnp.float32), axis=-1)
    if dlse is not None:
        delta = delta - jnp.asarray(dlse).astype(jnp.float32)
    return np.asarray(delta)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("K", [64, 80, 128, 256])
def test_reference_delta_matches_jax_delta(K, dtype):
    """reference_flash_delta (the delta kernel's plain version) against
    the JAX package's delta formula on the same numpy-seeded o, dO and
    dlse, with and without dlse: within 1e-6 of each row's sum of
    magnitudes, fp32 sums reassociated (bf16 inputs are widened exactly
    on both sides)."""
    rng = np.random.default_rng(60 + K)
    o, do = (rng.normal(size=(2, 33, 3, K)).astype(np.float32)
             for _ in range(2))
    dlse = rng.normal(size=(2, 33, 3)).astype(np.float32)
    if dtype == "bfloat16":    # the values bf16 holds, kept in fp32
        o, do = (torch.from_numpy(x).to(torch.bfloat16).float().numpy()
                 for x in (o, do))
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    for dl in (dlse, None):
        got = tattn.reference_flash_delta(
            torch.from_numpy(o).to(tdt), torch.from_numpy(do).to(tdt),
            None if dl is None else torch.from_numpy(dl))
        assert got.dtype == torch.float32 and got.is_contiguous()
        want = _jax_delta(o, do, dl)
        bound = 1e-6 * (np.abs(o * do).sum(-1)
                        + (0 if dl is None else np.abs(dl)))
        assert np.all(np.abs(got.numpy() - want) <= bound)


def test_flash_delta_takes_the_plain_version_on_cpu():
    """flash_delta on CPU tensors is its plain version bit for bit (the
    launch counter stays 0, as the fixture checks), on a strided dO, with
    and without dlse, and on fp32 o beside bf16 dO (head dim 256's
    training path); shapes it cannot take are refused."""
    rng = np.random.default_rng(70)
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(
        np.float32))
    o32, dlse = t(2, 40, 3, 256), t(2, 40, 3)
    do = t(2, 40, 2, 3, 256).to(torch.bfloat16)[:, :, 1]   # strided rows
    for o in (o32, o32.to(torch.bfloat16)):
        for dl in (dlse, None):
            torch.testing.assert_close(
                tattn.flash_delta(o, do, dl),
                tattn.reference_flash_delta(o, do, dl), rtol=0, atol=0)
    with pytest.raises(ValueError, match="flash_delta takes o and dO"):
        tattn.flash_delta(o32, do[:, :8])


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


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("K", [80, 256])
def test_head_dims_80_and_256_match_jax(K, causal):
    """Forward (o and lse) and the three gradients at head dims 80 and
    256, fp32, S and T off the block sizes: the plain versions against
    the JAX kernels in interpret mode at the fp32 tolerances above."""
    arrs = _arrays(B=1, S=130, T=130, H=2, K=K, seed=10 + K)
    o_j, lse_j = jattn.flash_attention(*_jax(arrs), causal=causal,
                                       return_lse=True)
    o_t, lse_t = tattn.flash_attention(*_torch(arrs), causal=causal,
                                       return_lse=True)
    assert o_t.shape == (1, 130, 2, K)
    np.testing.assert_allclose(_np(o_t), _np(o_j), atol=2e-5)
    np.testing.assert_allclose(_np(lse_t), _np(lse_j), atol=2e-5)
    for a, b in zip(_grads(tattn, causal, arrs, True),
                    _grads(jattn, causal, arrs, True)):
        np.testing.assert_allclose(_np(a), _np(b), atol=5e-5)


@pytest.mark.parametrize("K", [80, 256])
def test_head_dims_80_and_256_bf16_forward(K):
    """bf16 at head dims 80 and 256 under the bf16 rule above."""
    arrs = _arrays(B=1, S=160, H=2, K=K, seed=20 + K)
    o_j = jattn.flash_attention(*_jax(arrs, jnp.bfloat16), causal=True)
    o_t = tattn.flash_attention(*_torch(arrs, torch.bfloat16), causal=True)
    assert o_t.dtype == torch.bfloat16
    q, k, v = _torch(arrs)
    s_abs, _ = tattn.reference_flash_fwd(q, k, v.abs(), True)
    ref = _np(o_j)
    share = np.abs(_np(o_t) - ref) / (BF16_REL * (np.abs(ref) + _np(s_abs)))
    assert float(share.max()) <= 1.0, float(share.max())


def _bf16_grad_sums(arrs, causal, dout, dlse):
    """S of the bf16 rule for dq, dk and dv (chip_smoke.py derives it): W
    |K|, W^T |Q| and p^T |dO| with W = p (|dP| + |delta|) sm_scale >= |ds|,
    from the fp32 plain forward of the same inputs."""
    q, k, v = _torch(arrs)
    scale = 1.0 / np.sqrt(q.shape[-1])
    o, lse = tattn.reference_flash_fwd(q, k, v, causal, scale)
    do = torch.from_numpy(dout)
    delta = tattn.flash_delta(o, do, torch.from_numpy(dlse))
    p, _ds = tattn._p_ds(q, k, v, do, lse, delta, causal, scale)
    dp = torch.einsum("bshk,bthk->bhst", do, v)
    w = p * (dp.abs() + delta.transpose(1, 2)[..., None].abs()) * scale
    return (torch.einsum("bhst,bthk->bshk", w, k.abs()),
            torch.einsum("bhst,bshk->bthk", w, q.abs()),
            torch.einsum("bhst,bshk->bthk", p, do.abs()))


@pytest.mark.parametrize("K", [80, 256])
def test_head_dims_80_and_256_bf16_backward(K):
    """bf16 dq, dk and dv at head dims 80 and 256 (the backward kernels'
    plain versions) against JAX's flash_attention in interpret mode, with
    an o and an lse cotangent, under the bf16 rule above with S the
    gradient's own sum of magnitudes: both sides round ds and p to bf16
    before their products and each gradient once at the end."""
    arrs = _arrays(B=1, S=160, H=2, K=K, seed=30 + K)
    rng = np.random.default_rng(40 + K)
    dout = rng.normal(size=arrs[0].shape).astype(np.float32)
    dlse = rng.normal(size=arrs[0].shape[:3]).astype(np.float32)

    def jloss(q, k, v):
        o, lse = jattn.flash_attention(q, k, v, causal=True, return_lse=True)
        return (jnp.sum(o.astype(jnp.float32) * dout)
                + jnp.sum(lse * dlse))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*_jax(arrs, jnp.bfloat16))
    ts = _torch(arrs, torch.bfloat16, grad=True)
    o, lse = tattn.flash_attention(*ts, causal=True, return_lse=True)
    ((o.float() * torch.from_numpy(dout)).sum()
     + (lse * torch.from_numpy(dlse)).sum()).backward()
    for t, g, s_abs in zip(ts, jg, _bf16_grad_sums(arrs, True, dout, dlse)):
        assert t.grad.dtype == torch.bfloat16
        ref = _np(g)
        share = (np.abs(_np(t.grad) - ref)
                 / (BF16_REL * (np.abs(ref) + _np(s_abs))))
        assert float(share.max()) <= 1.0, float(share.max())


@pytest.mark.parametrize("K", [64, 256])
def test_backward_reads_the_unrounded_o_at_head_dim_256(K):
    """bf16: at head dim 256 the autograd backward's delta = rowsum(dO · O)
    reads O before its rounding (flash_fwd's o32); at the other head dims
    it reads the rounded O, as the JAX VJP does. The gradients are
    reference_flash_bwd's from that O, bit for bit, and the two Os give
    different dq."""
    arrs = _arrays(B=1, S=96, H=2, K=K, seed=50)
    q, k, v = _torch(arrs, torch.bfloat16, grad=True)
    do = torch.from_numpy(np.random.default_rng(51).normal(
        size=arrs[0].shape).astype(np.float32)).to(torch.bfloat16)
    o = tattn.flash_attention(q, k, v, causal=True)
    o.backward(do)
    qd, kd, vd = (x.detach() for x in (q, k, v))
    o_r, lse, o32 = tattn.reference_flash_fwd(qd, kd, vd, True,
                                              with_o32=True)
    assert o32.dtype == torch.float32
    assert torch.equal(o_r, o32.to(torch.bfloat16))
    assert torch.equal(o.detach(), o_r)
    assert (K in tattn.O32_HEAD_DIMS) == (K == 256)
    unrounded = tattn.reference_flash_bwd(qd, kd, vd, o32, lse, do, None,
                                          True)
    rounded = tattn.reference_flash_bwd(qd, kd, vd, o_r, lse, do, None, True)
    want = unrounded if K == 256 else rounded
    for g, w in zip((q.grad, k.grad, v.grad), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert not torch.equal(unrounded[0], rounded[0])
