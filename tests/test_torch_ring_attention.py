"""PyTorch port vs the JAX package: ring attention (sequence parallelism).

Mirrors tests/test_ring_attention.py. The JAX ring runs on an sp=4
mesh of the forced host devices (its flash impl in interpret mode); the
port's ring runs every shard on the CPU (a mesh of four ``cpu``
devices), where the flash impl takes the kernels' plain versions and
every test asserts that no kernel launched.

Tolerances: outputs within 3e-5 and gradients within 5e-5 absolute
(fp32; the JAX test's own bounds against full attention); the GPT loss
through the ring within 1e-4 relative of the JAX loss (the JAX test's
bound between its ring and plain losses); after one adamw step of lr
1e-3, all but 0.1% of each leaf's elements within 2e-6 and every element
within 2 lr (tests/test_torch_train.py's rule: Adam divides a gradient
element by its own root second moment, so one within fp32 noise of zero
moves anywhere in about ±lr).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import gpt as jgpt
from ray_tpu.ops.attention import reference_attention as jref
from ray_tpu.parallel.mesh import MeshConfig, make_mesh
from ray_tpu.parallel.ring import ring_attention_sharded as jring
from ray_tpu.train import spmd as jspmd
from ray_tpu_torch._bridge import params_from_jax
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.parallel import ring as tring
from ray_tpu_torch.train import optim as toptim
from ray_tpu_torch.train import spmd as tspmd

CPU4 = [torch.device("cpu")] * 4
OUT_ATOL, GRAD_ATOL = 3e-5, 5e-5


@pytest.fixture(autouse=True)
def counters():
    tattn.reset_launch_counts()
    yield
    assert (tattn.flash_fwd.launches, tattn.flash_dq.launches,
            tattn.flash_dkv.launches) == (0, 0, 0)


@pytest.fixture(scope="module")
def sp_mesh(cpu_devices):
    return make_mesh(MeshConfig(dp=2, fsdp=1, sp=4, tp=1))


def _qkv(B=4, S=256, H=2, K=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, H, K)).astype(np.float32)
            for _ in range(3)]


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _port(q, k, v, **kw):
    return tring.ring_attention_sharded(*_t(q, k, v), CPU4, **kw).numpy()


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_jax_ring(sp_mesh, impl, causal):
    q, k, v = _qkv()
    want = np.asarray(jax.jit(lambda a, b, c: jring(
        a, b, c, sp_mesh, causal=causal, impl=impl))(q, k, v))
    got = _port(q, k, v, causal=causal, impl=impl)
    np.testing.assert_allclose(got, want, atol=OUT_ATOL)
    full = np.asarray(jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal))
    np.testing.assert_allclose(got, full, atol=OUT_ATOL)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_ring_grads_match_jax(sp_mesh, impl):
    q, k, v = _qkv()

    def f(q, k, v):
        o = jring(q, k, v, sp_mesh, causal=True, impl=impl)
        return jnp.sum(o * jnp.cos(o))

    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)
    leaves = [t.requires_grad_(True) for t in _t(q, k, v)]
    o = tring.ring_attention_sharded(*leaves, CPU4, causal=True, impl=impl)
    got = torch.autograd.grad((o * torch.cos(o)).sum(), leaves)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL)


def _dropping_combine(real, drop):
    """A planted fault: `_combine` calls whose index is in ``drop`` keep
    the running (o, lse) and lose the chunk they were given."""
    calls = []

    def combine(o1, lse1, o2, lse2):
        calls.append(None)
        if len(calls) - 1 in drop:
            return o1, lse1
        return real(o1, lse1, o2, lse2)

    return combine


@pytest.mark.parametrize("fault,drop", [
    ("one rotation dropped", {0}),
    ("src < i taken as skipped", set(range(6))),
])
def test_planted_ring_faults_fail(sp_mesh, monkeypatch, fault, drop):
    q, k, v = _qkv()
    want = np.asarray(jax.jit(lambda a, b, c: jring(
        a, b, c, sp_mesh, causal=True, impl="xla"))(q, k, v))
    monkeypatch.setattr(tring, "_combine",
                        _dropping_combine(tring._combine, drop))
    got = _port(q, k, v, causal=True, impl="xla")
    assert np.abs(got - want).max() > 100 * OUT_ATOL, fault


def test_masked_steps_are_skipped_and_exact(monkeypatch):
    """Causal sp=4: 4 diagonal + 6 full chunk attentions, no launch for
    the 6 masked steps; merging the reference's masked result (0, -1e30)
    leaves (o, lse) bit for bit."""
    q, k, v = _t(*_qkv())
    calls = []
    real = tattn.flash_attention

    def counting(q, k, v, *, causal, **kw):
        calls.append(causal)
        return real(q, k, v, causal=causal, **kw)

    monkeypatch.setattr(tring, "flash_attention", counting)
    tring.ring_attention_sharded(q, k, v, CPU4, causal=True, impl="flash")
    assert sorted(calls) == [False] * 6 + [True] * 4
    o, lse = real(q[:, :64], k[:, :64], v[:, :64], causal=True,
                  return_lse=True)
    for dtype in (torch.float32, torch.bfloat16):
        oc, lc = tring._combine(o.to(dtype), lse, torch.zeros_like(
            o, dtype=dtype), torch.full_like(lse, tattn.NEG_INF))
        assert torch.equal(oc, o.to(dtype)) and torch.equal(lc, lse)


def test_sp1_returns_the_held_chunk_and_indivisible_raises():
    q, k, v = _t(*_qkv(S=96))
    o = tring.ring_attention_sharded(q, k, v, [torch.device("cpu")],
                                     causal=True, impl="flash")
    assert torch.equal(o, tattn.flash_attention(q, k, v, causal=True))
    with pytest.raises(ValueError, match="equal chunks"):
        tring.ring_attention_sharded(q, k, v, [torch.device("cpu")] * 5)


def test_make_sp_mesh():
    assert tring.make_sp_mesh(2, devices=["cpu", "cpu", "cpu"]) == CPU4[:2]
    with pytest.raises(ValueError, match="exceeds"):
        tring.make_sp_mesh(2, devices=["cpu"])
    with pytest.raises(ValueError, match="must be >= 1"):
        tring.make_sp_mesh(0, devices=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="exceeds the 0 visible"):
            tring.make_sp_mesh(1)


def test_ring_without_mesh_raises():
    cfg = tgpt.GPTConfig.tiny(attn_impl="ring", dtype=torch.float32)
    params = tgpt.init_params(cfg, device="cpu")
    toks = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(ValueError, match=r"requires forward\(\.\.\., mesh=\)"):
        tgpt.loss_fn(params, toks, toks, cfg)


def _tokens(vocab, B=8, S=128, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S))
    return toks, np.roll(toks, -1, axis=1)


def test_gpt_ring_loss_and_step_match_jax(sp_mesh):
    """GPT tiny with attn_impl="ring": the port's loss equals the JAX
    ring loss and its own plain-attention loss; one adamw step from the
    same parameters equals the JAX step's."""
    jcfg = jgpt.GPTConfig.tiny(attn_impl="ring", dtype=jnp.float32)
    tcfg = tgpt.GPTConfig.tiny(attn_impl="ring", dtype=torch.float32)
    jparams, jstate, jstep = jspmd.build_training(
        jcfg, sp_mesh, optax.adamw(1e-3), jax.random.key(0))
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                              tcfg, device="cpu")
    toks, tg = _tokens(jcfg.vocab_size)
    jt, jg = jnp.asarray(toks, jnp.int32), jnp.asarray(tg, jnp.int32)
    tt, tg_ = torch.from_numpy(toks), torch.from_numpy(tg)

    jloss = float(jgpt.loss_fn(jparams, jt, jg, jcfg, sp_mesh))
    tloss = float(tgpt.loss_fn(tparams, tt, tg_, tcfg, CPU4))
    plain = float(tgpt.loss_fn(tparams, tt, tg_, tgpt.GPTConfig.tiny(
        attn_impl="xla", dtype=torch.float32)))
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    np.testing.assert_allclose(tloss, plain, rtol=1e-4)

    for p in tparams.values():
        p.requires_grad_(True)
    opt = toptim.adamw(1e-3)
    tstate = opt.init(tparams)
    step = tspmd.make_train_step(
        lambda p, a, b: tgpt.loss_fn(p, a, b, tcfg, CPU4), opt)
    tparams, tstate, tl = step(tparams, tstate, (tt, tg_))
    jparams, jstate, jl = jstep(jparams, jstate, (jt, jg))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    for k, v in jparams.items():
        diff = np.abs(tparams[k].detach().numpy() - np.asarray(v))
        assert float(np.mean(diff > 2e-6)) <= 1e-3, k
        assert float(diff.max()) <= 2 * 1e-3, k
