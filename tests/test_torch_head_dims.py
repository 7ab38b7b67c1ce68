"""PyTorch port vs the JAX package at head dims 80 and 256.

gpt2_2_7b's heads are 80 wide and gptj_6b's 256; the port's CUDA kernels
take both, and on the CPU every wrapper takes its plain version at any
head dim. These tests run a tiny untied model at each of the two head
dims end to end: the serving engine (paged, chunked prefill,
``attn_impl="kernel"`` on the port, so the kernel wrappers' plain
versions, against the JAX engine's gather path) with greedy streams that
must be identical, and three build_training steps with
``attn_impl="flash"`` against the JAX flash step (its Pallas kernels in
interpret mode). Every kernel launch counter
stays 0. Tolerances as in tests/test_torch_train.py.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import gpt as jgpt
from ray_tpu.parallel.mesh import MeshConfig, make_mesh
from ray_tpu.serve.llm import LLMEngine as JaxEngine
from ray_tpu.train import spmd as jspmd
from ray_tpu_torch._bridge import params_from_jax
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import paged_attention as tpa
from ray_tpu_torch.serve.llm import LLMEngine
from ray_tpu_torch.train import optim as toptim
from ray_tpu_torch.train import spmd as tspmd

# d_model, n_heads → head dim 80 (gpt2_2_7b's) and 256 (gptj_6b's).
WIDTHS = {80: (160, 2), 256: (512, 2)}


@pytest.fixture(autouse=True)
def counters():
    tpa.reset_launch_counts()
    tattn.reset_launch_counts()
    yield
    for fn in (tpa.paged_attention, tpa.paged_prefill_attention):
        assert (fn.launches, fn.int8_launches) == (0, 0)
    assert (tattn.flash_fwd.launches, tattn.flash_dq.launches,
            tattn.flash_dkv.launches) == (0, 0, 0)


def _configs(K, **kw):
    d, h = WIDTHS[K]
    jcfg = jgpt.GPTConfig.tiny_untied(d_model=d, n_heads=h, dtype=jnp.float32,
                                      **kw)
    tcfg = tgpt.GPTConfig.tiny_untied(d_model=d, n_heads=h,
                                      dtype=torch.float32, **kw)
    assert jcfg.head_dim == tcfg.head_dim == K
    return jcfg, tcfg


def _drive(eng, reqs, max_steps=800):
    for _ in range(max_steps):
        if all(r.done.is_set() for r in reqs):
            break
        eng.step()
    assert all(r.done.is_set() for r in reqs)
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    return [r.out_ids for r in reqs]


@pytest.mark.parametrize("K", [80, 256])
def test_engine_streams_match_jax_at_head_dim(K):
    """Paged chunked engines (page 16, chunk 16, budget 32) on the same
    fp32 weights: the port on its kernel path (the plain versions of both
    paged wrappers on the CPU) against the JAX engine's gather path, six
    ragged prompts, 8 greedy tokens each. The streams are identical and
    the port's page accounting closes."""
    jcfg, tcfg = _configs(K)
    jp = jgpt.init_params(jcfg, jax.random.key(40 + K))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tcfg,
                         device="cpu")
    rng = np.random.default_rng(K)
    prompts = [list(map(int, rng.integers(1, tcfg.vocab_size, n)))
               for n in (3, 17, 33, 50, 7, 40)]
    knobs = dict(n_slots=4, max_len=128, kv_mode="paged", page_size=16,
                 prefill_chunk=16, prefill_token_budget=32)
    jeng = JaxEngine(jcfg, jp, attn_impl="gather", **knobs)
    teng = LLMEngine(tcfg, tp, attn_impl="kernel", device="cpu", **knobs)
    jout = _drive(jeng, [jeng.submit(p, max_tokens=8) for p in prompts])
    tout = _drive(teng, [teng.submit(p, max_tokens=8) for p in prompts])
    assert tout == jout
    acc = teng.page_accounting()
    assert acc["closure"] and acc["refs_consistent"]
    assert acc["free"] == acc["total"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# Head dim 256's model is d 512: at lr 1e-2 its loss rises from the second
# step to the third (4.41 → 8.53), a regime that grows fp32 reassociation
# noise past the Adam rule's 0.1% (2% of wq by the third step); at 3e-3 it
# falls, as the 80 case's does at 1e-2.
@pytest.mark.parametrize("K,lr", [(80, 1e-2), (256, 3e-3)])
def test_flash_train_steps_match_jax_at_head_dim_80(K, lr):
    """Three steps of build_training with attn_impl="flash" at head dims
    80 and 256 against JAX's spmd.build_training on a one-device mesh,
    from the same parameters and batch: the losses within 1e-5 relative,
    and each leaf's elements within 2e-5 but for 0.1% of them, every one
    within the steps taken (tests/test_torch_train.py's rule for Adam)."""
    jcfg, tcfg = _configs(K, attn_impl="flash")
    mesh = make_mesh(MeshConfig(dp=1, fsdp=1, sp=1, tp=1),
                     devices=jax.devices()[:1])
    jp, js, jstep = jspmd.build_training(
        jcfg, mesh, optax.adamw(lr, weight_decay=0.1), jax.random.key(8))
    tp, ts, tstep = tspmd.build_training(
        tcfg, toptim.adamw(lr, weight_decay=0.1), device="cpu")
    with torch.no_grad():
        for k, v in params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                                    tcfg, device="cpu").items():
            tp[k].copy_(v)
    toks = np.random.default_rng(9).integers(0, jcfg.vocab_size, (2, 32))
    tg = np.roll(toks, -1, axis=1)
    jb = (jnp.asarray(toks, jnp.int32), jnp.asarray(tg, jnp.int32))
    tb = (torch.from_numpy(toks), torch.from_numpy(tg))
    losses = []
    for _ in range(3):
        jp, js, jl = jstep(jp, js, jb)
        tp, ts, tl = tstep(tp, ts, tb)
        losses.append(float(tl))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        for k in jp:
            diff = np.abs(_np(tp[k]) - _np(jp[k]))
            assert float(np.mean(diff > 2e-5)) <= 1e-3, k
            assert float(diff.max()) <= 3 * 2 * lr, k
    assert losses[-1] < losses[0]
