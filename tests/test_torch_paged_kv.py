"""PyTorch port vs the JAX package: the paged serving programs.

`prefill_chunk_paged` (two chunk dispatches per prompt, ragged rows, an
inert row, width-sliced tables) and then `decode_multi_paged` (greedy)
run through ``ray_tpu.models.paged_kv`` and ``ray_tpu_torch.models.
paged_kv`` on the same weights, pool and tables (tiny_untied, fp32).
Logits agree within 1e-4, the written pool pages within 1e-5 (both
sides compute K/V with fp32 matmuls, summed in another order), greedy
tokens exactly. The null page is excluded from the pool comparison:
pad rows write to it in an order neither side defines. Also pins the
fused window's sampler (greedy exact, temperature > 0 to its
distribution) and that the CPU programs launched no kernel.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import gpt as jgpt
from ray_tpu.models import paged_kv as jpk
from ray_tpu_torch._bridge import params_from_jax, pool_from_jax
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import paged_kv as tpk
from ray_tpu_torch.ops import paged_attention as tpa

JCFG = jgpt.GPTConfig.tiny_untied(dtype=jnp.float32)
TCFG = tgpt.GPTConfig.tiny_untied(dtype=torch.float32)
PS = 8
C = 8
N_PAGES = 8


@pytest.fixture(scope="module")
def weights():
    jp = jgpt.init_params(JCFG, jax.random.key(5))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, TCFG,
                         device="cpu")
    return jp, tpk.serving_params(TCFG, tp, device="cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _script():
    """Slot 0: 13-token prompt (chunks of 8 + 5); slot 1: 8 tokens (one
    chunk); slot 2: inert. Then 4 greedy decode steps; slot 2 idles on
    its all-null table."""
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, JCFG.vocab_size, 13).astype(np.int32),
               rng.integers(1, JCFG.vocab_size, 8).astype(np.int32)]
    tables = np.zeros((3, 4), np.int32)
    tables[0, :3] = [1, 2, 3]
    tables[1, :2] = [4, 5]
    d1 = np.zeros((3, C), np.int32)
    d1[0] = prompts[0][:8]
    d1[1] = prompts[1]
    d2 = np.zeros((3, C), np.int32)
    d2[0, :5] = prompts[0][8:]
    return [
        # (tokens, offsets, n_valid, table width)
        (d1, np.array([0, 0, 0], np.int32), np.array([8, 8, 0], np.int32), 1),
        (d2, np.array([8, 8, 0], np.int32), np.array([5, 0, 0], np.int32), 2),
    ], tables, prompts


@pytest.mark.parametrize("jax_impl", ["gather", "kernel"])
def test_prefill_then_greedy_decode_matches_jax(weights, jax_impl):
    jp, tp = weights
    dispatches, tables, prompts = _script()
    jpool = jpk.init_paged_kv(JCFG, N_PAGES, PS)
    tpool = pool_from_jax({k: np.asarray(v) for k, v in jpool.items()}, TCFG,
                          device="cpu")
    tpa.reset_launch_counts()
    finals = []
    for toks, offs, nv, width in dispatches:
        tbl = tables[:, :width]
        jl, jpool = jpk.prefill_chunk_paged(
            JCFG, jp, jnp.asarray(toks), jpool, jnp.asarray(tbl),
            jnp.asarray(offs), jnp.asarray(nv), attn_impl=jax_impl)
        tl, tpool = tpk.prefill_chunk_paged(
            TCFG, tp, _t(toks), tpool, _t(tbl), _t(offs), _t(nv),
            attn_impl="gather")
        assert tl.dtype == torch.float32
        rows = nv > 0
        np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows],
                                   atol=1e-4)
        finals.append(tl.numpy())
    for name in ("k", "v"):
        np.testing.assert_allclose(tpool[name].numpy()[:, 1:],
                                   np.asarray(jpool[name])[:, 1:], atol=1e-5)
    # Graduation: slot 0's last chunk is dispatch 2, slot 1's dispatch 1.
    first = np.array([np.argmax(finals[1][0]), np.argmax(finals[0][1]), 0],
                     np.int32)
    positions = np.array([13, 8, 0], np.int32)
    temps = np.zeros(3, np.float32)
    jout, jpool = jpk.decode_multi_paged(
        JCFG, jp, jnp.asarray(first), jpool, jnp.asarray(positions),
        jnp.asarray(tables), 4, jnp.asarray(temps), jax.random.key(0),
        attn_impl=jax_impl)
    tout, tpool = tpk.decode_multi_paged(
        TCFG, tp, _t(first), tpool, _t(positions), _t(tables), 4, _t(temps),
        torch.Generator().manual_seed(0), attn_impl="kernel")
    assert tout.dtype == torch.int32 and tout.shape == (4, 3)
    np.testing.assert_array_equal(tout.numpy()[:, :2], np.asarray(jout)[:, :2])
    for name in ("k", "v"):
        np.testing.assert_allclose(tpool[name].numpy()[:, 1:],
                                   np.asarray(jpool[name])[:, 1:], atol=1e-5)
    # attn_impl="kernel" on CPU tensors ran the plain versions.
    assert tpa.paged_attention.launches == 0
    assert tpa.paged_prefill_attention.launches == 0


def test_decode_step_logits_match_jax(weights):
    jp, tp = weights
    dispatches, tables, _ = _script()
    jpool = jpk.init_paged_kv(JCFG, N_PAGES, PS)
    tpool = pool_from_jax({k: np.asarray(v) for k, v in jpool.items()}, TCFG,
                          device="cpu")
    toks, offs, nv, width = dispatches[0]
    _, jpool = jpk.prefill_chunk_paged(
        JCFG, jp, jnp.asarray(toks), jpool, jnp.asarray(tables[:, :width]),
        jnp.asarray(offs), jnp.asarray(nv), return_logits=False)
    none, tpool = tpk.prefill_chunk_paged(
        TCFG, tp, _t(toks), tpool, _t(tables[:, :width]), _t(offs), _t(nv),
        return_logits=False)
    assert none is None
    tok = np.array([3, 7, 0], np.int32)
    pos = np.array([8, 8, 0], np.int32)
    jl, _ = jpk.decode_step_paged(JCFG, jp, jnp.asarray(tok), jpool,
                                  jnp.asarray(pos), jnp.asarray(tables))
    tl, _ = tpk.decode_step_paged(TCFG, tp, _t(tok), tpool, _t(pos),
                                  _t(tables))
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], atol=1e-4)


def test_clamped_write_past_table_goes_to_null_page(weights):
    """A pad position past the sliced table width is clamped and routed to
    the null page (torch would raise on the out-of-range index)."""
    _, tp = weights
    pool = tpk.init_paged_kv(TCFG, N_PAGES, PS, device="cpu")
    toks = np.ones((1, C), np.int32)
    tbl = np.array([[1]], np.int32)
    tpk.prefill_chunk_paged(TCFG, tp, _t(toks), pool, _t(tbl),
                            _t(np.array([4], np.int32)),
                            _t(np.array([4], np.int32)))
    written = pool["k"][0].abs().sum(dim=(1, 2, 3))
    assert written[1] > 0 and torch.all(written[2:] == 0)


def test_sample_next_greedy_and_distribution():
    logits = torch.tensor([[0.0, 1.0, 2.0, 0.5], [2.0, 2.0, -1.0, 0.0]])
    gen = torch.Generator().manual_seed(0)
    nxt, _ = tpk._sample_next(logits, torch.zeros(2), gen)
    assert nxt.dtype == torch.int32
    np.testing.assert_array_equal(nxt.numpy(), [2, 0])   # first max on ties
    temps = torch.tensor([0.7, 1.3])
    n = 20000
    draws = torch.stack([tpk._sample_next(logits, temps, gen)[0]
                         for _ in range(n)]).numpy()
    for row in range(2):
        p = torch.softmax(logits[row] / temps[row], -1).numpy()
        freq = np.bincount(draws[:, row], minlength=4) / n
        assert 0.5 * np.abs(freq - p).sum() < 0.03


def test_int8_pool_not_ported():
    with pytest.raises(ValueError, match="not yet ported"):
        tpk.init_paged_kv(TCFG, 4, 8, kv_dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="gather|kernel"):
        tpk.prefill_chunk_paged(TCFG, {}, None, None, None, None, None,
                                attn_impl="flash")
