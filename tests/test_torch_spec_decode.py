"""PyTorch port vs the JAX package: speculative decoding.

- `verify_chunk_paged` (k+1 rows at ragged decode cursors, an inert row,
  the LM head at every position) from the same pool as JAX's: logits
  within 1e-5 + 1e-5 |ref| (fp32 sums in another order), the written
  pages within 1e-5.
- `spec_draft_propose` (k+1 masked draft steps, budgets 4, 2, 0 and an
  inert -1): greedy proposals equal JAX's, the draft pool's pages within
  1e-5; with temperature the first step's softmax rows (same inputs on
  both sides) within 1e-6.
- `spec_accept_tokens`: the same emitted tokens, accepted counts and
  generator state as JAX's on the same numpy generator and inputs,
  greedy (from logits or from a precomputed argmax) and sampled.
- `LLMEngine(spec_draft=...)`: greedy streams equal the JAX
  non-speculative engine's at k 1 and 4, with a draft that agrees and
  one that rejects every proposal, under preemption, with an int8
  draft beside a float target, and with int8 weights and KV against
  JAX's int8 non-speculative engine; with the prefix cache too (warm
  binds share pages the draft reads through the target's tables, and a
  copy-on-write reaches both pools). A temperature-0.8 run completes.
  The page accounting closes.

Tiny configs, ``attn_impl="gather"``, fp32, weights carried over by
`_bridge.params_from_jax`; every paged launch counter stays 0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import gpt as jgpt
from ray_tpu.models import paged_kv as jpk
from ray_tpu.serve.llm import LLMEngine as JaxEngine
from ray_tpu.serve.llm import spec_accept_tokens as jax_accept
from ray_tpu_torch._bridge import params_from_jax, pool_from_jax
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import paged_kv as tpk
from ray_tpu_torch.ops import paged_attention as tpa
from ray_tpu_torch.serve.llm import LLMEngine, spec_accept_tokens

JCFG = jgpt.GPTConfig.tiny(dtype=jnp.float32)
TCFG = tgpt.GPTConfig.tiny(dtype=torch.float32)
# A 1-layer half-width draft with the target's vocab (tests/test_spec_
# decode.py's DRAFT_CFG).
DRAFT = dict(n_layers=1, d_model=32, n_heads=4, d_ff=64)
JDRAFT = jgpt.GPTConfig.tiny(dtype=jnp.float32, **DRAFT)
TDRAFT = tgpt.GPTConfig.tiny(dtype=torch.float32, **DRAFT)
# Program checks: the untied head, a draft of the same shape untied.
JCFG_U = jgpt.GPTConfig.tiny_untied(dtype=jnp.float32)
TCFG_U = tgpt.GPTConfig.tiny_untied(dtype=torch.float32)
JDRAFT_U = jgpt.GPTConfig.tiny_untied(dtype=jnp.float32, **DRAFT)
TDRAFT_U = tgpt.GPTConfig.tiny_untied(dtype=torch.float32, **DRAFT)
FP32_TOL = dict(atol=1e-5, rtol=1e-5)


def _bridge(jp, cfg):
    return params_from_jax({k: np.asarray(v) for k, v in jp.items()}, cfg,
                           device="cpu")


@pytest.fixture(scope="module")
def weights():
    jp = jgpt.init_params(JCFG, jax.random.key(42))
    return jp, _bridge(jp, TCFG)


@pytest.fixture(scope="module")
def draft():
    return _bridge(jgpt.init_params(JDRAFT, jax.random.key(7)), TDRAFT)


@pytest.fixture(autouse=True)
def _no_launches():
    tpa.reset_launch_counts()
    yield
    for fn in (tpa.paged_attention, tpa.paged_prefill_attention):
        assert (fn.launches, fn.int8_launches) == (0, 0)


# ------------------------------------------------------------- programs

PS, WIDTH, B, K_SPEC = 8, 4, 4, 4
LENGTHS = (13, 8, 20, 0)        # written positions per slot; slot 3 inert


def _prefilled(jcfg, tcfg, key):
    """JAX weights from ``key`` and a JAX pool holding each slot's prompt
    (one chunk dispatch of 20), the port's copies of both, the tables."""
    jp = jgpt.init_params(jcfg, jax.random.key(key))
    tp = tpk.serving_params(tcfg, _bridge(jp, tcfg), device="cpu")
    tables = np.zeros((B, WIDTH), np.int32)
    tables[0, :2], tables[1, :2], tables[2, :3] = [3, 1], [7, 2], [4, 9, 5]
    rng = np.random.default_rng(key)
    toks = rng.integers(1, jcfg.vocab_size, (B, 20)).astype(np.int32)
    jpool = jpk.init_paged_kv(jcfg, 12, PS)
    _, jpool = jpk.prefill_chunk_paged(
        jcfg, jp, jnp.asarray(toks), jpool, jnp.asarray(tables),
        jnp.zeros(B, jnp.int32), jnp.asarray(np.array(LENGTHS, np.int32)))
    tpool = pool_from_jax({k: np.asarray(v) for k, v in jpool.items()},
                          tcfg, device="cpu")
    return jp, tp, jpool, tpool, tables


def _pages_close(tpool, jpool):
    """Written pages within 1e-5 (the null page aside: pad rows write it
    in an order neither side defines)."""
    for name in ("k", "v"):
        np.testing.assert_allclose(tpool[name].numpy()[:, 1:],
                                   np.asarray(jpool[name])[:, 1:],
                                   atol=1e-5)


def test_verify_chunk_matches_jax():
    jp, tp, jpool, tpool, tables = _prefilled(JCFG_U, TCFG_U, 5)
    rng = np.random.default_rng(1)
    C = K_SPEC + 1
    toks = rng.integers(1, JCFG_U.vocab_size, (B, C)).astype(np.int32)
    offsets = np.array(LENGTHS, np.int32)
    n_valid = np.array([5, 3, 1, 0], np.int32)
    jl, jpool = jpk.verify_chunk_paged(
        JCFG_U, jp, jnp.asarray(toks), jpool, jnp.asarray(tables),
        jnp.asarray(offsets), jnp.asarray(n_valid))
    tl, out = tpk.verify_chunk_paged(
        TCFG_U, tp, torch.from_numpy(toks), tpool, torch.from_numpy(tables),
        torch.from_numpy(offsets), torch.from_numpy(n_valid))
    assert out is tpool and tl.shape == (B, C, TCFG_U.vocab_size)
    assert tl.dtype == torch.float32
    live = n_valid > 0
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               **FP32_TOL)
    _pages_close(tpool, jpool)


@pytest.mark.parametrize("temp", [0.0, 0.8], ids=["greedy", "sampled"])
def test_spec_draft_propose_matches_jax(temp):
    """Budgets 4, 2, 0 and an inert row; greedy: the proposals of the
    live rows and the draft pool's pages equal JAX's; sampled: the first
    step's probability rows (its inputs are the same on both sides),
    and every row of the stack a distribution."""
    jp, tp, jpool, tpool, tables = _prefilled(JDRAFT_U, TDRAFT_U, 6)
    tokens = np.array([11, 3, 200, 0], np.int32)
    positions = np.array(LENGTHS, np.int32)
    n_prop = np.array([4, 2, 0, -1], np.int32)
    temps = np.full(B, temp, np.float32)
    need = temp > 0
    jt, jprobs, jpool = jpk.spec_draft_propose(
        JDRAFT_U, jp, jnp.asarray(tokens), jpool, jnp.asarray(positions),
        jnp.asarray(tables), jnp.asarray(n_prop), jnp.asarray(temps),
        jax.random.key(0), k=K_SPEC, need_probs=need)
    gen = torch.Generator().manual_seed(0)
    tt, tprobs, out = tpk.spec_draft_propose(
        TDRAFT_U, tp, torch.from_numpy(tokens), tpool,
        torch.from_numpy(positions), torch.from_numpy(tables),
        torch.from_numpy(n_prop), torch.from_numpy(temps), gen, k=K_SPEC,
        need_probs=need)
    assert out is tpool and tt.shape == (K_SPEC, B)
    assert tt.dtype == torch.int32
    live = n_prop >= 0
    if not need:
        assert tprobs is None
        np.testing.assert_array_equal(tt.numpy()[:, live],
                                      np.asarray(jt)[:, live])
        _pages_close(tpool, jpool)
        return
    assert tprobs.shape == (K_SPEC, B, TDRAFT_U.vocab_size)
    np.testing.assert_allclose(tprobs.sum(-1).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(tprobs[0].numpy()[live],
                               np.asarray(jprobs)[0][live], atol=1e-6)


def test_spec_accept_tokens_matches_jax():
    """300 cases over budgets 0..4, temperatures 0 / 0.8 / 1.0, and
    proposals that follow the target's argmax chain, follow it for a
    while, or come from q: the same output and the same generator state
    afterwards as JAX's function."""
    V, k = 16, 4
    for case in range(300):
        rng = np.random.default_rng(case)
        n_prop = case % (k + 1)
        temp = (0.0, 0.8, 1.0)[case % 3]
        logits = (rng.normal(size=(k + 1, V)) * 2).astype(np.float32)
        q = np.exp(rng.normal(size=(k, V)))
        q = (q / q.sum(1, keepdims=True)).astype(np.float32)
        chain = logits.argmax(-1)
        props = np.where(np.arange(k) < rng.integers(0, k + 1), chain[:k],
                         rng.integers(0, V, k))
        if case % 5 == 4:
            props = np.array([rng.choice(V, p=q[i] / q[i].sum())
                              for i in range(k)])
        argmax = chain if case % 2 else None
        gens = [np.random.default_rng(1000 + case) for _ in range(2)]
        got = spec_accept_tokens(gens[0], temp, props, q, logits, n_prop,
                                 verify_argmax=argmax)
        want = jax_accept(gens[1], temp, props, q, logits, n_prop,
                          verify_argmax=argmax)
        assert got == want, case
        assert gens[0].random() == gens[1].random(), case


# --------------------------------------------------------------- engine

def _drive(eng, reqs, max_steps=2000):
    for _ in range(max_steps):
        if all(r.done.is_set() for r in reqs):
            break
        eng.step()
    assert all(r.done.is_set() for r in reqs)
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    return [r.out_ids for r in reqs]


def _closure(eng, *, all_free=True):
    acc = eng.page_accounting()
    assert acc["closure"] and acc["refs_consistent"], acc
    if all_free:
        assert acc["free"] == acc["total"], acc
    return acc


BASE = dict(n_slots=4, max_len=128, page_size=16, prefill_chunk=16,
            prefill_token_budget=32)


def _jax_run(jp, prompts, max_tokens, **kw):
    eng = JaxEngine(JCFG, jp, kv_mode="paged", attn_impl="gather",
                    **{**BASE, **kw})
    return _drive(eng, [eng.submit(p, max_tokens=max_tokens)
                        for p in prompts])


def _spec(tp, prompts, max_tokens, draft_cfg, draft_params, k, **kw):
    eng = LLMEngine(TCFG, tp, kv_mode="paged", attn_impl="gather",
                    device="cpu",
                    spec_draft=draft_cfg, spec_draft_params=draft_params,
                    spec_k=k, **{**BASE, **kw})
    out = _drive(eng, [eng.submit(p, max_tokens=max_tokens)
                       for p in prompts])
    return out, eng


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, TCFG.vocab_size, n)))
            for n in lengths]


@pytest.fixture(scope="module")
def ragged(weights):
    """tests/test_spec_decode.py's ragged prompts and the JAX
    non-speculative engine's greedy streams of 24 tokens."""
    prompts = _prompts(1, (5, 23, 41, 11))
    return prompts, _jax_run(weights[0], prompts, 24)


@pytest.mark.parametrize("arm", ["k1", "k4", "rejecting", "int8_draft"])
def test_greedy_streams_equal_jax_nonspec(weights, draft, ragged, arm):
    """A draft that agrees (k 1 and 4), the target's own weights negated
    (every proposal rejected: rollback every tick), and the draft's
    weights quantized to int8 beside the float target."""
    _, tp = weights
    prompts, ref = ragged
    cfg, params, k = {
        "k1": (TDRAFT, draft, 1), "k4": (TDRAFT, draft, 4),
        "rejecting": (TCFG, {n: -w for n, w in tp.items()}, 4),
        "int8_draft": (TDRAFT, tgpt.quantize_params(draft), 4)}[arm]
    out, eng = _spec(tp, prompts, 24, cfg, params, k)
    assert out == ref
    m = eng.metrics()
    assert m["spec_ticks"] > 0 and m["spec_proposed"] > 0
    assert m["spec_k"] == k and m["spec_draft"] == "custom"
    assert len(m["spec_accept_rate_by_position"]) == k
    if arm == "rejecting":
        assert m["spec_accepted"] == 0
        assert m["spec_accepted_per_step"] == 1.0
    else:
        assert m["spec_accepted_per_step"] > 1.0
    if arm == "int8_draft":
        assert eng.draft_params["wq"].dtype == torch.int8
        assert eng.params["wq"].dtype == torch.float32
    _closure(eng)


def test_greedy_streams_equal_jax_nonspec_under_preemption(weights, draft):
    """Seven pages of four for four requests: speculative growth,
    rollback and preempt-by-recompute."""
    jp, tp = weights
    prompts = [[5, 9, 2], [17, 3], [2, 4, 6], [8, 1, 0]]
    kw = dict(max_len=64, page_size=4, n_pages=7, prefill_chunk=4,
              prefill_token_budget=8)
    ref = _jax_run(jp, prompts, 10, **kw)
    out, eng = _spec(tp, prompts, 10, TDRAFT, draft, 2, **kw)
    assert out == ref
    assert eng.metrics()["preemptions"] > 0
    _closure(eng)


def test_int8_spec_equals_jax_int8_nonspec(weights, draft):
    """int8 weights and KV on both engines (tests/test_quant.py:170): the
    draft is quantized at load beside the target."""
    jp, tp = weights
    prompts = [_prompts(s, (n,))[0] for s, n in ((5, 9), (6, 30), (7, 17))]
    q = dict(weight_dtype="int8", kv_dtype="int8")
    ref = _jax_run(jp, prompts, 16, **q)
    out, eng = _spec(tp, prompts, 16, TDRAFT, draft, 2, **q)
    assert out == ref
    assert eng.draft_params["wq"].dtype == torch.int8
    assert eng.draft_cache["k"].dtype == torch.int8
    assert set(eng.draft_cache) == {"k", "v", "k_scale", "v_scale"}
    _closure(eng)


def test_temperature_run_completes(weights, draft):
    """Temperature 0.8: the sampling branch (draft probabilities, host
    rejection sampling, residual draws) runs to the end with sane counts
    and a closed accounting."""
    _, tp = weights
    eng = LLMEngine(TCFG, tp, kv_mode="paged", attn_impl="gather",
                    device="cpu",
                    spec_draft=TDRAFT, spec_draft_params=draft, spec_k=4,
                    **BASE)
    reqs = [eng.submit(p, max_tokens=12, temperature=0.8)
            for p in _prompts(3, (7, 19, 12))]
    out = _drive(eng, reqs)
    assert all(len(o) == 12 and all(0 <= t < TCFG.vocab_size for t in o)
               for o in out)
    m = eng.metrics()
    assert 0 <= m["spec_accepted"] <= m["spec_proposed"]
    # One token per request comes from its prefill, the rest from spec.
    assert m["spec_emitted"] == m["tokens_generated"] - len(reqs)
    _closure(eng)


def test_warm_binds_with_a_draft(weights, draft):
    """tests/test_spec_decode.py:265 with copy-on-write (chunk 12, pages
    of 8): a cold wave donates, a second wave of other suffixes binds the
    shared 36 positions warm (4 shared pages and a copied tail page),
    both waves equal to JAX's non-speculative streams; entries stay
    cached and the accounting closes."""
    jp, tp = weights
    rng = np.random.default_rng(6)
    shared = list(map(int, rng.integers(1, TCFG.vocab_size, 44)))
    prompts = [shared + list(map(int, rng.integers(1, TCFG.vocab_size, 6)))
               for _ in range(6)]
    kw = dict(page_size=8, prefill_chunk=12, prefill_token_budget=24)
    ref = _jax_run(jp, prompts, 8, **kw)
    eng = LLMEngine(TCFG, tp, kv_mode="paged", attn_impl="gather",
                    device="cpu",
                    spec_draft=TDRAFT, spec_draft_params=draft, spec_k=4,
                    prefix_cache=True, n_pages=48, **{**BASE, **kw})
    for lo in (0, 3):
        reqs = [eng.submit(p, max_tokens=8) for p in prompts[lo:lo + 3]]
        assert _drive(eng, reqs) == ref[lo:lo + 3]
    assert [r.cached_tokens for r in reqs] == [36, 36, 36]
    m = eng.metrics()
    assert m["prefix_hits"] == 3 and m["cow_copies"] == 3
    acc = _closure(eng, all_free=False)
    assert acc["cached"] > 0 and acc["live"] == 0


def test_cow_reaches_the_draft_pool(weights, draft):
    """`_apply_cow` copies each queued pair in the target's pool and in
    the draft's (draft page p mirrors target page p), every plane."""
    _, tp = weights
    eng = LLMEngine(TCFG, tp, kv_mode="paged", attn_impl="gather",
                    device="cpu",
                    spec_draft=TDRAFT, spec_draft_params=draft,
                    prefix_cache=True, kv_dtype="int8", **BASE)
    gen = torch.Generator().manual_seed(0)
    for pool in (eng.cache, eng.draft_cache):
        for plane in pool.values():
            plane.copy_(torch.randint(-100, 100, plane.shape,
                                      generator=gen).to(plane.dtype))
    eng._cow_pairs = [(3, 5), (4, 9)]
    eng._apply_cow()
    assert eng._cow_pairs == []
    for pool in (eng.cache, eng.draft_cache):
        for plane in pool.values():
            assert torch.equal(plane[:, 5], plane[:, 3])
            assert torch.equal(plane[:, 9], plane[:, 4])
