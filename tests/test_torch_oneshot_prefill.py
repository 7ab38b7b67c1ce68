"""PyTorch port vs the JAX package: one-shot paged prefill and its engine.

- `prefill_batch_paged` against JAX's on the same weights, prompts and
  page tables (tail entries the null page), on a float and an int8 pool:
  last-token logits within 2e-4 (the reference's fp32 tolerance), float
  pages within 2e-4, int8 codes within one step and scales within one
  bf16 ulp of JAX's (the K/V rows they quantize differ by fp32 rounding),
  the null page excluded (several pads land there, in an undefined order
  in both packages).
- `_quant_write_full_pages` on the SAME input rows: codes and scale
  planes equal JAX's exactly, on distinct pages and with duplicate
  null-page ids (every real page exact).
- ``LLMEngine`` streams: the port's dense, one-shot paged and chunked
  engines give the same greedy streams, and each equals the JAX engine
  of its mode (tests/test_chunked_prefill.py:58-100,
  tests/test_llm_serve.py:262-330): ragged prompts, pool back-pressure
  (2 pages), preemption by recompute under a 7-page pool, float and
  int8 weights and KV, one-shot with ``attn_impl="kernel"`` (the plain
  versions on the CPU); an infeasible prompt rejected at submit, and the
  bucket cap's "prompt too long" as JAX words it.

Tiny config, fp32; every paged launch counter stays 0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import gpt as jgpt
from ray_tpu.models import paged_kv as jpk
from ray_tpu.serve.llm import LLMEngine as JaxEngine
from ray_tpu_torch._bridge import params_from_jax, pool_from_jax
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import paged_kv as tpk
from ray_tpu_torch.ops import paged_attention as tpa
from ray_tpu_torch.serve.llm import LLMEngine

TOL = dict(rtol=2e-4, atol=2e-4)
JCFG = jgpt.GPTConfig.tiny(dtype=jnp.float32)
TCFG = tgpt.GPTConfig.tiny(dtype=torch.float32)
JCFG_U = jgpt.GPTConfig.tiny_untied(dtype=jnp.float32)
TCFG_U = tgpt.GPTConfig.tiny_untied(dtype=torch.float32)
QUANT = {"weight_dtype": "int8", "kv_dtype": "int8"}


def _bridge(jp, cfg):
    return params_from_jax({k: np.asarray(v) for k, v in jp.items()}, cfg,
                           device="cpu")


@pytest.fixture(scope="module")
def weights():
    jp = jgpt.init_params(JCFG, jax.random.key(42))
    return jp, _bridge(jp, TCFG)


@pytest.fixture(autouse=True)
def _no_launches():
    tpa.reset_launch_counts()
    yield
    assert tpa.paged_attention.launches == 0
    assert tpa.paged_prefill_attention.launches == 0
    assert tpa.paged_attention.int8_launches == 0
    assert tpa.paged_prefill_attention.int8_launches == 0


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, TCFG.vocab_size, n)))
            for n in lengths]


# ------------------------------------------------------------- programs

@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_prefill_batch_paged_matches_jax(kv_dtype):
    """Three prompts of a 20-token bucket on pages of 8 (three pages per
    row; the short row's third entry is the null page)."""
    jp = jgpt.init_params(JCFG_U, jax.random.key(3))
    tp = _bridge(jp, TCFG_U)
    prompts = _prompts(9, (20, 9, 14))
    toks = np.zeros((3, 20), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lengths = np.array([len(p) for p in prompts], np.int32)
    pages = np.array([[3, 1, 7], [2, 8, 0], [4, 6, 5]], np.int32)
    jpool = jpk.init_paged_kv(JCFG_U, 9, 8, kv_dtype=kv_dtype)
    tpool = pool_from_jax({k: np.asarray(v) for k, v in jpool.items()},
                          TCFG_U, device="cpu")
    jl, jpool = jpk.prefill_batch_paged(JCFG_U, jp, jnp.asarray(toks), jpool,
                                        jnp.asarray(pages),
                                        jnp.asarray(lengths))
    tl, out = tpk.prefill_batch_paged(TCFG_U, tp, torch.from_numpy(toks),
                                      tpool, torch.from_numpy(pages),
                                      torch.from_numpy(lengths))
    assert out is tpool and tl.shape == (3, TCFG_U.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name, plane in tpool.items():
        t = plane[:, 1:].float().numpy()
        j = np.asarray(jpool[name][:, 1:]).astype(np.float32)
        if kv_dtype == "bf16":
            np.testing.assert_allclose(t, j, **TOL)
        elif name.endswith("_scale"):
            np.testing.assert_allclose(t, j, rtol=2 ** -8, atol=0)
        else:
            assert np.abs(t - j).max() <= 1, name


@pytest.mark.parametrize("pages", [[4, 1, 3, 2], [5, 2, 0, 0]],
                         ids=["distinct", "null_duplicates"])
def test_quant_write_full_pages_matches_jax_exactly(pages):
    """The same rows (log-uniform page amplitudes) into a layer plane
    whose pages hold older codes and scales: every real page's codes and
    scale equal JAX's bit for bit."""
    rng = np.random.default_rng(11)
    ps, H, K = 8, 4, 16
    amp = np.exp(rng.uniform(np.log(0.25), np.log(4.0), len(pages)))
    values = (rng.standard_normal((len(pages), ps, H, K))
              * amp[:, None, None, None]).astype(np.float32)
    old = rng.integers(-127, 128, (6, ps, H, K)).astype(np.int8)
    old_scale = jnp.asarray(rng.uniform(0.01, 0.1, 6), jnp.bfloat16)
    jq, js = jpk._quant_write_full_pages(
        jnp.asarray(old), old_scale, jnp.asarray(np.array(pages, np.int32)),
        jnp.asarray(values))
    tq = torch.from_numpy(old.copy())
    ts = torch.from_numpy(np.asarray(old_scale).astype(np.float32)).to(
        torch.bfloat16)
    tpk._quant_write_full_pages(tq, ts, torch.tensor(pages),
                                torch.from_numpy(values))
    real = sorted(set(pages) - {0}) + [p for p in range(1, 6)
                                       if p not in pages]
    np.testing.assert_array_equal(tq[real].numpy(), np.asarray(jq)[real])
    np.testing.assert_array_equal(ts[real].float().numpy(),
                                  np.asarray(js).astype(np.float32)[real])


# --------------------------------------------------------------- engine

def _drive(eng, reqs, max_steps=800):
    for _ in range(max_steps):
        if all(r.done.is_set() for r in reqs):
            break
        eng.step()
    assert all(r.done.is_set() for r in reqs)
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    return [r.out_ids for r in reqs]


def _run(eng, prompts, max_tokens):
    return _drive(eng, [eng.submit(p, max_tokens=max_tokens)
                        for p in prompts])


def _pair(weights, prompts, *, max_tokens=6, **kw):
    """The same engine in both packages → (JAX streams, port streams,
    JAX engine, port engine)."""
    jp, tp = weights
    kw.setdefault("n_slots", 4)
    kw.setdefault("max_len", 128)
    jeng = JaxEngine(JCFG, jp, attn_impl="gather", **kw)
    teng = LLMEngine(TCFG, tp, device="cpu", **kw)
    return (_run(jeng, prompts, max_tokens), _run(teng, prompts, max_tokens),
            jeng, teng)


def _closed(eng, free=None):
    acc = eng.page_accounting()
    assert acc["closure"] and acc["refs_consistent"] and acc["live"] == 0
    assert acc["free"] == acc["total"]
    return acc


RAGGED = dict(prefill_buckets=(64,))
MODES = {
    "dense": dict(kv_mode="dense"),
    "oneshot": dict(kv_mode="paged", page_size=16),
    "oneshot_kernel": dict(kv_mode="paged", page_size=16,
                           attn_impl="kernel"),
    "chunked": dict(kv_mode="paged", page_size=16, prefill_chunk=16,
                    prefill_token_budget=32),
}


@pytest.fixture(scope="module")
def ragged(weights):
    """The JAX dense engine's streams on ragged prompts."""
    jp, _ = weights
    prompts = _prompts(0, (3, 17, 33, 50, 7, 40))
    jeng = JaxEngine(JCFG, jp, n_slots=4, max_len=128, kv_mode="dense",
                     **RAGGED)
    return prompts, _run(jeng, prompts, 6)


@pytest.mark.parametrize("mode", list(MODES))
def test_modes_give_the_dense_streams(weights, ragged, mode):
    """Chunked == one-shot == dense in the port, each equal to the JAX
    dense engine's streams (which the JAX tests pin equal to its own
    one-shot and chunked engines')."""
    _, tp = weights
    prompts, ref = ragged
    eng = LLMEngine(TCFG, tp, n_slots=4, max_len=128, device="cpu",
                    **RAGGED, **MODES[mode])
    assert _run(eng, prompts, 6) == ref
    if mode != "dense":
        _closed(eng)


@pytest.mark.parametrize("arm", ["float", "int8"])
def test_oneshot_streams_match_jax_oneshot(weights, arm):
    prompts = _prompts(1, (5, 23, 41, 12, 60))
    quant = QUANT if arm == "int8" else {}
    jout, tout, jeng, teng = _pair(weights, prompts, kv_mode="paged",
                                   page_size=16, **RAGGED, **quant)
    assert tout == jout
    _closed(teng)
    tm, jm = teng.metrics(), jeng.metrics()
    for key in ("kv_pages_free_min", "prefill_tokens", "decode_windows",
                "llm_weight_dtype", "llm_kv_dtype", "kv_pages_total"):
        assert tm[key] == jm[key], key
    assert "prefill_chunk" not in tm


def test_pool_backpressure_queues_admissions(weights):
    """Two pages for six requests: admission defers, every request
    completes, the streams equal JAX's one-shot engine's and the port's
    dense engine's."""
    prompts = [[3 + i, 1, 4] for i in range(6)]
    kw = dict(max_len=64, prefill_buckets=(16,))
    jout, tout, _, teng = _pair(weights, prompts, max_tokens=4,
                                kv_mode="paged", page_size=4, n_pages=2, **kw)
    assert tout == jout and all(len(o) == 4 for o in tout)
    assert teng.metrics()["kv_pages_free"] == 2
    _, tp = weights
    dense = LLMEngine(TCFG, tp, n_slots=4, device="cpu", **kw)
    assert _run(dense, prompts, 4) == tout


@pytest.mark.parametrize("arm", ["float", "int8"])
def test_preemption_recompute_is_exact(weights, arm):
    """Four requests growing to 13 tokens (4 pages of 4 each) on a 7-page
    pool: one-shot admission with preempt-by-recompute gives JAX's
    streams and preemptions, and (float) the port's dense and chunked
    engines' streams."""
    prompts = [[5, 9, 2], [17, 3], [2, 4, 6], [8, 1, 0]]
    quant = QUANT if arm == "int8" else {}
    kw = dict(max_len=64, prefill_buckets=(16,))
    jout, tout, jeng, teng = _pair(weights, prompts, max_tokens=10,
                                   kv_mode="paged", page_size=4, n_pages=7,
                                   **kw, **quant)
    assert tout == jout
    assert teng.stats["preemptions"] > 0
    assert teng.stats["preemptions"] == jeng.stats["preemptions"]
    _closed(teng)
    if arm == "float":
        _, tp = weights
        dense = LLMEngine(TCFG, tp, n_slots=4, device="cpu", **kw)
        chunked = LLMEngine(TCFG, tp, n_slots=4, device="cpu",
                            kv_mode="paged", page_size=4, n_pages=7,
                            prefill_chunk=4, prefill_token_budget=8, **kw)
        assert _run(dense, prompts, 10) == tout
        assert _run(chunked, prompts, 10) == tout


def test_infeasible_prompt_rejected_at_submit(weights):
    _, tp = weights
    eng = LLMEngine(TCFG, tp, n_slots=2, max_len=64, prefill_buckets=(16,),
                    kv_mode="paged", page_size=4, n_pages=2, device="cpu")
    with pytest.raises(ValueError, match="KV pages"):
        eng.submit(list(range(12)), max_tokens=4)


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_bucket_cap_prompt_too_long(weights, mode):
    """One-shot prompts are capped by the largest bucket, with JAX's
    message; the chunked engine is capped by the cache alone."""
    jp, tp = weights
    kw = dict(n_slots=2, max_len=64, prefill_buckets=(8,), kv_mode=mode)
    msgs = []
    for eng in (JaxEngine(JCFG, jp, **kw),
                LLMEngine(TCFG, tp, device="cpu", **kw)):
        with pytest.raises(ValueError, match="prompt too long") as e:
            eng.submit([1] * 12, max_tokens=4)
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0] and "bucket cap 8" in msgs[1]
    chunked = LLMEngine(TCFG, tp, n_slots=2, max_len=64, kv_mode="paged",
                        prefill_chunk=8, prefill_token_budget=8,
                        device="cpu")
    assert chunked._prompt_cap == 63
    chunked.submit([1] * 12, max_tokens=1)
