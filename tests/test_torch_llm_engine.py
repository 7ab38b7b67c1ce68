"""PyTorch port's LLMEngine vs the JAX package's, end to end.

Both engines run paged KV with chunked prefill and ``attn_impl=
"gather"`` on the same tiny fp32 weights and are driven tick by tick the
way tests/test_chunked_prefill.py drives the JAX one: ragged prompts,
width-bucketed and full-width chunk dispatch, and preempt-by-recompute
under a small pool. Greedy token streams must be identical and the page
accounting must close. Knobs the port does not have yet, and bad
values of the ones it has (``weight_dtype``/``kv_dtype`` other than
bf16|int8, as tests/test_quant.py:344 has them; the prefix cache's and
speculative decoding's as tests/test_prefix_cache.py:288 and
tests/test_spec_decode.py:147 have them; a chunk or int8 with the dense
cache and an unknown ``kv_mode``, as ray_tpu/serve/llm.py:476-545
rejects them), must raise ValueError;
``start()``/``submit()`` must serve from the engine thread.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import gpt as jgpt
from ray_tpu.serve.llm import LLMEngine as JaxEngine
from ray_tpu_torch._bridge import params_from_jax
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.ops import paged_attention as tpa
from ray_tpu_torch.serve.llm import LLMEngine

JCFG = jgpt.GPTConfig.tiny(dtype=jnp.float32)
TCFG = tgpt.GPTConfig.tiny(dtype=torch.float32)


@pytest.fixture(scope="module")
def weights():
    jp = jgpt.init_params(JCFG, jax.random.key(42))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, TCFG,
                         device="cpu")
    return jp, tp


def _drive(eng, reqs, max_steps=800):
    for _ in range(max_steps):
        if all(r.done.is_set() for r in reqs):
            break
        eng.step()
    assert all(r.done.is_set() for r in reqs)
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    return [r.out_ids for r in reqs]


def _both(weights, prompts, *, max_tokens=6, n_slots=4, max_len=128,
          **kw):
    jp, tp = weights
    jeng = JaxEngine(JCFG, jp, n_slots=n_slots, max_len=max_len,
                     kv_mode="paged", attn_impl="gather", **kw)
    teng = LLMEngine(TCFG, tp, n_slots=n_slots, max_len=max_len,
                     kv_mode="paged", attn_impl="gather", device="cpu",
                     **kw)
    jout = _drive(jeng, [jeng.submit(p, max_tokens=max_tokens)
                         for p in prompts])
    tout = _drive(teng, [teng.submit(p, max_tokens=max_tokens)
                         for p in prompts])
    return jout, tout, jeng, teng


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, TCFG.vocab_size, n)))
            for n in lengths]


def _closed(eng):
    acc = eng.page_accounting()
    assert acc["closure"] and acc["refs_consistent"]
    assert acc["free"] == acc["total"]


@pytest.mark.parametrize("chunk,bucketing", [(16, True), (32, True),
                                             (16, False)])
def test_streams_match_jax_ragged(weights, chunk, bucketing):
    prompts = _prompts(0, (3, 17, 33, 50, 7, 40))
    jout, tout, jeng, teng = _both(
        weights, prompts, page_size=16, prefill_chunk=chunk,
        prefill_token_budget=2 * chunk, prefill_width_bucketing=bucketing)
    assert tout == jout
    _closed(teng)
    tm, jm = teng.metrics(), jeng.metrics()
    assert tm["prefill_dispatch_widths"] == jm["prefill_dispatch_widths"]
    assert tm["prefill_chunks"] == jm["prefill_chunks"]
    if bucketing:
        assert len(tm["prefill_dispatch_widths"]) > 1


def test_streams_match_jax_under_preemption(weights):
    prompts = [[5, 9, 2], [17, 3], [2, 4, 6], [8, 1, 0]]
    jout, tout, jeng, teng = _both(
        weights, prompts, max_tokens=10, max_len=64, page_size=4,
        n_pages=7, prefill_chunk=4, prefill_token_budget=8)
    assert tout == jout
    assert teng.stats["preemptions"] > 0
    assert teng.stats["preemptions"] == jeng.stats["preemptions"]
    _closed(teng)


def test_single_step_windows_and_eos(weights):
    prompts = _prompts(3, (5, 12))
    jp, tp = weights
    kw = dict(n_slots=2, max_len=64, page_size=8, prefill_chunk=8,
              prefill_token_budget=8, decode_block=1)
    jeng = JaxEngine(JCFG, jp, kv_mode="paged", attn_impl="gather", **kw)
    teng = LLMEngine(TCFG, tp, kv_mode="paged", attn_impl="gather",
                     device="cpu", **kw)
    jout = _drive(jeng, [jeng.submit(p, max_tokens=5) for p in prompts])
    tout = _drive(teng, [teng.submit(p, max_tokens=5) for p in prompts])
    assert tout == jout
    eos = tout[0][2]
    req = teng.submit(prompts[0], max_tokens=5, eos_id=eos)
    _drive(teng, [req])
    assert req.out_ids[-1] == eos and len(req.out_ids) <= 3
    _closed(teng)


def test_threaded_serving_and_kernel_impl_on_cpu(weights):
    """start()/submit() from the engine thread; attn_impl="kernel" with
    CPU tensors runs the plain versions (no launch counted) and gives
    the gather engine's streams; "auto" resolves to gather on the CPU."""
    _, tp = weights
    prompts = _prompts(4, (9, 30, 2))
    tpa.reset_launch_counts()
    eng = LLMEngine(TCFG, tp, kv_mode="paged", n_slots=2, max_len=64,
                    page_size=8, prefill_chunk=16, prefill_token_budget=16,
                    attn_impl="kernel", device="cpu")
    eng.start()
    try:
        reqs = [eng.submit(p, max_tokens=4) for p in prompts]
        for r in reqs:
            assert r.done.wait(timeout=60)
    finally:
        eng.stop()
    assert all(r.error is None for r in reqs)
    assert tpa.paged_attention.launches == 0
    assert tpa.paged_prefill_attention.launches == 0
    ref = LLMEngine(TCFG, tp, kv_mode="paged", n_slots=2, max_len=64,
                    page_size=8, prefill_chunk=16, prefill_token_budget=16,
                    device="cpu")
    assert ref.attn_impl == "gather"
    assert _drive(ref, [ref.submit(p, max_tokens=4) for p in prompts]) == [
        r.out_ids for r in reqs]
    _closed(eng)
    m = eng.metrics()
    assert m["completed"] == 3 and m["ttft_ms_p50"] > 0


def test_sampled_requests_complete(weights):
    _, tp = weights
    eng = LLMEngine(TCFG, tp, kv_mode="paged", n_slots=2, max_len=64,
                    page_size=8, prefill_chunk=8, prefill_token_budget=8,
                    device="cpu")
    reqs = [eng.submit(p, max_tokens=6, temperature=0.8)
            for p in _prompts(5, (4, 11))]
    out = _drive(eng, reqs)
    assert all(len(o) == 6 and all(0 <= t < TCFG.vocab_size for t in o)
               for o in out)
    _closed(eng)


@pytest.mark.parametrize("knob", [
    {"prefix_cache": True, "prefix_cache_pages": -1},
    # tp=3 does not divide tiny's 8 heads (tp itself is ported).
    # KV transfer is ported: an unknown pool role, and transfer on chunks
    # that are not a multiple of the page size, are the reference's errors.
    {"spec_draft": "tiny", "spec_k": 0}, {"tp": 3}, {"pool_role": "both"},
    {"kv_transfer": True, "prefill_chunk": 12, "prefill_token_budget": 12},
    {"weight_dtype": "int4"}, {"kv_dtype": "fp8"},
    {"attn_impl": "flash"},
    {"prefill_chunk": 32, "prefill_token_budget": 16},
    # The reference's invalid values of the prefix-cache and spec knobs.
    {"spec_draft": tgpt.GPTConfig.tiny(vocab_size=128)},
    {"spec_draft_params": {}},
    {"spec_draft": "tiny", "prefill_chunk": 0},
    {"prefix_cache": True, "prefill_chunk": 0},
    # The reference's invalid values of the KV mode (the dense cache takes
    # no chunk and no int8 weights or KV).
    {"kv_mode": "dense", "prefill_chunk": 8},
    {"kv_mode": "dense", "prefill_chunk": 0, "weight_dtype": "int8"},
    {"kv_mode": "dense", "prefill_chunk": 0, "kv_dtype": "int8"},
    {"kv_mode": "bogus"},
])
def test_unported_or_invalid_knobs_raise(weights, knob):
    """Each knob on a paged chunked engine (the knob may override both)."""
    _, tp = weights
    with pytest.raises(ValueError):
        LLMEngine(TCFG, tp, n_slots=2, max_len=64, page_size=8,
                  device="cpu", **{"kv_mode": "paged", "prefill_chunk": 8,
                                   "prefill_token_budget": 8, **knob})


def test_submit_validation(weights):
    _, tp = weights
    eng = LLMEngine(TCFG, tp, kv_mode="paged", n_slots=2, max_len=32,
                    page_size=8, prefill_chunk=8, prefill_token_budget=8,
                    device="cpu")
    with pytest.raises(ValueError):
        eng.submit([])
    with pytest.raises(ValueError):
        eng.submit([1] * 32)
    with pytest.raises(ValueError):
        eng.submit([1], temperature=-1.0)
