"""PyTorch port vs the JAX package: engine warmup (`warmup_compile`, the
``warmup`` knob at `start`).

- `warmup_compile()` issues the JAX engine's count of inert dispatches:
  per table width of the ladder (here 1, 2 and the non-pow-2 cap 3), both
  head variants of `prefill_chunk_paged`, plus the draft's mirror and
  `verify_chunk_paged` with speculation; one width with bucketing off; 0
  on dense and one-shot engines and on a second call. Every dispatch has
  an all-zero table and no valid row.
- ``warmup=True`` warms at `start()`, before the engine thread runs.
- After warmup every pool plane outside the null page is bitwise
  unchanged, float and int8 with its scale planes (the draft's pool too),
  on pools filled with seeded values. On a fresh int8 pool the warmup
  writes what the JAX engine's does: zero data, and the never-scaled
  pages' scales set to bf16(1e-8 / 127), the same as any first dispatch
  of an unwarmed engine.
- Greedy streams of a warmed engine equal an unwarmed engine's and the
  JAX engine's.
- On the CPU no kernel launch is counted (``attn_impl="kernel"`` takes
  the plain versions) and no kernel library is loaded.
Tiny configs, fp32.
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
from ray_tpu_torch.models import paged_kv as tpk
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import paged_attention as tpa
from ray_tpu_torch.serve.llm import LLMEngine

JCFG = jgpt.GPTConfig.tiny(dtype=jnp.float32)
TCFG = tgpt.GPTConfig.tiny(dtype=torch.float32)
DRAFT = dict(n_layers=1, d_model=32, n_heads=4, d_ff=64)
JDRAFT = jgpt.GPTConfig.tiny(dtype=jnp.float32, **DRAFT)
TDRAFT = tgpt.GPTConfig.tiny(dtype=torch.float32, **DRAFT)
# max_len 48 at page 16: max_pages_per_slot 3, ladder (1, 2, 3).
BASE = dict(n_slots=2, max_len=48, prefill_buckets=(8, 16, 32))
CHUNKED = dict(kv_mode="paged", page_size=16, prefill_chunk=16,
               prefill_token_budget=32)
MODES = {
    "bucketed": (CHUNKED, 6),
    "unbucketed": (dict(CHUNKED, prefill_width_bucketing=False), 2),
    "spec": (dict(CHUNKED, spec_k=2), 12),
    "int8": (dict(CHUNKED, weight_dtype="int8", kv_dtype="int8"), 6),
    "dense": (dict(kv_mode="dense"), 0),
    "oneshot": (dict(kv_mode="paged", page_size=16), 0),
}


def _bridge(jp, cfg):
    return params_from_jax({k: np.asarray(v) for k, v in jp.items()}, cfg,
                           device="cpu")


@pytest.fixture(scope="module")
def weights():
    jp = jgpt.init_params(JCFG, jax.random.key(42))
    jd = jgpt.init_params(JDRAFT, jax.random.key(7))
    return (jp, _bridge(jp, TCFG)), (jd, _bridge(jd, TDRAFT))


@pytest.fixture(autouse=True)
def _no_launches(monkeypatch):
    def no_library():
        raise AssertionError("the kernel library was loaded on the CPU")

    monkeypatch.setattr(_build, "library", no_library)
    tpa.reset_launch_counts()
    yield
    for fn in (tpa.paged_attention, tpa.paged_prefill_attention):
        assert (fn.launches, fn.int8_launches) == (0, 0)


def _port(weights, mode, **kw):
    (_, tp), (_, td) = weights
    spec = dict(spec_draft=TDRAFT, spec_draft_params=td) if (
        mode == "spec") else {}
    return LLMEngine(TCFG, tp, attn_impl="kernel", device="cpu",
                     **BASE, **MODES[mode][0], **spec, **kw)


def _jax(weights, mode):
    (jp, _), (jd, _) = weights
    spec = dict(spec_draft=JDRAFT, spec_draft_params=jd) if (
        mode == "spec") else {}
    return JaxEngine(JCFG, jp, attn_impl="gather", **BASE, **MODES[mode][0],
                     **spec)


def _counting(monkeypatch):
    """Record every prefill/verify program call: (program, table width,
    whether any table entry or valid count is nonzero)."""
    calls = []
    for name in ("prefill_chunk_paged", "verify_chunk_paged"):
        real = getattr(tpk, name)

        def wrapped(cfg, params, tokens, pool, tables, offsets, n_valid,
                    *a, _real=real, _name=name, **kw):
            calls.append((_name, tables.shape[1],
                          bool(tables.any() or n_valid.any()
                               or offsets.any())))
            return _real(cfg, params, tokens, pool, tables, offsets,
                         n_valid, *a, **kw)

        monkeypatch.setattr(tpk, name, wrapped)
    return calls


@pytest.mark.parametrize("mode", list(MODES))
def test_dispatch_count_equals_jax(weights, mode, monkeypatch):
    jeng, expect = _jax(weights, mode), MODES[mode][1]
    calls = _counting(monkeypatch)
    teng = _port(weights, mode)
    assert teng.warmup_compile() == jeng.warmup_compile() == expect
    assert len(calls) == expect and not any(live for *_x, live in calls)
    if expect:
        assert teng._width_ladder() == jeng._width_ladder()
        assert sorted({w for _n, w, _l in calls}) == teng._width_ladder()
    assert teng.warmup_compile() == jeng.warmup_compile() == 0
    assert len(calls) == expect


def test_warmup_knob_warms_at_start(weights, monkeypatch):
    calls = _counting(monkeypatch)
    eng = _port(weights, "bucketed", warmup=True)
    assert not calls and not eng._warmed
    eng.start()
    try:
        assert eng._warmed and len(calls) == MODES["bucketed"][1]
        req = eng.submit([3, 1, 4, 1, 5], max_tokens=4)
        assert req.done.wait(timeout=60) and req.error is None
    finally:
        eng.stop()
    cold = _port(weights, "bucketed")
    cold.start()
    cold.stop()
    assert not cold._warmed


def _fill(pool, seed):
    """Seeded values in every plane (positive scales), as a live pool
    holds."""
    g = torch.Generator().manual_seed(seed)
    for name, a in pool.items():
        if name.endswith("_scale"):
            a.copy_(torch.rand(a.shape, generator=g) + 0.01)
        elif a.dtype == torch.int8:
            a.copy_(torch.randint(-127, 128, a.shape, generator=g))
        else:
            a.copy_(torch.randn(a.shape, generator=g))


def _outside_null(pool):
    return {k: v[:, 1:].clone() for k, v in pool.items()}


@pytest.mark.parametrize("mode", ["bucketed", "int8", "spec"])
def test_pool_outside_null_page_bitwise_unchanged(weights, mode):
    eng = _port(weights, mode)
    pools = [eng.cache] + ([eng.draft_cache] if mode == "spec" else [])
    for i, pool in enumerate(pools):
        _fill(pool, i)
    before = [_outside_null(p) for p in pools]
    assert eng.warmup_compile() == MODES[mode][1]
    for pool, old in zip(pools, before):
        for name, plane in _outside_null(pool).items():
            assert torch.equal(plane, old[name]), name


def test_fresh_int8_pool_matches_jax_warmup(weights):
    jeng, teng = _jax(weights, "int8"), _port(weights, "int8")
    unwarmed = _port(weights, "int8")
    jeng.warmup_compile()
    teng.warmup_compile()
    never = float(torch.tensor(1e-8 / 127, dtype=torch.bfloat16))
    for name, plane in teng.cache.items():
        out = plane[:, 1:].float().numpy()
        assert np.array_equal(out, np.asarray(jeng.cache[name],
                                              np.float32)[:, 1:]), name
        want = never if name.endswith("_scale") else 0.0
        assert (out == want).all(), name
    # An unwarmed engine's first dispatch (one chunk into page 1) leaves
    # every other page's scale where the warmup does.
    req = unwarmed.submit([2, 7], max_tokens=1)
    unwarmed.step()
    assert req.done.is_set() and req.error is None
    for name in ("k_scale", "v_scale"):
        assert (unwarmed.cache[name][:, 2:].float() == never).all(), name
        assert (unwarmed.cache[name][:, 1].float() > never).all(), name


def _prompts():
    rng = np.random.default_rng(11)
    return [list(map(int, rng.integers(1, TCFG.vocab_size, n)))
            for n in (5, 23, 12, 30)]


def _drive(eng):
    reqs = [eng.submit(p, max_tokens=8) for p in _prompts()]
    for _ in range(500):
        if all(r.done.is_set() for r in reqs):
            break
        eng.step()
    assert all(r.done.is_set() and r.error is None for r in reqs)
    return [r.out_ids for r in reqs]


@pytest.mark.parametrize("mode", ["bucketed", "spec", "int8"])
def test_greedy_streams_equal_unwarmed_and_jax(weights, mode):
    warm = _port(weights, mode)
    assert warm.warmup_compile() == MODES[mode][1]
    out = _drive(warm)
    assert out == _drive(_port(weights, mode)) == _drive(_jax(weights,
                                                              mode))
    acc = warm.page_accounting()
    assert acc["closure"] and acc["free"] == acc["total"], acc
