"""PyTorch port vs the JAX package: the page ops and the prefix cache.

- `copy_pages`, `gather_pages`, `scatter_pages` on float and int8 pools
  (the scale planes are planes too) equal JAX's exactly, padding pairs
  and ids (the null page) included.
- The port's `serve/prefix_cache.py`: digests and `affinity_key` byte
  for byte JAX's; the unit cases of tests/test_prefix_cache.py on the
  port's `PrefixCache`; and the same random operation sequence on both
  caches leaves the same entries and refcounts.
- Warm admission at the program level: a prefix bound into another
  slot's table (shared pages plus a copy-on-write of the tail page)
  gives the cold run's last-token logits (within 1e-6: the same rows
  through the same shapes), on a float and an int8 pool; `copy_pages`
  without the scale planes fails that on the int8 pool by a large factor.
- `LLMEngine(prefix_cache=True)`: greedy streams equal the JAX engine's
  with the cache on (and so its cold streams, which the JAX tests pin)
  when warm requests follow cold ones, with copy-on-write at chunk 12 /
  page 8 on float and int8 KV, under concurrent sharing (the accounting
  closed after every tick), under preemption with shared pages, and
  with cached pages evicted before any preemption. The page accounting
  closes with pages held by the cache.

Tiny configs, ``attn_impl="gather"``, fp32, weights carried over by
`_bridge.params_from_jax`; every paged launch counter stays 0 (the CPU
takes the kernels' plain versions).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import gpt as jgpt
from ray_tpu.models import paged_kv as jpk
from ray_tpu.serve import prefix_cache as jpc
from ray_tpu.serve.llm import LLMEngine as JaxEngine
from ray_tpu_torch._bridge import params_from_jax, pool_from_jax
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import paged_kv as tpk
from ray_tpu_torch.ops import paged_attention as tpa
from ray_tpu_torch.serve import prefix_cache as tpc
from ray_tpu_torch.serve.llm import LLMEngine

JCFG = jgpt.GPTConfig.tiny(dtype=jnp.float32)
TCFG = tgpt.GPTConfig.tiny(dtype=torch.float32)
# Program-level checks: the untied head (the big models' layout).
JCFG_U = jgpt.GPTConfig.tiny_untied(dtype=jnp.float32)
TCFG_U = tgpt.GPTConfig.tiny_untied(dtype=torch.float32)
WARM_COLD_ATOL = 1e-6    # warm vs cold last-token logits, fp32


@pytest.fixture(scope="module")
def weights():
    jp = jgpt.init_params(JCFG, jax.random.key(42))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, TCFG,
                         device="cpu")
    return jp, tp


@pytest.fixture(autouse=True)
def _no_launches():
    tpa.reset_launch_counts()
    yield
    for fn in (tpa.paged_attention, tpa.paged_prefill_attention):
        assert (fn.launches, fn.int8_launches) == (0, 0)


def _np(t):
    """A pool plane (torch or JAX) as numpy, bf16 widened to fp32."""
    if isinstance(t, torch.Tensor):
        return t.numpy() if t.dtype == torch.int8 else t.float().numpy()
    a = np.asarray(t)
    return a if a.dtype == np.int8 else a.astype(np.float32)


# ------------------------------------------------------------- page ops

def _pools(kv, rng, n_pages=9, ps=4):
    """The same random pool for JAX and the port: float planes, or int8
    codes with random bf16 scale planes."""
    jpool = jpk.init_paged_kv(JCFG, n_pages, ps,
                              kv_dtype=None if kv == "fp32" else kv)
    filled = {}
    for name, a in jpool.items():
        if a.dtype == jnp.int8:
            filled[name] = jnp.asarray(
                rng.integers(-127, 128, a.shape).astype(np.int8))
        elif name.endswith("_scale"):
            filled[name] = jnp.asarray(rng.uniform(0.01, 1.0, a.shape),
                                       jnp.bfloat16)
        else:
            filled[name] = jnp.asarray(rng.normal(size=a.shape), a.dtype)
    tpool = pool_from_jax({k: np.asarray(v) for k, v in filled.items()},
                          TCFG, device="cpu")
    return filled, tpool


def _same(tpool, jpool):
    assert set(tpool) == set(jpool)
    for name in jpool:
        np.testing.assert_array_equal(_np(tpool[name]), _np(jpool[name]))


@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_page_ops_match_jax(kv):
    """copy (with (0, 0) padding pairs), gather (with null-page padding)
    and scatter (with null ids and zero payloads) equal JAX's exactly on
    every plane; the port works in place and returns the pool."""
    rng = np.random.default_rng(0 if kv == "fp32" else 1)
    jpool, tpool = _pools(kv, rng)
    src = np.array([3, 7, 0, 0], np.int32)
    dst = np.array([5, 2, 0, 0], np.int32)
    jpool = jpk.copy_pages(jpool, jnp.asarray(src), jnp.asarray(dst))
    out = tpk.copy_pages(tpool, torch.from_numpy(src), torch.from_numpy(dst))
    assert out is tpool
    _same(tpool, jpool)
    if kv == "int8":     # the scale planes moved with their pages
        for name in ("k_scale", "v_scale"):
            assert torch.equal(tpool[name][:, 5], tpool[name][:, 3])
    pages = np.array([2, 5, 9, 0], np.int32)
    jg = jpk.gather_pages(jpool, jnp.asarray(pages))
    tg = tpk.gather_pages(tpool, torch.from_numpy(pages))
    _same(tg, jg)
    # Adopt the gathered pages elsewhere, the last id a padding null id
    # with a zero payload.
    at = np.array([1, 4, 6, 0], np.int32)
    jpay = {k: v.at[:, 3].set(0) for k, v in jg.items()}
    tpay = {k: v.clone() for k, v in tg.items()}
    for v in tpay.values():
        v[:, 3] = 0
    jpool = jpk.scatter_pages(jpool, jnp.asarray(at), jpay)
    assert tpk.scatter_pages(tpool, torch.from_numpy(at), tpay) is tpool
    _same(tpool, jpool)


# --------------------------------------------------------- prefix cache

def _token_lists():
    rng = np.random.default_rng(3)
    lists = [list(map(int, rng.integers(0, 50304, n)))
             for n in (0, 1, 3, 4, 7, 8, 33, 64, 100)]
    lists.append([2**40, -5, 0, 7, 7, 7, 7, 7, 1])     # int64 extremes
    lists.append(np.arange(20, dtype=np.int32))         # a numpy prompt
    return lists


@pytest.mark.parametrize("chunk", [1, 4, 16])
def test_digests_byte_identical(chunk):
    """chunk_hashes, a memoized extend_chunk_chain and affinity_key give
    JAX's bytes (the digests later key a shared KV tier)."""
    for toks in _token_lists():
        assert tpc.chunk_hashes(toks, chunk) == jpc.chunk_hashes(toks, chunk)
        assert (tpc.affinity_key(toks, chunk)
                == jpc.affinity_key(toks, chunk))
        memo_t, memo_j = [], []
        for n in (len(toks) // 2, len(toks)):
            assert (tpc.extend_chunk_chain(toks[:n], chunk, memo_t)
                    == jpc.extend_chunk_chain(toks[:n], chunk, memo_j))
    assert tpc.affinity_key([1, 2], 0) == jpc.affinity_key([1, 2], 0)


def _cache(mod=tpc, **kw):
    refs = {}

    def ref(p):
        refs[p] = refs.get(p, 0) + 1

    def unref(p):
        refs[p] -= 1

    base = dict(chunk=4, page_size=4, max_pages=64,
                ref_page=ref, unref_page=unref)
    base.update(kw)
    return mod.PrefixCache(**base), refs


def test_chunk_hash_chaining():
    a = tpc.chunk_hashes([1, 2, 3, 4, 5, 6, 7, 8], 4)
    b = tpc.chunk_hashes([1, 2, 3, 4, 5, 6, 7, 9], 4)
    c = tpc.chunk_hashes([1, 2, 3, 4, 5, 6, 7, 8, 0], 4)
    assert len(a) == 2 and a[0] == b[0] and a[1] != b[1]
    assert c == a                       # partial tail chunk ignored
    d = tpc.chunk_hashes([9, 9, 9, 9, 5, 6, 7, 8], 4)
    assert d[1] != a[1]                 # parent-chained


def test_lookup_longest_and_cold_token_cap():
    cache, _ = _cache()
    cache.donate(list(range(12)), [1, 2, 3, 0, 0])
    assert cache.match_len(list(range(12))) == 8
    assert cache.match_len(list(range(12)) + [99]) == 12
    assert cache.match_len([7] * 12) == 0
    # Evicting a middle entry keeps the deeper self-contained one.
    hs = tpc.chunk_hashes(list(range(12)), 4)
    mid = cache.entries.pop(hs[1])
    for p in mid.pages:
        cache._page_owners[p] -= 1
        if not cache._page_owners[p]:
            del cache._page_owners[p]
        cache._unref_page(p)
    assert cache.match_len(list(range(12)) + [99]) == 12


def test_donation_refs_and_eviction_unrefs():
    cache, refs = _cache()
    cache.donate(list(range(8)), [5, 6, 0, 0])
    assert refs == {5: 2, 6: 1}
    assert cache.n_pages_cached() == 2
    pinned = cache.acquire(list(range(8)) + [42])
    assert pinned is not None and pinned.active == 1
    v = cache.evict_one()
    assert v is not None and v.n_tokens == 4
    assert cache.evict_one() is None
    cache.release(pinned)
    assert cache.evict_one() is pinned
    assert refs == {5: 0, 6: 0}
    assert cache.n_pages_cached() == 0


def test_budget_bounds_donation():
    cache, refs = _cache(max_pages=2)
    cache.donate(list(range(16)), [3, 4, 5, 6, 0])
    assert cache.n_pages_cached() <= 2
    assert max((e.n_tokens for e in cache.entries.values()),
               default=0) <= 8
    cache.donate(list(range(100, 108)), [9, 10, 0])
    assert cache.n_pages_cached() <= 2
    assert cache.match_len(list(range(100, 108)) + [1]) == 8
    assert all(v >= 0 for v in refs.values())


def test_lru_order():
    cache, _ = _cache()
    cache.donate([1] * 4, [11, 0])
    cache.donate([2] * 4, [12, 0])
    cache.acquire([1] * 4 + [9])
    cache.release(cache.entries[tpc.chunk_hashes([1] * 4, 4)[0]])
    v = cache.evict_one()
    assert v.pages == (12,)


def test_cache_operations_match_jax():
    """One random sequence of donate / acquire / release / evict on the
    port's cache and on JAX's: the same return values, entries (key,
    pages, pin count, LRU order) and page refcounts after every step."""
    rng = np.random.default_rng(17)
    caches = [_cache(mod, max_pages=12) for mod in (tpc, jpc)]
    heads = [list(map(int, rng.integers(1, 9, 8))) for _ in range(3)]
    pinned = [[], []]

    def state(cache, refs):
        return ([(e.key, e.pages, e.active, e.n_tokens)
                 for e in cache.entries.values()],
                {p: r for p, r in refs.items() if r}, cache.evictions,
                cache.n_pages_cached())

    for _ in range(300):
        op = int(rng.integers(0, 4))
        toks = (heads[int(rng.integers(0, 3))]
                + list(map(int, rng.integers(1, 9, int(rng.integers(0, 14))))))
        row = list(map(int, rng.permutation(np.arange(1, 40))[:8]))
        outs = []
        for i, (cache, _refs) in enumerate(caches):
            if op == 0:
                outs.append(cache.donate(toks, row))
            elif op == 1:
                e = cache.acquire(toks)
                if e is not None:
                    pinned[i].append(e)
                outs.append(None if e is None else e.key)
            elif op == 2 and pinned[i]:
                cache.release(pinned[i].pop(0))
                outs.append(None)
            else:
                e = cache.evict_one()
                outs.append(None if e is None else e.key)
        assert outs[0] == outs[1]
        assert state(*caches[0]) == state(*caches[1])


# ------------------------------------------- warm admission, programs

def _prog_weights():
    jp = jgpt.init_params(JCFG_U, jax.random.key(5))
    tp = tpk.serving_params(TCFG_U, params_from_jax(
        {k: np.asarray(v) for k, v in jp.items()}, TCFG_U, device="cpu"),
        device="cpu")
    return tp


def _prefill(params, pool, prompt, table, start, chunk, n_slots=4):
    """Chunked prefill of ``prompt[start:]`` into row 0 of fixed
    [n_slots, chunk] dispatches at the table's full width (the other
    rows inert) → the last-token logits [V]."""
    width = len(table)
    tables = np.zeros((n_slots, width), np.int32)
    tables[0] = table
    for done in range(start, len(prompt), chunk):
        n = min(chunk, len(prompt) - done)
        toks = np.zeros((n_slots, chunk), np.int32)
        toks[0, :n] = prompt[done:done + n]
        offs = np.zeros(n_slots, np.int32)
        nv = np.zeros(n_slots, np.int32)
        offs[0], nv[0] = done, n
        last, pool = tpk.prefill_chunk_paged(
            TCFG_U, params, torch.from_numpy(toks), pool,
            torch.from_numpy(tables), torch.from_numpy(offs),
            torch.from_numpy(nv))
    return last[0]


def _warm_vs_cold(params, kv, copy):
    """A 45-token prompt prefilled cold in chunks of 12 into pages 1-6
    (ps 8); its first 36 positions bound into another table: pages 1-4
    shared and page 5 (positions 32-35 written, 36-39 not yet) copied by
    ``copy`` onto page 9, a recycled page whose planes hold stale rows
    and scales; then prefilled from 36. → |warm - cold| of the last
    token's logits."""
    rng = np.random.default_rng(8)
    prompt = rng.integers(1, TCFG_U.vocab_size, 45).astype(np.int32)
    pool = tpk.init_paged_kv(TCFG_U, 12, 8, kv_dtype=kv, device="cpu")
    # Recycle page 9: an earlier request wrote its own rows there.
    stale = rng.integers(1, TCFG_U.vocab_size, 8).astype(np.int32)
    _prefill(params, pool, stale, [9, 0, 0, 0, 0, 0, 0, 0], 0, 12)
    cold = _prefill(params, pool, prompt, [1, 2, 3, 4, 5, 6, 0, 0], 0, 12)
    copy(pool, torch.tensor([5]), torch.tensor([9]))
    warm = _prefill(params, pool, prompt, [1, 2, 3, 4, 9, 10, 0, 0], 36, 12)
    return float((warm - cold).abs().max())


def _copy_k_v_only(pool, src, dst):
    """The planted fault: copy-on-write of the K/V codes alone, the
    page keeping whatever scale its row holds."""
    for name in ("k", "v"):
        pool[name][:, dst] = pool[name][:, src]
    return pool


@pytest.mark.parametrize("kv", [None, "int8"], ids=["float", "int8"])
def test_warm_prefill_equals_cold_and_planted_fault(kv):
    params = _prog_weights()
    err = _warm_vs_cold(params, kv, tpk.copy_pages)
    assert err <= WARM_COLD_ATOL, err
    if kv == "int8":
        fault = _warm_vs_cold(params, kv, _copy_k_v_only)
        assert fault > 100 * WARM_COLD_ATOL, fault


# --------------------------------------------------------------- engine

def _drive(eng, reqs, max_steps=2000, each_tick=None):
    for _ in range(max_steps):
        if all(r.done.is_set() for r in reqs):
            break
        eng.step()
        if each_tick is not None:
            each_tick(eng)
    assert all(r.done.is_set() for r in reqs)
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    return [r.out_ids for r in reqs]


def _closure(eng):
    acc = eng.page_accounting()
    assert acc["closure"] and acc["refs_consistent"], acc
    assert acc["free"] + acc["cached_only"] + acc["live"] == acc["total"]
    return acc


def _engines(weights, **kw):
    jp, tp = weights
    base = dict(n_slots=4, max_len=128, page_size=16, prefill_chunk=16,
                prefill_token_budget=32, prefix_cache=True)
    base.update(kw)
    return (JaxEngine(JCFG, jp, kv_mode="paged", attn_impl="gather", **base),
            LLMEngine(TCFG, tp, kv_mode="paged", attn_impl="gather",
                      device="cpu", **base))


def _shared_prefix(seed, shared_len, suffixes):
    rng = np.random.default_rng(seed)
    shared = list(map(int, rng.integers(1, TCFG.vocab_size, shared_len)))
    return [shared + list(map(int, rng.integers(1, TCFG.vocab_size, n)))
            for n in suffixes]


PREFIX_KEYS = ("prefix_hits", "prefix_misses", "cow_copies",
               "prefix_cached_tokens", "prefill_tokens", "prefix_evictions",
               "preemptions")


def _same_metrics(jeng, teng, keys=PREFIX_KEYS):
    jm, tm = jeng.metrics(), teng.metrics()
    assert {k: tm[k] for k in keys} == {k: jm[k] for k in keys}
    return tm


def test_warm_equals_cold_sequential(weights):
    """Sequential requests sharing a 48-token prefix: the first donates on
    free, the rest admit warm. Streams equal JAX's and the port's own
    cache-off engine's; the hits skipped prefill work."""
    prompts = _shared_prefix(0, 48, (5, 9, 13, 7, 11))
    jeng, teng = _engines(weights)
    jout = [_drive(jeng, [jeng.submit(p, max_tokens=6)])[0] for p in prompts]
    tout = [_drive(teng, [teng.submit(p, max_tokens=6)])[0] for p in prompts]
    assert tout == jout
    _, tp = weights
    cold = LLMEngine(TCFG, tp, kv_mode="paged", n_slots=4, max_len=128,
                     page_size=16,
                     prefill_chunk=16, prefill_token_budget=32,
                     device="cpu")
    assert [_drive(cold, [cold.submit(p, max_tokens=6)])[0]
            for p in prompts] == tout
    m = _same_metrics(jeng, teng)
    assert m["prefix_hits"] >= len(prompts) - 1
    assert m["prefill_tokens"] < cold.metrics()["prefill_tokens"]
    assert "ttft_warm_ms_p50" in m and "ttft_cold_ms_p50" in m
    assert 0 < m["prefix_cache_hit_rate"] <= 1
    acc = _closure(teng)
    assert acc["cached_only"] > 0 and acc["live"] == 0


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_cow_divergence_matches_jax(weights, kv_dtype):
    """Chunk 12 on pages of 8 (tests/test_prefix_cache.py:101 and, int8,
    tests/test_quant.py:227): every warm bind lands mid-page and copies
    its tail page (int8: codes and scales) before the cold suffix writes
    on. Two waves of three requests; streams equal JAX's."""
    prompts = _shared_prefix(6, 44, (6, 6, 6))
    jeng, teng = _engines(weights, page_size=8, prefill_chunk=12,
                          prefill_token_budget=24, kv_dtype=kv_dtype)
    for eng in (jeng, teng):
        eng.outs = [_drive(eng, [eng.submit(p, max_tokens=8)
                                 for p in prompts]) for _wave in range(2)]
    assert teng.outs == jeng.outs
    m = _same_metrics(jeng, teng)
    assert m["cow_copies"] > 0 and m["prefix_hits"] > 0
    _closure(teng)


def test_concurrent_sharing_matches_jax(weights):
    """Several live slots bound to the same cached pages at once
    (refcount > 1), the closure checked after every tick."""
    prompts = _shared_prefix(5, 48, (5, 9, 13, 7))
    jeng, teng = _engines(weights)
    seen = []

    def check(eng):
        seen.append(_closure(eng)["shared"])

    outs = []
    for eng, tick in ((jeng, None), (teng, check)):
        first = _drive(eng, [eng.submit(prompts[0], max_tokens=8)])
        outs.append(first + _drive(eng, [eng.submit(p, max_tokens=8)
                                         for p in prompts[1:]],
                                   each_tick=tick))
    assert outs[1] == outs[0]
    assert max(seen) > 0, "pages were never shared mid-flight"
    assert _same_metrics(jeng, teng)["prefix_hits"] >= 3
    _closure(teng)


def test_preempt_with_shared_pages_matches_jax(weights):
    """Warm slots under preempt-by-recompute (9 pages of 4): preempted
    requests re-enter, re-admit warm or cold, and the streams and
    preemption counts equal JAX's."""
    prompts = _shared_prefix(13, 16, (3, 2, 5, 4))
    jeng, teng = _engines(weights, max_len=64, page_size=4, n_pages=9,
                          prefill_chunk=4, prefill_token_budget=8,
                          prefix_cache_pages=4)
    outs = []
    for eng in (jeng, teng):
        first = _drive(eng, [eng.submit(prompts[0], max_tokens=10)])
        outs.append(first + _drive(
            eng, [eng.submit(p, max_tokens=10) for p in prompts[1:]],
            each_tick=_closure if eng is teng else None))
    assert outs[1] == outs[0]
    assert _same_metrics(jeng, teng)["preemptions"] > 0
    _closure(teng)


def test_eviction_before_preemption_matches_jax(weights):
    """A pool where cached pages must be reclaimed for new work: LRU
    entries go, nothing is preempted, the budget holds."""
    rng = np.random.default_rng(11)
    prompts = [list(map(int, rng.integers(1, TCFG.vocab_size, 48)))
               for _ in range(4)]
    jeng, teng = _engines(weights, n_slots=2, max_len=64, page_size=8,
                          n_pages=14, prefill_chunk=8,
                          prefill_token_budget=16, prefix_cache_pages=12)
    outs = []
    for eng in (jeng, teng):
        outs.append([_drive(eng, [eng.submit(p, max_tokens=4)])[0]
                     for p in prompts])
        if eng is teng:
            _closure(eng)
    assert outs[1] == outs[0]
    m = _same_metrics(jeng, teng)
    assert m["prefix_evictions"] > 0 and m["preemptions"] == 0
    assert teng.prefix_cache.n_pages_cached() <= 12
    assert m["prefix_cache_pages_budget"] == 12
