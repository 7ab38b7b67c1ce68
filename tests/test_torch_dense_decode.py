"""PyTorch port vs the JAX package: the dense KV cache and its engine.

- The dense programs of ``ray_tpu_torch/models/decode.py`` against
  ``ray_tpu/models/decode.py`` on the same weights and inputs (numpy from
  a seed): `prefill` and `prefill_batch` (last-token logits and the
  cache), `decode_step`, `decode_multi` at temperature 0 (tokens equal,
  cache close), a decode step whose write falls past the cache (dropped
  in both), and prefill + decode against the JAX training forward
  position by position (tests/test_llm_serve.py:35-160), tied and untied
  heads; one batched prefill against sequential ones; a JAX dense cache
  carried over by `_bridge.pool_from_jax`.
- ``LLMEngine`` with the reference's defaults (dense KV, one-shot
  bucketed prefill): greedy streams equal the JAX dense engine's with
  independent slots, more requests than slots, mid-flight admission,
  fused windows (decode_block 8) against single steps, at ``max_len``
  capacity (tests/test_llm_serve.py:249, including a window that ends at
  ``max_len``) and with an eos; the engine thread and streaming.
- The port's engine defaults are the port's ``Config`` field defaults
  (its knobs are None sentinels read from ``runtime_config()``, as the
  JAX engine's are), and those equal the field defaults of the JAX
  package's ``Config`` dataclass (not ``runtime_config()``, which reads
  the environment) and its engine's ``prefill_buckets``; ``attn_impl``
  is "auto" by definition (ROADMAP.md queue 3).

Tiny configs, fp32. Tolerance 2e-4 (relative and absolute) on logits and
cache, the reference's own for these checks; greedy streams exact. The
dense path launches no kernel: every paged launch counter stays 0.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.core.config import Config
from ray_tpu.models import decode as jdec
from ray_tpu.models import gpt as jgpt
from ray_tpu.serve.llm import LLMEngine as JaxEngine
from ray_tpu_torch._bridge import params_from_jax, pool_from_jax
from ray_tpu_torch.core.config import Config as PortConfig
from ray_tpu_torch.models import decode as tdec
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.ops import paged_attention as tpa
from ray_tpu_torch.serve.llm import LLMEngine

TOL = dict(rtol=2e-4, atol=2e-4)
CFGS = {
    "tiny": (jgpt.GPTConfig.tiny(dtype=jnp.float32),
             tgpt.GPTConfig.tiny(dtype=torch.float32)),
    "tiny_untied": (jgpt.GPTConfig.tiny_untied(dtype=jnp.float32),
                    tgpt.GPTConfig.tiny_untied(dtype=torch.float32)),
}
JCFG, TCFG = CFGS["tiny"]


def _bridge(jp, cfg):
    return params_from_jax({k: np.asarray(v) for k, v in jp.items()}, cfg,
                           device="cpu")


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, (jc, tc) in CFGS.items():
        jp = jgpt.init_params(jc, jax.random.key(42))
        out[name] = (jc, tc, jp, _bridge(jp, tc))
    return out


@pytest.fixture(scope="module")
def weights(models):
    return models["tiny"][2:]


@pytest.fixture(autouse=True)
def _no_launches():
    tpa.reset_launch_counts()
    yield
    assert tpa.paged_attention.launches == 0
    assert tpa.paged_prefill_attention.launches == 0


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _cache_close(tcache, jcache):
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)


def _prompts(seed, lengths, vocab=TCFG.vocab_size):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, vocab, n))) for n in lengths]


def _padded(prompts, bucket):
    out = np.zeros((len(prompts), bucket), np.int32)
    for i, p in enumerate(prompts):
        out[i, :len(p)] = p
    return out


# ------------------------------------------------------------- programs

@pytest.mark.parametrize("name", list(CFGS))
def test_prefill_matches_jax(models, name):
    jc, tc, jp, tp = models[name]
    prompt = _prompts(1, (5,))[0]
    toks = _padded([prompt], 8)
    jl, jcache = jdec.prefill(jc, jp, jnp.asarray(toks),
                              jdec.init_kv_cache(jc, 3, 32), jnp.int32(1),
                              jnp.int32(5))
    tcache = tdec.init_kv_cache(tc, 3, 32, device="cpu")
    tl, out = tdec.prefill(tc, tp, _t(toks), tcache, 1, 5)
    assert out is tcache and tl.shape == (tc.vocab_size,)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _cache_close(tcache, jcache)


def test_prefill_batch_matches_jax_and_sequential(weights):
    jp, tp = weights
    prompts = _prompts(5, (3, 7, 5))
    toks = _padded(prompts, 8)
    lengths = np.array([len(p) for p in prompts], np.int32)
    slots = np.array([1, 3, 2], np.int32)
    jl, jcache = jdec.prefill_batch(JCFG, jp, jnp.asarray(toks),
                                    jdec.init_kv_cache(JCFG, 4, 32),
                                    jnp.asarray(slots), jnp.asarray(lengths))
    bat = tdec.init_kv_cache(TCFG, 4, 32, device="cpu")
    tl, _ = tdec.prefill_batch(TCFG, tp, _t(toks), bat, _t(slots),
                               _t(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _cache_close(bat, jcache)
    seq = tdec.init_kv_cache(TCFG, 4, 32, device="cpu")
    rows = [tdec.prefill(TCFG, tp, _t(toks[i:i + 1]), seq, int(slots[i]),
                         int(lengths[i]))[0] for i in range(3)]
    np.testing.assert_allclose(tl.numpy(), torch.stack(rows).numpy(), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(bat[name].numpy(), seq[name].numpy(),
                                   **TOL)


def _prefilled(jc, tc, jp, tp, n_slots=4, max_len=32):
    """Both caches after a prefill_batch of three prompts into slots 0-2
    (slot 3 idle). → (jcache, tcache, next tokens, positions)."""
    prompts = _prompts(6, (3, 8, 6), tc.vocab_size)
    toks = _padded(prompts, 8)
    lengths = np.array([len(p) for p in prompts], np.int32)
    slots = np.arange(3, dtype=np.int32)
    jl, jcache = jdec.prefill_batch(jc, jp, jnp.asarray(toks),
                                    jdec.init_kv_cache(jc, n_slots, max_len),
                                    jnp.asarray(slots), jnp.asarray(lengths))
    tcache = tdec.init_kv_cache(tc, n_slots, max_len, device="cpu")
    tdec.prefill_batch(tc, tp, _t(toks), tcache, _t(slots), _t(lengths))
    nxt = np.zeros(n_slots, np.int32)
    nxt[:3] = np.argmax(np.asarray(jl), axis=-1)
    pos = np.zeros(n_slots, np.int32)
    pos[:3] = lengths
    return jcache, tcache, nxt, pos


@pytest.mark.parametrize("name", list(CFGS))
def test_decode_step_matches_jax(models, name):
    jc, tc, jp, tp = models[name]
    jcache, tcache, nxt, pos = _prefilled(jc, tc, jp, tp)
    jl, jcache = jdec.decode_step(jc, jp, jnp.asarray(nxt), jcache,
                                  jnp.asarray(pos))
    tl, out = tdec.decode_step(tc, tp, _t(nxt), tcache, _t(pos))
    assert out is tcache
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _cache_close(tcache, jcache)


def test_decode_multi_greedy_matches_jax(weights):
    jp, tp = weights
    jcache, tcache, nxt, pos = _prefilled(JCFG, TCFG, jp, tp)
    jo, jcache = jdec.decode_multi(JCFG, jp, jnp.asarray(nxt), jcache,
                                   jnp.asarray(pos), 6, jnp.zeros(4),
                                   jax.random.key(0))
    to, tcache = tdec.decode_multi(TCFG, tp, _t(nxt), tcache, _t(pos), 6,
                                   torch.zeros(4), torch.Generator())
    assert to.dtype == torch.int32 and to.shape == (6, 4)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    _cache_close(tcache, jcache)


def test_decode_write_past_the_cache_is_dropped(weights):
    """A slot whose window ended at max_len runs one more step at
    position T before the engine finishes it: JAX drops that write, and
    so does the port (the other slots' writes land)."""
    jp, tp = weights
    jcache, tcache, nxt, pos = _prefilled(JCFG, TCFG, jp, tp, max_len=16)
    pos[3] = 16
    before = tcache["k"][:, 3].clone()
    jl, jcache = jdec.decode_step(JCFG, jp, jnp.asarray(nxt), jcache,
                                  jnp.asarray(pos))
    tl, _ = tdec.decode_step(TCFG, tp, _t(nxt), tcache, _t(pos))
    assert torch.equal(tcache["k"][:, 3], before)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _cache_close(tcache, jcache)


@pytest.mark.parametrize("name", list(CFGS))
def test_decode_matches_full_forward(models, name):
    """Prefill + decode logits equal the JAX training forward's at every
    position (the cache path against the no-cache path)."""
    jc, tc, jp, tp = models[name]
    seq = [5, 9, 2, 7, 11]
    cache = tdec.init_kv_cache(tc, 3, 64, device="cpu")
    last, _ = tdec.prefill(tc, tp, _t(_padded([seq], 8)), cache, 1, len(seq))
    full = jgpt.forward(jp, jnp.asarray([seq]), jc)
    np.testing.assert_allclose(last.numpy(), np.asarray(full[0, -1]), **TOL)
    tokens, positions = np.zeros(3, np.int32), np.zeros(3, np.int32)
    for _ in range(4):
        seq.append(int(torch.argmax(last)))
        tokens[1], positions[1] = seq[-1], len(seq) - 1
        logits, _ = tdec.decode_step(tc, tp, _t(tokens), cache,
                                     _t(positions))
        last = logits[1]
        full = jgpt.forward(jp, jnp.asarray([seq]), jc)
        np.testing.assert_allclose(last.numpy(), np.asarray(full[0, -1]),
                                   **TOL)


def test_pool_from_jax_carries_a_dense_cache(weights):
    jp, _ = weights
    jcache = jdec.init_kv_cache(JCFG, 2, 16)
    jcache = {k: v + 0.5 for k, v in jcache.items()}
    tcache = pool_from_jax({k: np.asarray(v) for k, v in jcache.items()},
                           TCFG, device="cpu")
    assert tcache["k"].shape == (JCFG.n_layers, 2, 16, JCFG.n_heads,
                                 JCFG.head_dim)
    assert tcache["k"].dtype == TCFG.dtype
    _cache_close(tcache, jcache)


# --------------------------------------------------------------- engine

def _drive(eng, reqs, max_steps=800):
    for _ in range(max_steps):
        if all(r.done.is_set() for r in reqs):
            break
        eng.step()
    assert all(r.done.is_set() for r in reqs)
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    return [r.out_ids for r in reqs]


def _engines(weights, **kw):
    jp, tp = weights
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("prefill_buckets", (8,))
    return (JaxEngine(JCFG, jp, kv_mode="dense", **kw),
            LLMEngine(TCFG, tp, device="cpu", **kw))


def _same_streams(weights, prompts, *, max_tokens, **kw):
    jeng, teng = _engines(weights, **kw)
    jout = _drive(jeng, [jeng.submit(p, max_tokens=max_tokens)
                         for p in prompts])
    tout = _drive(teng, [teng.submit(p, max_tokens=max_tokens)
                         for p in prompts])
    assert tout == jout
    return tout, teng


def test_defaults_build_a_dense_one_shot_engine(weights):
    _, tp = weights
    eng = LLMEngine(TCFG, tp, max_len=64, device="cpu")
    assert (eng.kv_mode, eng.prefill_chunk) == ("dense", 0)
    assert eng.buckets == (32,) and eng._prompt_cap == 32
    assert eng.cache["k"].shape == (TCFG.n_layers, 8, 64, TCFG.n_heads,
                                    TCFG.head_dim)
    assert not hasattr(eng, "free_pages")
    m = eng.metrics()
    assert "kv_pages_total" not in m and "prefill_chunk" not in m


def test_port_defaults_equal_the_reference_config():
    """Every engine knob the port has defaults as the JAX package's
    Config dataclass field (tp and warmup are the features' off values):
    both engines' signatures hold None for each and read the knob from
    their runtime's Config, whose fields agree; kv_transfer resolves to
    the Config field's value in an engine built with the defaults;
    attn_impl differs by definition, in the port's Config default."""
    fields = {f.name: f.default for f in dataclasses.fields(Config)}
    port_fields = {f.name: f.default
                   for f in dataclasses.fields(PortConfig)}
    sig = inspect.signature(LLMEngine.__init__).parameters
    ref = inspect.signature(JaxEngine.__init__).parameters
    knob_of = {"decode_block": "llm_decode_block", "kv_mode": "llm_kv_mode",
               "page_size": "llm_kv_page_size",
               "prefill_chunk": "llm_prefill_chunk",
               "prefill_token_budget": "llm_prefill_token_budget",
               "prefill_width_bucketing": "llm_prefill_width_bucketing",
               "prefix_cache": "llm_prefix_cache",
               "prefix_cache_pages": "llm_prefix_cache_pages",
               "spec_k": "llm_spec_k", "tp": "llm_tp",
               "weight_dtype": "llm_weight_dtype",
               "kv_dtype": "llm_kv_dtype",
               "warmup": "llm_warmup_compile"}
    port = {k: port_fields[f] for k, f in knob_of.items()}
    assert port == {k: fields[f] for k, f in knob_of.items()}
    for k in (*knob_of, "attn_impl", "kv_transfer", "pool_role",
              "spec_draft"):
        assert sig[k].default is None and ref[k].default is None, k
    eng = LLMEngine(TCFG, None, kv_mode="paged", prefill_chunk=8,
                    page_size=8, max_len=32, n_slots=1, device="cpu")
    assert eng.kv_transfer is fields["llm_kv_transfer"] is False
    assert eng.tp == 1 and eng.decode_block == fields["llm_decode_block"]
    assert not port_fields["llm_spec_draft"] and not fields["llm_spec_draft"]
    for k in ("n_slots", "max_len", "seed", "prefill_buckets"):
        assert sig[k].default == ref[k].default, k
    assert (port_fields["llm_attn_impl"] == "auto"
            and fields["llm_attn_impl"] == "gather")


def test_slots_are_independent(weights):
    """Two prompts in adjacent slots give what each gives alone, and the
    JAX dense engine's streams."""
    prompts = [[5, 9, 2], [17, 3]]
    both, _ = _same_streams(weights, prompts, max_tokens=5)
    for p, out in zip(prompts, both):
        alone, _ = _same_streams(weights, [p], max_tokens=5, n_slots=1)
        assert alone == [out]


def test_more_requests_than_slots(weights):
    out, eng = _same_streams(weights, [[3 + i] for i in range(5)],
                             max_tokens=3)
    assert all(len(o) == 3 for o in out)
    m = eng.metrics()
    assert m["completed"] == 5 and m["active_slots"] == 0


def test_midflight_admission(weights):
    """A request joining while another decodes leaves the first one's
    stream as it is alone; both engines admit it at the same tick."""
    jeng, teng = _engines(weights)
    outs = []
    for eng in (jeng, teng):
        r1 = eng.submit([5, 9, 2], max_tokens=8)
        for _ in range(3):
            eng.step()
        r2 = eng.submit([17, 3], max_tokens=4)
        outs.append(_drive(eng, [r1, r2]))
    assert outs[1] == outs[0]
    alone, _ = _same_streams(weights, [[5, 9, 2]], max_tokens=8)
    assert outs[1][0] == alone[0]
    m = teng.metrics()
    assert m["completed"] == 2 and m["tokens_generated"] == 12


def test_fused_windows_match_single_steps(weights):
    prompts = _prompts(7, (3, 6))
    fused, eng = _same_streams(weights, prompts, max_tokens=16,
                               decode_block=8)
    single, _ = _same_streams(weights, prompts, max_tokens=16,
                              decode_block=1)
    assert fused == single and all(len(o) == 16 for o in fused)
    m = eng.metrics()
    assert m["decode_steps"] > m["decode_windows"] > 0


@pytest.mark.parametrize("n", [3, 4, 5])
def test_max_len_finishes_cleanly(weights, n):
    """The cache bounds generation: with a 4-token prompt the fused
    window ends at max_len exactly, and the next step's write falls past
    the cache (dropped) before the slot finishes."""
    out, eng = _same_streams(weights, [list(range(1, n + 1))],
                             max_tokens=100, n_slots=1, max_len=12)
    assert 0 < len(out[0]) < 100
    assert eng.positions[0] == 0


def test_eos_stops_the_stream(weights):
    prompts = _prompts(8, (5, 3))
    out, _ = _same_streams(weights, prompts, max_tokens=6)
    eos = out[0][2]
    jeng, teng = _engines(weights)
    jr = jeng.submit(prompts[0], max_tokens=6, eos_id=eos)
    tr = teng.submit(prompts[0], max_tokens=6, eos_id=eos)
    assert _drive(teng, [tr]) == _drive(jeng, [jr])
    assert tr.out_ids[-1] == eos and len(tr.out_ids) <= 3


def test_engine_thread_and_streaming(weights):
    _, tp = weights
    eng = LLMEngine(TCFG, tp, n_slots=2, max_len=64, prefill_buckets=(8,),
                    device="cpu")
    eng.start()
    try:
        req = eng.submit([5, 9], max_tokens=6, stream=True)
        streamed = []
        while (tok := req.stream.get(timeout=60)) is not None:
            streamed.append(tok)
        assert streamed == req.out_ids and len(streamed) == 6
        assert eng.metrics()["ttft_mean_s"] > 0
    finally:
        eng.stop()
