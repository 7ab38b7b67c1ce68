"""PyTorch port vs the JAX package: the engine's load row and its
observability (`LLMEngine.load_snapshot`, the four load EWMAs, the
metric objects, the sampled spans).

Six engine modes (dense one-shot, paged one-shot, paged chunked, chunked
with the prefix cache, chunked with a speculative draft, chunked with
int8 weights and KV), each on the same seeded traffic in both engines
driven tick by tick with `step()`:

- at every tick `load_snapshot()` has the JAX engine's keys, and equal
  values for every field that does not read the clock (queue, slots,
  pool and ``kv_pool_bytes``, chunk and budget, dispatch widths, prefix
  entries, pages, hits, misses and hit rate, ``spec_k``, dtypes, and the
  budget-utilization and acceptance EWMAs, which follow from counts);
  the TTFT and decode-rate EWMAs appear on the same ticks; every
  ``llm_*`` gauge equals its field, or 0 when the field is absent;
- after the run, the decode-step and prefill-chunk histograms count the
  engine's decode windows and prefill dispatches, the per-width dispatch
  counter equals ``metrics()["prefill_dispatch_widths"]``, and the prefix
  and spec counters equal the engine's stats, with equal rows in both
  packages;
- the spans equal the JAX engine's by name, count and linkage
  (``llm.decode_window``, ``llm.spec_verify``, ``llm.ttft`` with its
  three children), with both engines' sampling periods cut to 4 and 2 so
  the sampling itself is compared;
- `reset_stats` clears the EWMAs and their gauges read 0.

The EWMA formula is held on injected samples. Tiny configs,
``attn_impl="gather"`` on both sides (one impl tag), fp32, greedy.
"""

import collections

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu import profiling as jprof
from ray_tpu.models import gpt as jgpt
from ray_tpu.serve import llm as jllm
from ray_tpu_torch import profiling as tprof
from ray_tpu_torch._bridge import params_from_jax
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.serve import llm as tllm

JCFG = jgpt.GPTConfig.tiny(dtype=jnp.float32)
TCFG = tgpt.GPTConfig.tiny(dtype=torch.float32)
DRAFT = dict(n_layers=1, d_model=32, n_heads=4, d_ff=64)
CHUNKED = dict(kv_mode="paged", page_size=8, prefill_chunk=8,
               prefill_token_budget=16)
MODES = {
    "dense": dict(kv_mode="dense"),
    "oneshot": dict(kv_mode="paged", page_size=8),
    "chunked": CHUNKED,
    "prefix": dict(CHUNKED, prefix_cache=True),
    "spec": dict(CHUNKED, spec_k=2),
    "chunked_int8": dict(CHUNKED, weight_dtype="int8", kv_dtype="int8"),
}
# Fields that read the host clock.
CLOCK = ("ttft_ewma_ms", "decode_tok_s_ewma")
EWMAS = CLOCK + ("prefill_budget_util", "spec_accepted_per_step")
HISTS = ("serve_llm_decode_step_s", "serve_llm_prefill_chunk_s")
COUNTERS = ("llm_prefill_dispatch_total", "llm_spec_proposed_total",
            "llm_spec_accepted_total", "llm_prefix_cache_hits_total",
            "llm_prefix_cache_misses_total",
            "llm_prefix_cache_evictions_total",
            "llm_prefix_cache_cow_copies_total")


def _bridge(jp, cfg):
    return params_from_jax({k: np.asarray(v) for k, v in jp.items()}, cfg,
                           device="cpu")


@pytest.fixture(scope="module")
def weights():
    jp = jgpt.init_params(JCFG, jax.random.key(42))
    jdcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32, **DRAFT)
    jd = jgpt.init_params(jdcfg, jax.random.key(7))
    tdcfg = tgpt.GPTConfig.tiny(dtype=torch.float32, **DRAFT)
    return (jp, _bridge(jp, TCFG)), (jdcfg, jd), (tdcfg, _bridge(jd, tdcfg))


@pytest.fixture(autouse=True)
def _sampled_often(monkeypatch):
    """Fresh span rings; both engines sample 1 in 4 windows and verify
    passes and 1 in 2 first tokens, so the tiny traffic exercises the
    sampling."""
    for prof in (jprof, tprof):
        monkeypatch.setattr(prof, "_events", collections.deque())
    for cls in (jllm.LLMEngine, tllm.LLMEngine):
        monkeypatch.setattr(cls, "_SPAN_SAMPLE", 4)
        monkeypatch.setattr(cls, "_TTFT_SPAN_SAMPLE", 2)


def _engines(weights, mode):
    (jp, tp), (jdcfg, jd), (tdcfg, td) = weights
    kw = dict(n_slots=2, max_len=64, prefill_buckets=(8, 16, 32),
              decode_block=4, attn_impl="gather", **MODES[mode])
    jkw, tkw = {}, {}
    if mode == "spec":
        jkw = dict(spec_draft=jdcfg, spec_draft_params=jd)
        tkw = dict(spec_draft=tdcfg, spec_draft_params=td)
    return (jllm.LLMEngine(JCFG, jp, **kw, **jkw),
            tllm.LLMEngine(TCFG, tp, device="cpu", **kw, **tkw))


def _traffic():
    """Five requests sharing a 16-token prefix (prefix hits after the
    first donations), more than the slots (a queue)."""
    rng = np.random.default_rng(5)
    shared = list(map(int, rng.integers(1, TCFG.vocab_size, 16)))
    return [shared + list(map(int, rng.integers(1, TCFG.vocab_size, n)))
            for n in (3, 9, 5, 12, 7)]


def _gauges(llm) -> dict:
    return {key: dict(g.snapshot()).get(("local",))
            for key, g in llm._LOAD_GAUGES.items()}


def _rows(prof) -> dict:
    """Observation counts of the engine's histograms and the counters'
    values, keyed by (name, tags)."""
    return {(r["name"], tuple(sorted(r["tags"].items()))): r["value"]
            for r in prof.metrics_snapshot()
            if r["name"] in HISTS + COUNTERS}


def _delta(after, before):
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v != before.get(k, 0.0)}


def _spans(prof):
    """(name, parent name) of each engine span, in recording order."""
    ev = [e for e in prof.peek_events() if e.get("cat") == "serve_llm"]
    by_id = {e["args"]["span_id"]: e["name"] for e in ev}
    return [(e["name"], by_id.get(e["args"].get("parent_span_id")))
            for e in ev]


def _checked_snapshot(eng, llm):
    snap = eng.load_snapshot()
    gauges = _gauges(llm)
    assert gauges == {k: float(snap.get(k, 0.0)) for k in gauges}, snap
    return snap


@pytest.mark.parametrize("mode", list(MODES))
def test_load_snapshot_metrics_and_spans_equal_jax(weights, mode):
    jeng, teng = _engines(weights, mode)
    before = {"jax": _rows(jprof), "torch": _rows(tprof)}
    jreqs = [jeng.submit(p, max_tokens=6) for p in _traffic()]
    treqs = [teng.submit(p, max_tokens=6) for p in _traffic()]
    seen = collections.Counter()
    for tick in range(400):
        if all(r.done.is_set() for r in jreqs + treqs):
            break
        jeng.step()
        teng.step()
        js = _checked_snapshot(jeng, jllm)
        ts = _checked_snapshot(teng, tllm)
        assert sorted(ts) == sorted(js), (tick, set(ts) ^ set(js))
        assert ({k: v for k, v in ts.items() if k not in CLOCK}
                == {k: v for k, v in js.items() if k not in CLOCK}), tick
        seen.update(k for k in ts if k in EWMAS or ts[k])
    assert all(r.error is None for r in jreqs + treqs)
    assert [r.out_ids for r in treqs] == [r.out_ids for r in jreqs]
    assert {"queue_depth", "ttft_ewma_ms", "decode_tok_s_ewma"} <= set(seen)
    if mode != "dense":
        assert seen["pool_utilization"] > 0
    if MODES[mode].get("prefill_chunk"):
        assert "prefill_budget_util" in seen
    if mode == "spec":
        assert "spec_accepted_per_step" in seen
    if mode == "prefix":
        assert seen["prefix_cache_hits"] > 0

    # The metric rows match the engine's own stats, and each other.
    delta = {"jax": _delta(_rows(jprof), before["jax"]),
             "torch": _delta(_rows(tprof), before["torch"])}
    assert delta["torch"] == delta["jax"]
    m = teng.metrics()
    impl = {"dense": "dense"}.get(mode, "paged-gather")
    by_name = collections.defaultdict(dict)
    for (name, tags), v in delta["torch"].items():
        by_name[name][tags] = v
    step_tags = (("impl", impl), ("replica", "local"))
    assert by_name["serve_llm_decode_step_s"] == {
        step_tags: m["decode_windows"]}
    if m["prefill_dispatches"]:
        assert by_name["serve_llm_prefill_chunk_s"] == {
            step_tags: m["prefill_dispatches"]}
    assert {dict(t)["width"]: v for t, v in
            by_name["llm_prefill_dispatch_total"].items()} == (
        m.get("prefill_dispatch_widths", {}))
    for name, stat in (("llm_spec_proposed_total", "spec_proposed"),
                       ("llm_spec_accepted_total", "spec_accepted"),
                       ("llm_prefix_cache_hits_total", "prefix_hits"),
                       ("llm_prefix_cache_misses_total", "prefix_misses"),
                       ("llm_prefix_cache_evictions_total",
                        "prefix_evictions"),
                       ("llm_prefix_cache_cow_copies_total", "cow_copies")):
        assert sum(by_name[name].values()) == m[stat], name

    # Spans: the same names, counts and linkage as the JAX engine's.
    tspans = _spans(tprof)
    assert tspans == _spans(jprof)
    windows = "llm.spec_verify" if mode == "spec" else "llm.decode_window"
    n_ticks = m["spec_ticks"] if mode == "spec" else m["decode_windows"]
    assert tspans.count((windows, None)) == -(-n_ticks // 4)
    roots = tspans.count(("llm.ttft", None))
    assert roots == -(-len(treqs) // 2)
    for child in ("queue_wait", "prefill", "first_token"):
        assert tspans.count((f"llm.ttft.{child}", "llm.ttft")) == roots

    # reset_stats clears the EWMAs; their gauges read 0.
    for eng, llm in ((jeng, jllm), (teng, tllm)):
        eng.reset_stats()
        snap = _checked_snapshot(eng, llm)
        assert not set(snap) & set(EWMAS)
        assert all(_gauges(llm)[k] == 0.0 for k in EWMAS
                   if k in _gauges(llm))


def test_ewma_formula_on_injected_samples():
    samples = [12.0, 3.5, 0.0, 40.25, 7.0]
    for cls in (jllm.LLMEngine, tllm.LLMEngine):
        assert cls._EWMA_ALPHA == 0.2
    prev = jprev = None
    for x in samples:
        want = x if prev is None else 0.2 * x + 0.8 * prev
        prev = tllm.LLMEngine._ewma(prev, x)
        jprev = jllm.LLMEngine._ewma(jprev, x)
        assert prev == jprev == pytest.approx(want, rel=0, abs=0)


def test_gauges_and_histogram_names_match_jax():
    assert sorted(tllm._LOAD_GAUGES) == sorted(jllm._LOAD_GAUGES)
    for name in ("_TTFT_HIST", "_DECODE_HIST", "_DECODE_STEP_HIST",
                 "_PREFILL_CHUNK_HIST", "_PREFILL_DISPATCH_COUNTER"):
        t, j = getattr(tllm, name), getattr(jllm, name)
        assert (t.name, t.kind, t.tag_keys, t.description) == (
            j.name, j.kind, j.tag_keys, j.description)
        assert getattr(t, "boundaries", None) == getattr(j, "boundaries",
                                                         None)
    for group in ("_LOAD_GAUGES", "_SPEC_COUNTERS", "_PREFIX_COUNTERS"):
        t, j = getattr(tllm, group), getattr(jllm, group)
        assert {k: (m.name, m.kind, m.tag_keys, m.description)
                for k, m in t.items()} == {
            k: (m.name, m.kind, m.tag_keys, m.description)
            for k, m in j.items()}


def test_request_metrics_equal_jax(weights):
    """`_observe_request_metrics` on the same finished request, tagged
    by `_request_metric_tags` inside a traced route."""
    from ray_tpu import tracing as jtr
    from ray_tpu_torch import tracing as ttr

    out = []
    for llm, tr, prof in ((jllm, jtr, jprof), (tllm, ttr, tprof)):
        with tr.start_span("ingress", baggage={"route": "/t9"}):
            tags = llm._request_metric_tags()
        req = llm.GenRequest(request_id="r", prompt_ids=[1], max_tokens=4,
                             temperature=0.0, eos_id=None, submitted_at=10.0,
                             first_token_at=10.25, finished_at=10.75,
                             out_ids=[5, 6, 7])
        llm._observe_request_metrics(req, tags)
        out.append((tags, sorted(
            (r["name"], r["buckets"], r["sum"])
            for r in prof.metrics_snapshot()
            if r["name"] in ("serve_llm_ttft_s", "serve_llm_decode_tok_s")
            and r["tags"].get("route") == "/t9")))
    assert out[1] == out[0]
    assert out[1][0] == {"route": "/t9", "replica": "local"}
