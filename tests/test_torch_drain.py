"""PyTorch port vs the JAX package: the drain protocol and resume.

After tests/test_chaos.py:90-215 (`TestEngineDrain`), on the port's
``LLMEngine`` in every mode (dense one-shot, paged one-shot, paged
chunked): `drain` lets in-flight requests finish and then rejects
submits; ``drain(0.0)`` exports exact continuations whose teacher-forced
resume (`submit(generated_ids=...)`) is byte-identical to the
uninterrupted run, with the stream cursor spliced exactly (no token
emitted twice) and the page accounting closed; already-complete and
outgrown continuations finish at submit; a preempted request exports its
original prompt. Then the compositions: a continuation re-resolves
against the destination's prefix cache (tests/test_prefix_cache.py:214),
a speculative engine exports accepted tokens only
(tests/test_spec_decode.py:228), the memoized chunk hashes ride the
continuation and spare the destination the re-hash
(tests/test_kv_objects.py:288); and across the packages: a continuation
drained from the port resumes on the JAX engine, and JAX's on the port,
with equal streams.

Tiny config, fp32, greedy streams exact; engines driven by step() except
where the protocol needs the engine thread.
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
from ray_tpu_torch.serve import prefix_cache as tpc
from ray_tpu_torch.serve.llm import LLMEngine

JCFG = jgpt.GPTConfig.tiny(dtype=jnp.float32)
TCFG = tgpt.GPTConfig.tiny(dtype=torch.float32)
DRAFT = dict(n_layers=1, d_model=32, n_heads=4, d_ff=64)
TDRAFT = tgpt.GPTConfig.tiny(dtype=torch.float32, **DRAFT)
JDRAFT = jgpt.GPTConfig.tiny(dtype=jnp.float32, **DRAFT)
CHUNK = 16


def _bridge(jp, cfg):
    return params_from_jax({k: np.asarray(v) for k, v in jp.items()}, cfg,
                           device="cpu")


@pytest.fixture(scope="module")
def weights():
    jp = jgpt.init_params(JCFG, jax.random.key(42))
    return jp, _bridge(jp, TCFG)


MODES = {
    "dense": dict(kv_mode="dense"),
    "oneshot": dict(kv_mode="paged", page_size=16),
    "chunked": dict(kv_mode="paged", page_size=16, prefill_chunk=CHUNK,
                    prefill_token_budget=32),
}


def _mk(weights, mode="dense", **kw):
    """The port's engine of the reference's drain tests: two slots, 64
    positions, buckets (8, 16, 32), windows of 2."""
    _, tp = weights
    base = dict(n_slots=2, max_len=64, prefill_buckets=(8, 16, 32),
                decode_block=2, device="cpu", **MODES[mode])
    base.update(kw)
    return LLMEngine(TCFG, tp, **base)


def _drive(eng, reqs, max_steps=800):
    for _ in range(max_steps):
        if all(r.done.is_set() for r in reqs):
            break
        eng.step()
    assert all(r.done.is_set() for r in reqs)
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    return [r.out_ids for r in reqs]


def _streamed(req):
    out = []
    while (t := req.stream.get(timeout=5)) is not None:
        out.append(t)
    return out


def _resume(eng, c, **kw):
    return eng.submit(c["prompt_ids"], max_tokens=c["max_tokens"],
                      temperature=c["temperature"], eos_id=c["eos_id"],
                      generated_ids=c["generated_ids"],
                      request_id=c["request_id"], **kw)


def _closed(eng):
    if eng.kv_mode == "paged":
        acc = eng.page_accounting()
        assert acc["closure"] and acc["refs_consistent"] and acc["live"] == 0
        assert acc["free"] + acc["cached_only"] == acc["total"]


@pytest.mark.parametrize("mode", list(MODES))
def test_drain_lets_inflight_finish(weights, mode):
    eng = _mk(weights, mode)
    eng.start()
    try:
        req = eng.submit([5, 9, 2], max_tokens=6)
        out = eng.drain(30.0)
    finally:
        eng.stop()
    assert out == {"drained": True, "exported": 0, "continuations": []}
    assert req.done.is_set() and not req.migrated
    assert len(req.out_ids) == 6 and req.error is None
    with pytest.raises(RuntimeError, match="replica draining"):
        eng.submit([1], max_tokens=1)
    _closed(eng)


@pytest.mark.parametrize("mode", list(MODES))
def test_drain_timeout_exports_exact_continuations(weights, mode):
    """Two requests decoding in the two slots and a third still queued
    are exported; resumed on a fresh engine of the same mode, each equals
    its uninterrupted run."""
    prompts = [[5, 9, 2], [7, 1], [4, 4, 4]]
    base = _mk(weights, mode)
    full = [_drive(base, [base.submit(p, max_tokens=12)])[0]
            for p in prompts]
    eng = _mk(weights, mode)
    req, *rest = [eng.submit(p, max_tokens=12, stream=i == 0)
                  for i, p in enumerate(prompts)]
    for _ in range(3):
        eng.step()
    assert not req.done.is_set() and not rest[1].out_ids
    out = eng.drain(0.0)                 # expired window: export, no wait
    assert not out["drained"] and out["exported"] == 3
    assert req.migrated and req.done.is_set() and req.error is None
    assert all(r.migrated and r.done.is_set() for r in rest)
    assert _streamed(req) == req.out_ids
    _closed(eng)
    c = out["continuations"][0]
    assert c["request_id"] == req.request_id
    assert c["prompt_ids"] == [5, 9, 2]
    assert c["generated_ids"] == req.out_ids == full[0][:len(req.out_ids)]
    assert c["max_tokens"] == 12 and c["temperature"] == 0.0
    # Teacher-forced resume on a fresh engine of the same mode: the tokens
    # already emitted are seeded, never emitted again, and the stream
    # continues exactly where it stopped.
    dst = _mk(weights, mode)
    resumed = [_resume(dst, q, stream=True) for q in out["continuations"]]
    n_seeded = len(resumed[0].out_ids)
    assert resumed[0].out_ids == req.out_ids
    assert _drive(dst, resumed) == full
    assert _streamed(resumed[0]) == full[0][n_seeded:]
    _closed(dst)


def test_already_complete_continuation_finishes_cleanly(weights):
    eng = _mk(weights)
    r = eng.submit([5, 9], max_tokens=4, generated_ids=[1, 2, 3, 4],
                   stream=True)
    assert r.done.is_set() and r.error is None and not r.truncated
    assert r.out_ids == [1, 2, 3, 4] and r.stream.get(timeout=1) is None
    r2 = eng.submit([5, 9], max_tokens=8, eos_id=3, generated_ids=[1, 2, 3])
    assert r2.done.is_set() and r2.out_ids == [1, 2, 3]
    assert eng.metrics()["completed"] == 2


@pytest.mark.parametrize("mode", ["dense", "oneshot"])
def test_overgrown_continuation_truncates_not_errors(weights, mode):
    """prompt + emitted can outgrow a one-shot engine's bucket cap: the
    resume ends the stream (truncated), while a FRESH oversized prompt
    still raises."""
    eng = _mk(weights, mode, prefill_buckets=(8,))
    r = eng.submit([1] * 6, max_tokens=16, generated_ids=[2, 3, 4])
    assert r.done.is_set() and r.truncated and r.error is None
    assert r.out_ids == [2, 3, 4]
    with pytest.raises(ValueError, match="prompt too long"):
        eng.submit([1] * 12, max_tokens=4)


@pytest.mark.parametrize("mode", ["oneshot", "chunked"])
def test_preempted_request_exports_original_prompt(weights, mode):
    """After preempt-by-recompute prompt_ids is prompt + generated: the
    export still splits at the ORIGINAL prompt, and the resume is exact."""
    base = _mk(weights, mode)
    full = _drive(base, [base.submit([5, 9, 2], max_tokens=8)])[0]
    eng = _mk(weights, mode)
    req = eng.submit([5, 9, 2], max_tokens=8)
    for _ in range(2):
        eng.step()
    eng._preempt(next(s for s, r in enumerate(eng.slot_req) if r is req))
    out = eng.drain(0.0)
    c = out["continuations"][0]
    assert c["prompt_ids"] == [5, 9, 2]
    assert c["generated_ids"] == req.out_ids and req.out_ids
    _closed(eng)
    dst = _mk(weights, mode)
    assert _drive(dst, [_resume(dst, c)])[0] == full


def _shared(seed, shared_len, suffixes):
    rng = np.random.default_rng(seed)
    shared = list(map(int, rng.integers(1, TCFG.vocab_size, shared_len)))
    return [shared + list(map(int, rng.integers(1, TCFG.vocab_size, n)))
            for n in suffixes]


def _paged(weights, **kw):
    _, tp = weights
    base = dict(n_slots=4, max_len=128, kv_mode="paged", page_size=16,
                prefill_chunk=CHUNK, prefill_token_budget=32, device="cpu")
    base.update(kw)
    return LLMEngine(TCFG, tp, **base)


def test_drain_migration_re_resolves_on_destination(weights):
    """A continuation drained off a replica with the prefix cache re-
    resolves against the DESTINATION's cache (primed by its own completed
    run of a prompt sharing 48 tokens) and resumes warm and exact; the
    source's accounting closes with its cached pages."""
    prompts = _shared(17, 48, (5, 9))
    ref_eng = _paged(weights)
    ref = [_drive(ref_eng, [ref_eng.submit(p, max_tokens=12)])[0]
           for p in prompts]
    dst = _paged(weights, prefix_cache=True)
    assert _drive(dst, [dst.submit(prompts[0], max_tokens=12)])[0] == ref[0]
    src = _paged(weights, prefix_cache=True)
    req = src.submit(prompts[1], max_tokens=12)
    while len(req.out_ids) < 4:
        src.step()
    out = src.drain(0.0)
    assert out["exported"] == 1 and req.migrated
    _closed(src)
    resumed = _resume(dst, out["continuations"][0])
    _drive(dst, [resumed])
    assert resumed.out_ids == ref[1]
    assert resumed.cached_tokens > 0
    _closed(dst)


def test_continuations_carry_only_accepted_tokens(weights):
    """Drained mid-speculation: every exported generated_ids is a prefix
    of the uninterrupted greedy stream (no unverified draft token leaves
    the engine), and the resumes elsewhere complete it exactly."""
    jdraft = jgpt.init_params(JDRAFT, jax.random.key(7))
    rng = np.random.default_rng(5)
    prompts = [list(map(int, rng.integers(1, TCFG.vocab_size, n)))
               for n in (13, 26, 8)]
    base = _paged(weights)
    full = _drive(base, [base.submit(p, max_tokens=20) for p in prompts])
    eng = _paged(weights, spec_draft=TDRAFT,
                 spec_draft_params=_bridge(jdraft, TDRAFT), spec_k=4)
    reqs = [eng.submit(p, max_tokens=20) for p in prompts]
    for _ in range(4):
        eng.step()
    out = eng.drain(0.0)
    assert out["exported"] == sum(not r.finished_at for r in reqs) > 0
    _closed(eng)
    conts = {tuple(c["prompt_ids"]): c for c in out["continuations"]}
    resume = _paged(weights)
    resumed = []
    for i, p in enumerate(prompts):
        c = conts.get(tuple(p))
        if c is not None:
            assert c["generated_ids"] == full[i][:len(c["generated_ids"])]
            resumed.append((i, _resume(resume, c)))
    _drive(resume, [r for _i, r in resumed])
    for i, r in resumed:
        assert r.out_ids == full[i]


def test_continuation_carries_memoized_hashes(weights, monkeypatch):
    """Chunked exports carry the request's memoized chunk-hash chain (hex)
    and its chunk; the destination seeds its memo from them and hashes
    only chunks past it (admission and insert-on-free together)."""
    rng = np.random.default_rng(1)
    prompt = list(map(int, rng.integers(1, TCFG.vocab_size, 50)))
    src = _paged(weights, prefix_cache=True, max_len=256)
    req = src.submit(prompt, max_tokens=24)
    for _ in range(5):
        src.step()
    assert not req.done.is_set()
    (cont,) = src.drain(0.0)["continuations"]
    assert cont["prefix_chunk"] == CHUNK
    assert cont["prefix_hashes"] == [h.hex() for h in req.prefix_hashes]
    assert cont["prefix_hashes"]
    context = cont["prompt_ids"] + cont["generated_ids"]
    assert [bytes.fromhex(h) for h in cont["prefix_hashes"]] == (
        tpc.chunk_hashes(context, CHUNK)[:len(cont["prefix_hashes"])])
    dst = _paged(weights, prefix_cache=True, max_len=256)
    calls = {"n": 0}
    real = tpc.hashlib.blake2b

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(tpc.hashlib, "blake2b", counting)
    r = _resume(dst, cont, prefix_hashes=cont["prefix_hashes"],
                prefix_chunk=cont["prefix_chunk"])
    assert len(r.prefix_hashes) == len(cont["prefix_hashes"])
    _drive(dst, [r])
    assert calls["n"] < len(context) // CHUNK, calls["n"]


def test_wrong_chunk_memo_is_dropped(weights):
    eng = _paged(weights, prefix_cache=True)
    req = eng.submit(list(range(1, 41)), max_tokens=2,
                     prefix_hashes=["ab" * 16], prefix_chunk=CHUNK + 8)
    assert req.prefix_hashes == []
    bad = eng.submit(list(range(1, 41)), max_tokens=2,
                     prefix_hashes=["not hex"], prefix_chunk=CHUNK)
    assert bad.prefix_hashes == []
    _drive(eng, [req, bad])


@pytest.mark.parametrize("mode", ["dense", "chunked"])
def test_continuations_cross_the_packages(weights, mode):
    """A continuation drained from the port resumes on the JAX engine, and
    one drained from the JAX engine resumes on the port: both complete
    the uninterrupted stream."""
    jp, _ = weights
    kw = dict(n_slots=2, max_len=64, prefill_buckets=(8, 16, 32),
              decode_block=2, **MODES[mode])
    prompt = [5, 9, 2, 11]
    jax_eng = lambda: JaxEngine(JCFG, jp, attn_impl="gather", **kw)
    full = _drive(ref := jax_eng(), [ref.submit(prompt, max_tokens=12)])[0]
    for src, dst in ((_mk(weights, mode), jax_eng()),
                     (jax_eng(), _mk(weights, mode))):
        req = src.submit(prompt, max_tokens=12)
        for _ in range(3):
            src.step()
        (c,) = src.drain(0.0)["continuations"]
        assert 0 < len(c["generated_ids"]) < 12
        r = _resume(dst, c)
        assert _drive(dst, [r])[0] == full
