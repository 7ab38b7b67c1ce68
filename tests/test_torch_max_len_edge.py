"""The port's repair of a crash the JAX paged engine keeps: a fused
decode window that leaves a paged slot's cursor AT ``max_len``.

`_pick_window` bounds a window by ``max_len - max(positions)``, so a
window can end a slot at ``max_len``. The reference's next tick grows
that slot to cover position ``max_len``, which, when ``max_len`` is a
multiple of the page size, is one page past its table: `_grow_slot`
raises IndexError and the engine thread dies. The port finishes such a
slot truncated before it fits the window's pages, as the dense engine
does (no token for the step that would write at ``max_len``).

Input: tiny, one slot, ``max_len`` 64, prompt ``[1, 2, 3, 4]``,
``max_tokens`` 100, paged one-shot and chunked (chunk 16), float and
int8 KV, page sizes 16 and 8. The port's stream is the 61 tokens of the
port's and the JAX package's dense engines, finished truncated without
error; its first tokens equal the JAX paged engine's up to that engine's
IndexError, which is asserted so the recorded difference stays pinned;
the page accounting closes. The speculative tick cannot reach the edge
(it finishes a slot at ``max_len - 1`` and bounds its proposals below
the cache), which the spec case pins against the JAX spec engine.
Greedy, fp32.
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
from ray_tpu_torch.serve.llm import LLMEngine

JCFG = jgpt.GPTConfig.tiny(dtype=jnp.float32)
TCFG = tgpt.GPTConfig.tiny(dtype=torch.float32)
DRAFT = dict(n_layers=1, d_model=32, n_heads=4, d_ff=64)
PROMPT, MAX_LEN, MAX_TOKENS = [1, 2, 3, 4], 64, 100
# Prompt tokens emit one token at prefill; the cursor then walks from 4
# to max_len, one token per written position.
EXPECTED = MAX_LEN - len(PROMPT) + 1


def _bridge(jp, cfg):
    return params_from_jax({k: np.asarray(v) for k, v in jp.items()}, cfg,
                           device="cpu")


@pytest.fixture(scope="module")
def weights():
    jp = jgpt.init_params(JCFG, jax.random.key(42))
    return jp, _bridge(jp, TCFG)


def _serve(eng):
    req = eng.submit(PROMPT, max_tokens=MAX_TOKENS)
    for _ in range(400):
        if req.done.is_set():
            break
        eng.step()
    return req


@pytest.fixture(scope="module")
def dense(weights):
    jp, tp = weights
    out = []
    for eng in (JaxEngine(JCFG, jp, n_slots=1, max_len=MAX_LEN,
                          kv_mode="dense"),
                LLMEngine(TCFG, tp, n_slots=1, max_len=MAX_LEN,
                          kv_mode="dense", device="cpu")):
        req = _serve(eng)
        assert req.done.is_set() and req.truncated and req.error is None
        out.append(req.out_ids)
    assert out[0] == out[1] and len(out[0]) == EXPECTED
    return out[0]


def _closed(eng):
    acc = eng.page_accounting()
    assert acc["closure"] and acc["refs_consistent"], acc
    assert acc["live"] == 0 and acc["free"] == acc["total"], acc


@pytest.mark.parametrize("page_size", [16, 8])
@pytest.mark.parametrize("kv", ["bf16", "int8"], ids=["float", "int8"])
@pytest.mark.parametrize("chunk", [0, 16], ids=["oneshot", "chunked"])
def test_window_ending_at_max_len_finishes_truncated(weights, dense, chunk,
                                                     kv, page_size):
    jp, tp = weights
    kw = dict(n_slots=1, max_len=MAX_LEN, kv_mode="paged",
              page_size=page_size, prefill_chunk=chunk, kv_dtype=kv)
    assert MAX_LEN % page_size == 0
    eng = LLMEngine(TCFG, tp, device="cpu", **kw)
    req = _serve(eng)
    assert req.done.is_set() and req.error is None and req.truncated
    assert req.out_ids == dense
    assert eng.metrics()["completed"] == 1
    _closed(eng)
    # The reference dies at the same edge, having emitted the same tokens.
    jeng = JaxEngine(JCFG, jp, attn_impl="gather", **kw)
    jreq = jeng.submit(PROMPT, max_tokens=MAX_TOKENS)
    with pytest.raises(IndexError, match="out of bounds"):
        for _ in range(400):
            jeng.step()
    assert jreq.out_ids == req.out_ids[:len(jreq.out_ids)]
    assert len(jreq.out_ids) == EXPECTED


def test_speculative_tick_never_reaches_the_edge(weights):
    jp, tp = weights
    jd = jgpt.init_params(jgpt.GPTConfig.tiny(dtype=jnp.float32, **DRAFT),
                          jax.random.key(7))
    kw = dict(n_slots=1, max_len=MAX_LEN, kv_mode="paged", page_size=16,
              prefill_chunk=16, spec_k=4)
    jeng = JaxEngine(JCFG, jp, attn_impl="gather",
                     spec_draft=jgpt.GPTConfig.tiny(dtype=jnp.float32,
                                                    **DRAFT),
                     spec_draft_params=jd, **kw)
    teng = LLMEngine(TCFG, tp, device="cpu",
                     spec_draft=tgpt.GPTConfig.tiny(dtype=torch.float32,
                                                    **DRAFT),
                     spec_draft_params=_bridge(
                         jd, tgpt.GPTConfig.tiny(dtype=torch.float32,
                                                 **DRAFT)), **kw)
    jreq, treq = _serve(jeng), _serve(teng)
    for req in (jreq, treq):
        assert req.done.is_set() and req.error is None and req.truncated
    assert treq.out_ids == jreq.out_ids
    _closed(teng)
