"""PyTorch port vs the JAX package: tensor-parallel serving.

Counterpart of tests/test_tp_decode.py. The JAX tp=2 programs and engine
run in this process on the forced host devices (tests/conftest.py); the
port's tp programs run every shard on the CPU (a mesh of the CPU twice
or four times: a device may repeat in a mesh).

- Programs: each ``*_tp`` twin of ``models/paged_kv.py`` against the JAX
  twin on the same inputs and against the port's tp=1 program: logits
  within 1e-5 + 1e-5 |ref|, greedy tokens and proposals equal, the pools
  (the shards concatenated on the head axis) within 1e-5; the page ops
  (`copy_pages_tp`, `gather_pages_tp`, `scatter_pages_tp`) exact. The
  int8 writes of a tp body (`_quant_write_shards`,
  `_quant_write_full_pages_shards`) equal the one-shard writes of the
  full rows bit for bit, every shard's scale plane included.
- Engines: greedy streams at tp=2 equal the JAX tp=2 engine's and the
  port's tp=1 engine's token for token, through chunked prefill,
  warm-prefix copy-on-write, speculative decoding at k 1 and 4,
  preemption by recompute, int8 KV (with the scale planes equal across
  shards) and a tp=2 drain resumed on a tp=1 engine; tp=4 too.
- The JAX engine's tp validation errors, the device-list rules, and the
  topology fields of `metrics`/`load_snapshot` (equal to the JAX
  engine's; none at tp=1).

Tiny config (8 heads), fp32, ``attn_impl="gather"``; every paged kernel
launch counter stays 0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import gpt as jgpt
from ray_tpu.models import paged_kv as jpk
from ray_tpu.models import partition as jpart
from ray_tpu.serve.llm import LLMEngine as JaxEngine
from ray_tpu_torch._bridge import params_from_jax, pool_from_jax
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import paged_kv as tpk
from ray_tpu_torch.models import partition as tpart
from ray_tpu_torch.ops import paged_attention as tpa
from ray_tpu_torch.serve.llm import LLMEngine

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2,
    reason="the JAX tp=2 side needs >= 2 (virtual) devices")

JCFG = jgpt.GPTConfig.tiny(dtype=jnp.float32)
TCFG = tgpt.GPTConfig.tiny(dtype=torch.float32)
JCFG_U = jgpt.GPTConfig.tiny_untied(dtype=jnp.float32)
TCFG_U = tgpt.GPTConfig.tiny_untied(dtype=torch.float32)
DRAFT = dict(n_layers=1, d_model=32, n_heads=4, d_ff=64)
JDRAFT = jgpt.GPTConfig.tiny(dtype=jnp.float32, **DRAFT)
TDRAFT = tgpt.GPTConfig.tiny(dtype=torch.float32, **DRAFT)
FP32_TOL = dict(atol=1e-5, rtol=1e-5)
CPU = torch.device("cpu")


def _bridge(jp, cfg):
    return params_from_jax({k: np.asarray(v) for k, v in jp.items()}, cfg,
                           device="cpu")


@pytest.fixture(autouse=True)
def _no_launches():
    tpa.reset_launch_counts()
    yield
    for fn in (tpa.paged_attention, tpa.paged_prefill_attention):
        assert (fn.launches, fn.int8_launches) == (0, 0)


def _concat(shards):
    """The shards of a pool as one full-head pool (k/v on the head
    axis; the scale planes, equal across shards, from shard 0)."""
    out = {}
    for name in shards[0]:
        if name.endswith("_scale"):
            assert all(torch.equal(s[name], shards[0][name]) for s in shards)
            out[name] = shards[0][name]
        else:
            out[name] = torch.cat([s[name] for s in shards], dim=3)
    return out


# ------------------------------------------------------------- programs

PS, P, B, WIDTH, K_SPEC = 8, 14, 4, 4, 4
LENGTHS = (13, 8, 20, 0)        # written positions per slot; slot 3 idle
TABLES = np.array([[3, 1, 6, 10], [7, 2, 11, 12], [4, 9, 5, 8],
                   [0, 0, 0, 0]], np.int32)


class _State:
    """One JAX pool prefilled with every slot's first LENGTHS tokens
    (the JAX tp=1 chunk program), and three copies of it: the JAX
    program's, the port's tp=1 pool and the port's shards."""

    def __init__(self, tp, kv_dtype="bf16", seed=5):
        self.tp = tp
        jp = jgpt.init_params(JCFG_U, jax.random.key(seed))
        if kv_dtype == "int8":
            jp = jgpt.quantize_params(jp)
        self.jp = jp
        self.tparams = tpk.serving_params(TCFG_U, _bridge(jp, TCFG_U),
                                          device="cpu")
        rng = np.random.default_rng(seed)
        toks = rng.integers(1, JCFG_U.vocab_size, (B, 20)).astype(np.int32)
        jpool = jpk.init_paged_kv(JCFG_U, P, PS, kv_dtype=kv_dtype)
        _, jpool = jpk.prefill_chunk_paged(
            JCFG_U, jp, jnp.asarray(toks), jpool, jnp.asarray(TABLES),
            jnp.zeros(B, jnp.int32), jnp.asarray(np.array(LENGTHS, np.int32)))
        self.jpool = jpool
        self.tpool = pool_from_jax({k: np.asarray(v) for k, v in
                                    jpool.items()}, TCFG_U, device="cpu")
        self.mesh = tpart.make_tp_mesh(tp, devices=[CPU] * tp)
        self.shards = tpart.shard_by_rules(
            self.mesh, tpk.KV_POOL_PARTITION_RULES, self.tpool)
        self.pshards = tpart.shard_by_rules(
            self.mesh, tgpt.partition_rules(), self.tparams)
        self.jmesh = jpart.make_tp_mesh(tp)

    def pools_close(self, jpool):
        """Port shards == port tp=1 pool (within 1e-5) == JAX pool, the
        null page aside (pad rows write it in an undefined order)."""
        full = _concat(self.shards)
        for name in full:
            got = full[name].float().numpy()[:, 1:]
            one = self.tpool[name].float().numpy()[:, 1:]
            ref = np.asarray(jpool[name].astype(jnp.float32))[:, 1:]
            np.testing.assert_allclose(got, one, atol=1e-5)
            np.testing.assert_allclose(got, ref, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("head", ["prefill", "verify"])
def test_chunk_twins_match_jax_and_tp1(tp, head):
    st = _State(tp)
    rng = np.random.default_rng(1)
    C = 8
    toks = rng.integers(1, JCFG_U.vocab_size, (B, C)).astype(np.int32)
    offsets = np.array(LENGTHS, np.int32)
    n_valid = np.array([8, 5, 3, 0], np.int32)
    args = (toks, TABLES, offsets, n_valid)
    if head == "prefill":
        jl, jpool = jpk.prefill_chunk_paged_tp(
            JCFG_U, st.jp, jnp.asarray(toks), st.jpool, jnp.asarray(TABLES),
            jnp.asarray(offsets), jnp.asarray(n_valid), mesh=st.jmesh)
        ol, pool = tpk.prefill_chunk_paged(
            TCFG_U, st.tparams, _t(toks), st.tpool, *map(_t, args[1:]))
        tl, out = tpk.prefill_chunk_paged_tp(
            TCFG_U, st.pshards, _t(toks), st.shards, *map(_t, args[1:]),
            mesh=st.mesh)
        none, _ = tpk.prefill_chunk_paged_tp(
            TCFG_U, st.pshards, _t(toks), st.shards, *map(_t, args[1:]),
            mesh=st.mesh, return_logits=False)
        assert none is None
    else:
        jl, jpool = jpk.verify_chunk_paged_tp(
            JCFG_U, st.jp, jnp.asarray(toks), st.jpool, jnp.asarray(TABLES),
            jnp.asarray(offsets), jnp.asarray(n_valid), mesh=st.jmesh)
        ol, pool = tpk.verify_chunk_paged(
            TCFG_U, st.tparams, _t(toks), st.tpool, *map(_t, args[1:]))
        tl, out = tpk.verify_chunk_paged_tp(
            TCFG_U, st.pshards, _t(toks), st.shards, *map(_t, args[1:]),
            mesh=st.mesh)
    assert out is st.shards and tl.dtype == torch.float32
    live = n_valid > 0
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               **FP32_TOL)
    np.testing.assert_allclose(tl.numpy()[live], ol.numpy()[live],
                               **FP32_TOL)
    st.pools_close(jpool)


@pytest.mark.parametrize("tp", [2, 4])
def test_decode_twins_match_jax_and_tp1(tp):
    """decode_step_paged_tp (logits) and decode_multi_paged_tp (greedy
    tokens of a 3-step window) from the same pool."""
    st = _State(tp)
    toks = np.array([11, 22, 33, 0], np.int32)
    pos = np.array(LENGTHS, np.int32)
    jl, jpool = jpk.decode_step_paged_tp(
        JCFG_U, st.jp, jnp.asarray(toks), st.jpool, jnp.asarray(pos),
        jnp.asarray(TABLES), mesh=st.jmesh)
    ol, _ = tpk.decode_step_paged(TCFG_U, st.tparams, _t(toks), st.tpool,
                                  _t(pos), _t(TABLES))
    tl, out = tpk.decode_step_paged_tp(TCFG_U, st.pshards, _t(toks),
                                       st.shards, _t(pos), _t(TABLES),
                                       mesh=st.mesh)
    assert out is st.shards
    np.testing.assert_allclose(tl.numpy()[:3], np.asarray(jl)[:3],
                               **FP32_TOL)
    np.testing.assert_allclose(tl.numpy()[:3], ol.numpy()[:3], **FP32_TOL)
    st.pools_close(jpool)
    # The fused window from the written step on: cursors one further.
    pos1 = pos + np.array([1, 1, 1, 0], np.int32)
    nxt = np.argmax(ol.numpy(), axis=-1).astype(np.int32)
    temps = np.zeros(B, np.float32)
    jt, jpool = jpk.decode_multi_paged_tp(
        JCFG_U, st.jp, jnp.asarray(nxt), jpool, jnp.asarray(pos1),
        jnp.asarray(TABLES), 3, jnp.asarray(temps), jax.random.key(0),
        mesh=st.jmesh)
    gen = torch.Generator().manual_seed(0)
    ot, _ = tpk.decode_multi_paged(TCFG_U, st.tparams, _t(nxt), st.tpool,
                                   _t(pos1), _t(TABLES), 3, _t(temps), gen)
    tt, _ = tpk.decode_multi_paged_tp(TCFG_U, st.pshards, _t(nxt),
                                      st.shards, _t(pos1), _t(TABLES), 3,
                                      _t(temps), gen, mesh=st.mesh)
    assert tt.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy()[:, :3], np.asarray(jt)[:, :3])
    np.testing.assert_array_equal(tt.numpy(), ot.numpy())
    st.pools_close(jpool)


@pytest.mark.parametrize("need_probs", [False, True])
def test_spec_draft_propose_twin_matches_jax_and_tp1(need_probs):
    """Greedy draft loop at budgets 4, 2, 0 and an inert row: proposals
    equal, the probability rows within 1e-5, the draft pools close."""
    st = _State(2)
    toks = np.array([11, 22, 33, 0], np.int32)
    pos = np.array(LENGTHS, np.int32)
    n_prop = np.array([4, 2, 0, -1], np.int32)
    temps = np.zeros(B, np.float32)
    jt, jq, jpool = jpk.spec_draft_propose_tp(
        JCFG_U, st.jp, jnp.asarray(toks), st.jpool, jnp.asarray(pos),
        jnp.asarray(TABLES), jnp.asarray(n_prop), jnp.asarray(temps),
        jax.random.key(0), k=K_SPEC, mesh=st.jmesh, need_probs=need_probs)
    gen = torch.Generator().manual_seed(0)
    ot, oq, _ = tpk.spec_draft_propose(
        TCFG_U, st.tparams, _t(toks), st.tpool, _t(pos), _t(TABLES),
        _t(n_prop), _t(temps), gen, k=K_SPEC, need_probs=need_probs)
    tt, tq, out = tpk.spec_draft_propose_tp(
        TCFG_U, st.pshards, _t(toks), st.shards, _t(pos), _t(TABLES),
        _t(n_prop), _t(temps), gen, k=K_SPEC, mesh=st.mesh,
        need_probs=need_probs)
    assert out is st.shards
    np.testing.assert_array_equal(tt.numpy()[:, :3], np.asarray(jt)[:, :3])
    np.testing.assert_array_equal(tt.numpy(), ot.numpy())
    if need_probs:
        np.testing.assert_allclose(tq.numpy()[:, :3], np.asarray(jq)[:, :3],
                                   atol=1e-5)
        np.testing.assert_allclose(tq.numpy(), oq.numpy(), atol=1e-5)
    else:
        assert tq is None and jq is None
    st.pools_close(jpool)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_page_op_twins_match_jax_and_tp1(kv_dtype):
    """copy_pages_tp, gather_pages_tp (full-head planes) and
    scatter_pages_tp (a full-head payload re-sliced per shard): exact
    against the JAX twins and the tp=1 ops."""
    st = _State(2, kv_dtype=kv_dtype)
    src, dst = np.array([3, 7, 0]), np.array([13, 14, 0])
    jpool = jpk.copy_pages_tp(st.jpool, jnp.asarray(src), jnp.asarray(dst),
                              mesh=st.jmesh)
    tpk.copy_pages(st.tpool, _t(src), _t(dst))
    assert tpk.copy_pages_tp(st.shards, _t(src), _t(dst),
                             mesh=st.mesh) is st.shards
    pages = np.array([13, 4, 9, 0])
    jgot = jpk.gather_pages_tp(jpool, jnp.asarray(pages), mesh=st.jmesh)
    got = tpk.gather_pages_tp(st.shards, _t(pages), mesh=st.mesh)
    one = tpk.gather_pages(st.tpool, _t(pages))
    assert set(got) == set(jgot) == set(one)
    for name in got:
        assert got[name].is_contiguous()
        assert torch.equal(got[name], one[name])
        np.testing.assert_array_equal(
            got[name].float().numpy(),
            np.asarray(jgot[name].astype(jnp.float32)))
    # Scatter pages 3 and 4's payload onto pages 14 and 13.
    payload = tpk.gather_pages(st.tpool, _t(np.array([3, 4])))
    targets = np.array([14, 13])
    jpool = jpk.scatter_pages_tp(
        jpool, jnp.asarray(targets),
        {k: jnp.asarray(v.float().numpy()).astype(jpool[k].dtype)
         for k, v in payload.items()}, mesh=st.jmesh)
    tpk.scatter_pages(st.tpool, _t(targets), payload)
    tpk.scatter_pages_tp(st.shards, _t(targets), payload, mesh=st.mesh)
    full = _concat(st.shards)
    for name in full:
        assert torch.equal(full[name], st.tpool[name]), name
        np.testing.assert_array_equal(
            full[name].float().numpy(),
            np.asarray(jpool[name].astype(jnp.float32)))


def test_int8_chunk_twin_scales_equal_across_shards():
    """An int8 pool at tp=2 through the chunk twin: every shard's scale
    plane bitwise equal (the cross-shard maximum), the logits within
    1e-5 of the tp=1 program's and the concatenated pool equal to the
    tp=1 pool's (codes within one of a rounding tie, scales within one
    bf16 step: the shards' K/V products may round differently)."""
    st = _State(2, kv_dtype="int8")
    rng = np.random.default_rng(4)
    toks = rng.integers(1, JCFG_U.vocab_size, (B, 8)).astype(np.int32)
    offsets = np.array(LENGTHS, np.int32)
    n_valid = np.array([8, 5, 3, 0], np.int32)
    ol, _ = tpk.prefill_chunk_paged(TCFG_U, st.tparams, _t(toks), st.tpool,
                                    _t(TABLES), _t(offsets), _t(n_valid))
    tl, _ = tpk.prefill_chunk_paged_tp(
        TCFG_U, st.pshards, _t(toks), st.shards, _t(TABLES), _t(offsets),
        _t(n_valid), mesh=st.mesh)
    for name in ("k_scale", "v_scale"):
        a, b = st.shards[0][name], st.shards[1][name]
        assert a.dtype == torch.bfloat16
        assert a.view(torch.int16).equal(b.view(torch.int16)), name
    np.testing.assert_allclose(tl.numpy()[:3], ol.numpy()[:3], **FP32_TOL)
    full = _concat(st.shards)
    for name in ("k", "v"):
        diff = (full[name][:, 1:].int() - st.tpool[name][:, 1:].int()).abs()
        assert int(diff.max()) <= 1, name
    for name in ("k_scale", "v_scale"):
        torch.testing.assert_close(full[name][:, 1:].float(),
                                   st.tpool[name][:, 1:].float(),
                                   rtol=8e-3, atol=0)


@pytest.mark.parametrize("tp", [2, 4])
def test_quant_write_shards_equal_the_full_write(tp):
    """The int8 writes of a tp body on every shard's heads equal the
    one-shard write of the full rows bit for bit: codes, and every
    shard's scale vector, over three dispatches (fresh pages, a
    continued page at 3x amplitude, a recycled page) and a whole-page
    write."""
    rng = np.random.default_rng(tp)
    n_pages, ps, H, K = 6, 8, 8, 4
    full = torch.zeros(n_pages + 1, ps, H, K, dtype=torch.int8)
    full_sc = torch.zeros(n_pages + 1, dtype=torch.bfloat16)
    parts = [torch.zeros(n_pages + 1, ps, H // tp, K, dtype=torch.int8)
             for _ in range(tp)]
    scales = [torch.zeros(n_pages + 1, dtype=torch.bfloat16)
              for _ in range(tp)]
    writes = [([1, 1, 2, 3, 0, 0], [0, 1, 0, 2, 5, 5], 1.0),
              ([1, 2, 4], [2, 1, 3], 3.0),
              ([1, 2], [0, 2], 0.5)]
    for pages, offs, amp in writes:
        pages, offs = torch.tensor(pages), torch.tensor(offs)
        # Amplitudes that differ by head, so the maximum crosses shards.
        rows = torch.from_numpy(rng.normal(size=(len(pages), H, K))
                                * amp * np.linspace(0.2, 2.0, H)[:, None]
                                ).float()
        tpk._quant_write(full, full_sc, pages, offs, rows)
        tpk._quant_write_shards([
            (parts[s], scales[s], pages, offs, piece)
            for s, piece in enumerate(torch.chunk(rows, tp, dim=1))])
        assert torch.equal(torch.cat(parts, dim=2), full)
        for sc in scales:
            assert sc.view(torch.int16).equal(full_sc.view(torch.int16))
    pages = torch.tensor([5, 6, 0])
    vals = torch.from_numpy(rng.normal(size=(3, ps, H, K))
                            * np.linspace(2.0, 0.1, H)[:, None]).float()
    vals[2] = 0.0
    tpk._quant_write_full_pages(full, full_sc, pages, vals)
    tpk._quant_write_full_pages_shards([
        (parts[s], scales[s], pages, piece)
        for s, piece in enumerate(torch.chunk(vals, tp, dim=2))])
    assert torch.equal(torch.cat(parts, dim=2), full)
    for sc in scales:
        assert sc.view(torch.int16).equal(full_sc.view(torch.int16))


def test_tp_bodies_sum_b_down_once():
    """The MLP's replicated b_down joins after the cross-shard sum: a
    nonzero bias moves the tp=2 block exactly as the tp=1 block."""
    from ray_tpu_torch.models import decode as tdec

    cfg = TCFG
    params = tgpt.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    params["b_down"] = torch.randn(params["b_down"].shape)
    params["b_up"] = torch.randn(params["b_up"].shape)
    shards = tpart.shard_by_rules([CPU, CPU], tgpt.partition_rules(), params)
    x = torch.randn(2, 3, cfg.d_model)
    layer = {k: v[0] for k, v in tgpt.stack_block_params(params).items()}
    layers = [{k: v[0] for k, v in tgpt.stack_block_params(s).items()}
              for s in shards]
    torch.testing.assert_close(tdec._mlp(x, layers, cfg),
                               tdec._mlp(x, layer, cfg), atol=1e-6,
                               rtol=1e-6)
    parts = [torch.randn(2, 3, cfg.d_model) for _ in range(3)]
    assert torch.equal(tdec._reduce(parts, CPU),
                       (parts[0] + parts[1]) + parts[2])


# --------------------------------------------------------------- engines

@pytest.fixture(scope="module")
def weights():
    jp = jgpt.init_params(JCFG, jax.random.key(42))
    return jp, _bridge(jp, TCFG)


@pytest.fixture(scope="module")
def draft():
    jp = jgpt.init_params(JDRAFT, jax.random.key(7))
    return jp, _bridge(jp, TDRAFT)


BASE = dict(n_slots=4, max_len=128, kv_mode="paged", page_size=16,
            prefill_chunk=16, prefill_token_budget=32)


def _drive(eng, reqs, max_steps=2000):
    for _ in range(max_steps):
        if all(r.done.is_set() for r in reqs):
            break
        eng.step()
    assert all(r.done.is_set() for r in reqs)
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    return [r.out_ids for r in reqs]


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, TCFG.vocab_size, n)))
            for n in lengths]


def _port(tparams, tp=1, **kw):
    args = dict(BASE, device="cpu", attn_impl="gather")
    args.update(kw)
    return LLMEngine(TCFG, tparams, tp=tp, **args)


def _jax(jparams, tp=2, **kw):
    args = dict(BASE, attn_impl="gather")
    args.update(kw)
    return JaxEngine(JCFG, jparams, tp=tp, **args)


def _run(eng, prompts, n, **kw):
    return _drive(eng, [eng.submit(p, max_tokens=n, **kw) for p in prompts])


def _closed(eng):
    acct = eng.page_accounting()
    assert acct["closure"] and acct["refs_consistent"], acct


@pytest.mark.parametrize("tp", [2, 4])
def test_streams_equal_jax_tp2_and_port_tp1(weights, tp):
    """Ragged prompts through chunked prefill (several chunks and widths)
    and fused decode windows."""
    jp, tparams = weights
    prompts = _prompts(1, (5, 23, 41, 11))
    ref = _run(_jax(jp), prompts, 24)
    assert _run(_port(tparams), prompts, 24) == ref
    eng = _port(tparams, tp=tp)
    assert eng.mesh == [CPU] * tp and len(eng.params) == tp
    assert _run(eng, prompts, 24) == ref
    m = eng.metrics()
    assert m["llm_tp"] == tp and m["prefill_dispatches"] > 1
    assert m["kv_pages_free"] == m["kv_pages_total"]
    _closed(eng)


def test_warm_prefix_cow_at_tp2(weights):
    """Two waves of prompts sharing a 44-token prefix: the second binds
    cached pages and copies the divergent tail page on every shard
    (copy_pages_tp); both waves equal the JAX tp=2 and port tp=1 runs."""
    jp, tparams = weights
    rng = np.random.default_rng(6)
    shared = list(map(int, rng.integers(1, TCFG.vocab_size, 44)))
    prompts = [shared + list(map(int, rng.integers(1, TCFG.vocab_size, 6)))
               for _ in range(3)]
    kw = dict(prefill_chunk=12, page_size=8)
    jeng = _jax(jp, prefix_cache=True, **kw)
    ref = _run(jeng, prompts, 8)
    assert _run(jeng, prompts, 8) == ref
    assert _run(_port(tparams, **kw), prompts, 8) == ref
    eng = _port(tparams, tp=2, prefix_cache=True, **kw)
    assert _run(eng, prompts, 8) == ref
    assert _run(eng, prompts, 8) == ref
    m = eng.metrics()
    assert m["prefix_hits"] > 0 and m["cow_copies"] > 0
    _closed(eng)


@pytest.mark.parametrize("k", [1, 4])
def test_spec_decode_at_tp2(weights, draft, k):
    """Speculative decoding at tp=2 (the draft sharded on the target's
    mesh, 2 of its 4 heads per shard): greedy streams equal the JAX tp=2
    speculative engine's and the port's tp=1 plain engine's."""
    jp, tparams = weights
    jd, td = draft
    prompts = _prompts(2, (9, 30, 17))
    ref = _run(_jax(jp, spec_draft=JDRAFT, spec_draft_params=jd, spec_k=k),
               prompts, 16)
    assert _run(_port(tparams), prompts, 16) == ref
    eng = _port(tparams, tp=2, spec_draft=TDRAFT, spec_draft_params=td,
                spec_k=k)
    assert len(eng.draft_params) == 2 and len(eng.draft_cache) == 2
    assert eng.draft_cache[0]["k"].shape[3] == TDRAFT.n_heads // 2
    assert _run(eng, prompts, 16) == ref
    m = eng.metrics()
    assert m["spec_ticks"] > 0 and m["spec_proposed"] > 0
    assert m["kv_pages_free"] == m["kv_pages_total"]
    _closed(eng)


def test_preemption_at_tp2(weights):
    """Seven pages of four for four requests: preempt-by-recompute on the
    sharded engine reproduces the JAX tp=2 and port tp=1 streams."""
    jp, tparams = weights
    prompts = [[5, 9, 2], [17, 3], [2, 4, 6], [8, 1, 0]]
    kw = dict(max_len=64, page_size=4, n_pages=7, prefill_chunk=4,
              prefill_token_budget=8)
    ref = _run(_jax(jp, **kw), prompts, 10)
    assert _run(_port(tparams, **kw), prompts, 10) == ref
    eng = _port(tparams, tp=2, **kw)
    assert _run(eng, prompts, 10) == ref
    m = eng.metrics()
    assert m["preemptions"] > 0
    assert m["kv_pages_free"] == m["kv_pages_total"]


def test_int8_kv_at_tp2(weights):
    """int8 weights and KV: streams equal the JAX tp=2 int8 engine's and
    the port's tp=1 int8 engine's; every shard's scale planes are
    bitwise equal at the end."""
    jp, tparams = weights
    prompts = _prompts(3, (7, 30, 19))
    q = dict(weight_dtype="int8", kv_dtype="int8")
    ref = _run(_jax(jp, **q), prompts, 16)
    assert _run(_port(tparams, **q), prompts, 16) == ref
    eng = _port(tparams, tp=2, **q)
    assert _run(eng, prompts, 16) == ref
    assert eng.params[0]["wq"].dtype == torch.int8
    for name in ("k_scale", "v_scale"):
        a, b = (s[name] for s in eng.cache)
        assert a.view(torch.int16).equal(b.view(torch.int16)), name
        assert float(a[:, 1:].float().abs().max()) > 0, name


def test_drain_at_tp2_resumes_on_tp1(weights):
    """Drain a tp=2 engine mid-flight: the continuations resume on a
    tp=1 engine and every stream equals the uninterrupted run, each
    carrying exactly its missing tokens."""
    jp, tparams = weights
    prompts = _prompts(5, (13, 26, 8))
    full = _run(_jax(jp), prompts, 20)
    eng = _port(tparams, tp=2)
    reqs = [eng.submit(p, max_tokens=20) for p in prompts]
    for _ in range(4):
        eng.step()
    out = eng.drain(timeout_s=0.0)
    assert out["exported"] == len([r for r in reqs if not r.finished_at])
    conts = {tuple(c["prompt_ids"]): c for c in out["continuations"]}
    resume = _port(tparams)
    resumed = []
    for i, p in enumerate(prompts):
        c = conts.get(tuple(p))
        if c is None:
            continue
        gen = c["generated_ids"]
        assert gen == full[i][:len(gen)]
        resumed.append((i, len(gen), resume.submit(
            c["prompt_ids"], max_tokens=c["max_tokens"],
            temperature=c["temperature"], eos_id=c["eos_id"],
            generated_ids=gen)))
    assert resumed
    _drive(resume, [r for *_x, r in resumed])
    for i, n_had, r in resumed:
        assert r.out_ids == full[i]
        assert len(r.out_ids) - n_had == 20 - n_had
    _closed(eng)


# ------------------------------------------------- validation, topology

class TestKnobValidation:
    """The JAX engine's explicit-argument tp errors, and the port's
    device rules."""

    def test_non_divisor_tp_rejected(self, weights):
        with pytest.raises(ValueError, match="divide"):
            _port(weights[1], tp=3)          # 8 heads % 3 != 0

    def test_tp_beyond_devices_rejected(self, weights):
        """Without a device list the mesh is the visible CUDA devices:
        none on a CPU-only host, so any tp > 1 is too many (never a
        silent CPU run)."""
        n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
        for device in (None, "cuda"):
            with pytest.raises(ValueError, match="device"):
                _port(weights[1], tp=max(2, n_cuda + 1), device=device)

    def test_tp_floor(self, weights):
        with pytest.raises(ValueError, match="llm_tp"):
            _port(weights[1], tp=0)

    def test_tp_on_dense_engine_rejected(self, weights):
        with pytest.raises(ValueError, match="kv_mode='paged'"):
            LLMEngine(TCFG, weights[1], kv_mode="dense", tp=2, device="cpu")

    def test_tp_on_oneshot_paged_rejected(self, weights):
        with pytest.raises(ValueError, match="prefill_chunk > 0"):
            _port(weights[1], prefill_chunk=0, tp=2)

    def test_draft_non_divisor_rejected(self, weights):
        bad = tgpt.GPTConfig.tiny(dtype=torch.float32, n_layers=1,
                                  d_model=32, n_heads=1, d_ff=64)
        with pytest.raises(ValueError, match="DRAFT"):
            _port(weights[1], tp=2, spec_draft=bad)

    def test_device_list_must_match_tp(self, weights):
        with pytest.raises(ValueError, match="one per shard"):
            _port(weights[1], tp=2, device=["cpu"] * 3)
        eng = _port(weights[1], tp=2, device=["cpu", "cpu"])
        assert eng.mesh == [CPU, CPU] and eng.device == CPU
        one = _port(weights[1], device=["cpu"])
        assert one.mesh is None and one.device == CPU


def test_topology_fields_equal_jax(weights):
    """llm_tp, mesh_shape, kv_heads_per_shard, pool_shard_bytes and
    pool_shard_bytes_used equal the JAX tp=2 engine's mid-flight (same
    steps, same pages held), float and int8; kv_pool_bytes counts every
    shard's bytes."""
    jp, tparams = weights
    prompts = _prompts(7, (21, 9))
    keys = ("llm_tp", "mesh_shape", "kv_heads_per_shard",
            "pool_shard_bytes", "pool_shard_bytes_used")
    for q in ({}, dict(kv_dtype="int8")):
        jeng, eng = _jax(jp, **q), _port(tparams, tp=2, **q)
        jr = [jeng.submit(p, max_tokens=40) for p in prompts]
        tr = [eng.submit(p, max_tokens=40) for p in prompts]
        for _ in range(2):
            jeng.step()
            eng.step()
        jm, m = jeng.metrics(), eng.metrics()
        js, snap = jeng.load_snapshot(), eng.load_snapshot()
        assert 0 < m["pool_shard_bytes_used"] < m["pool_shard_bytes"]
        for key in keys:
            assert m[key] == jm[key], (q, key)
            assert snap[key] == js[key], (q, key)
        assert m["kv_heads_per_shard"] == TCFG.n_heads // 2
        shard_bytes = sum(t.numel() * t.element_size()
                          for t in eng.cache[0].values())
        assert m["pool_shard_bytes"] == shard_bytes
        assert m["kv_pool_bytes"] == snap["kv_pool_bytes"] == 2 * shard_bytes
        _drive(jeng, jr)
        _drive(eng, tr)


def test_tp1_engine_unchanged_surface(weights):
    """tp=1 exports llm_tp=1 in metrics and no mesh fields; the snapshot
    carries no topology; the engine dispatches through the paged_kv
    module itself (a wrapper set on a program there still reaches it)."""
    eng = _port(weights[1])
    assert eng.tp == 1 and eng.mesh is None and eng._rt is tpk
    assert isinstance(eng.cache, dict) and isinstance(eng.params, dict)
    m = eng.metrics()
    assert m["llm_tp"] == 1 and "mesh_shape" not in m
    snap = eng.load_snapshot()
    assert "llm_tp" not in snap and "mesh_shape" not in snap
