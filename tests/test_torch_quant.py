"""PyTorch port vs the JAX package: quantized serving.

int8 weights (``models/gpt.py``: QUANT_RULES, quantize_params, dequant,
weight_view), the int8 page pool with per-page scale planes
(``models/paged_kv.py``: init_paged_kv, _quant_write and the quantized
branches of the paged programs), the quantized plain versions of both
paged-attention functions, and the engine's ``weight_dtype`` /
``kv_dtype`` knobs. The port and the JAX package run on the same numpy
weights at tests/test_quant.py's tiny fp32 config; each test states its
tolerance. On the CPU the wrappers take the plain versions, and every
launch counter, the int8 ones included, stays 0 (asserted). The int8
CUDA programs are held to these plain versions on the card by
chip_smoke.py and tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import gpt as jgpt
from ray_tpu.models import paged_kv as jpk
from ray_tpu.ops.paged_attention import (
    paged_attention as jax_paged_attention,
    paged_prefill_attention as jax_paged_prefill_attention,
    reference_paged_attention as jax_reference_paged_attention,
    reference_paged_prefill_attention as jax_reference_paged_prefill_attention,
)
from ray_tpu.serve.llm import LLMEngine as JaxEngine
from ray_tpu_torch._bridge import params_from_jax, pool_from_jax
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import paged_kv as tpk
from ray_tpu_torch.ops import paged_attention as tpa
from ray_tpu_torch.serve.llm import LLMEngine

JCFG = jgpt.GPTConfig.tiny(attn_impl="xla", dtype=jnp.float32)
TCFG = tgpt.GPTConfig.tiny(dtype=torch.float32)
QUANT_LEAVES = ("wq", "wk", "wv", "wo", "w_up", "w_down")
# tests/test_quant.py's pins, held by the port's own forward / loss_fn.
LOGIT_MAE_BOUND = 5e-3
EVAL_LOSS_DELTA_BOUND = 1e-3


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


def _np(x):
    """A torch tensor or a JAX array as fp32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------------- quantizer

def test_quantizer_matches_jax_byte_for_byte(weights):
    """int8 planes identical to JAX's, fp32 scales equal, float leaves
    untouched; the bridge carries JAX's quantized tree over as int8 +
    fp32; idempotent."""
    jp, tp = weights
    jq, tq = jgpt.quantize_params(jp), tgpt.quantize_params(tp)
    assert set(jq) == set(tq)
    for name in QUANT_LEAVES:
        assert tq[name].dtype == torch.int8
        assert tq[name + "_scale"].dtype == torch.float32
        np.testing.assert_array_equal(tq[name].numpy(), np.asarray(jq[name]))
        np.testing.assert_array_equal(tq[name + "_scale"].numpy(),
                                      np.asarray(jq[name + "_scale"]))
    for name in ("wte", "ln1_scale", "ln_f_scale", "b_up"):
        assert torch.equal(tq[name], tp[name])
    bridged = params_from_jax({k: np.asarray(v) for k, v in jq.items()},
                              TCFG, device="cpu")
    for name, t in tq.items():
        assert bridged[name].dtype == t.dtype and torch.equal(bridged[name], t)
    again = tgpt.quantize_params(tq)
    assert all(again[k] is tq[k] for k in tq)
    assert tgpt.quant_axes("wo") == (1, 2) and tgpt.quant_axes("wte") is None


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_dequant_and_weight_view_match_jax(weights, dtype):
    """The product taken in the compute dtype, as JAX takes it: equal to
    the last bit in fp32 and in bf16."""
    jd, td = {"fp32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jp, tp = weights
    jq, tq = jgpt.quantize_params(jp), tgpt.quantize_params(tp)
    for name in QUANT_LEAVES:
        j = np.asarray(jgpt.weight_view(jq, name, jd).astype(jnp.float32))
        t = tgpt.weight_view(tq, name, td)
        assert t.dtype == td
        np.testing.assert_array_equal(t.float().numpy(), j)
        np.testing.assert_array_equal(
            tgpt.dequant(tq[name], tq[name + "_scale"], td).float().numpy(), j)
    stacked = tgpt.stack_block_params(tq, td)
    assert stacked["wq"].dtype == torch.int8 and "wq_scale" in stacked
    assert stacked["ln1_scale"].dtype == td and "ln1_scale_scale" not in stacked


def _eval_tokens(n):
    rng = np.random.default_rng(123)
    return torch.from_numpy(rng.integers(1, TCFG.vocab_size, (4, n)))


def test_logit_mae_pin(weights):
    """tests/test_quant.py:40's pin on the port's forward (MAE < 5e-3
    against the float masters); the quantized forward also equals JAX's
    within 1e-5 (fp32 sums in another order)."""
    jp, tp = weights
    toks = _eval_tokens(64)
    lq = tgpt.forward(tgpt.quantize_params(tp), toks, TCFG)
    mae = float((tgpt.forward(tp, toks, TCFG) - lq).abs().mean())
    assert mae < LOGIT_MAE_BOUND, mae
    jl = jgpt.forward(jgpt.quantize_params(jp), jnp.asarray(toks.numpy()),
                      JCFG)
    np.testing.assert_allclose(lq.numpy(), np.asarray(jl), atol=1e-5)


def test_eval_loss_delta_pin(weights):
    """tests/test_quant.py:41's pin on the port's loss_fn: |Δ| < 1e-3."""
    _, tp = weights
    toks = _eval_tokens(65)
    l0 = float(tgpt.loss_fn(tp, toks[:, :-1], toks[:, 1:], TCFG))
    l1 = float(tgpt.loss_fn(tgpt.quantize_params(tp), toks[:, :-1],
                            toks[:, 1:], TCFG))
    assert abs(l1 - l0) < EVAL_LOSS_DELTA_BOUND, (l0, l1)


# ------------------------------------------------------------ _quant_write

def _jax_ratio(vals, pages, offs, old_scale):
    """v / s as the JAX _quant_write computes it (fp32), for the rows of
    one write: s is the page's fresh fp32 scale where it resets, else the
    stored bf16 one."""
    n = old_scale.shape[0]
    v = vals.astype(np.float32)
    vmax = np.abs(v).reshape(len(v), -1).max(axis=1)
    starts = np.zeros(n, bool)
    np.logical_or.at(starts, pages, offs == 0)
    contrib = np.zeros(n, np.float32)
    np.maximum.at(contrib, pages, vmax)
    fresh = np.maximum(contrib, np.float32(1e-8)) / np.float32(127.0)
    s = np.where(starts | (old_scale <= 0), fresh, old_scale)
    return v / s[pages].reshape(-1, 1, 1)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_quant_write_matches_jax(dtype):
    """A sequence of writes into one layer's int8 plane: fresh pages
    (offset 0), a never-scaled page written mid-page, pad rows on the
    null page, then a continued page (frozen scale, rows clipped at
    ±127) and a page whose only scale is the 1e-8/127 floor. Planes and
    scale vectors equal JAX's except page 0; one int8 code of difference
    is allowed only where JAX's v/s lies within 1e-5 of a rounding tie
    (counted, and expected to be rare)."""
    jd, td = {"fp32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(11)
    P, ps, H, K = 6, 8, 2, 4
    jpool = jnp.zeros((P + 1, ps, H, K), jnp.int8)
    jsc = jnp.zeros((P + 1,), jnp.bfloat16)
    tpool = torch.zeros(P + 1, ps, H, K, dtype=torch.int8)
    tsc = torch.zeros(P + 1, dtype=torch.bfloat16)
    writes = [
        # pages 1 and 2 fresh, page 3 never scaled and written mid-page,
        # three pad rows on the null page at clashing offsets
        ([1, 1, 1, 2, 2, 3, 3, 0, 0, 0], [0, 1, 2, 0, 1, 2, 3, 5, 5, 6], 1.0),
        # page 1 continued at 3x the amplitude: frozen scale, clipping;
        # page 4 has only the floor scale and is written mid-page
        ([1, 1, 4, 0], [3, 4, 1, 2], 3.0),
        # page 1 recycled (offset 0 resets), page 2 continued
        ([1, 2, 2], [0, 2, 3], 0.5),
    ]
    near_tie = 0
    for pages, offs, amp in writes:
        pages, offs = np.array(pages), np.array(offs)
        vals = np.array(jnp.asarray(
            rng.normal(size=(len(pages), H, K)) * amp, jd).astype(jnp.float32))
        ratio = _jax_ratio(vals, pages, offs,
                           np.asarray(jsc.astype(jnp.float32)))
        jpool, jsc = jpk._quant_write(jpool, jsc, jnp.asarray(pages),
                                      jnp.asarray(offs),
                                      jnp.asarray(vals, jd))
        tpk._quant_write(tpool, tsc, torch.from_numpy(pages),
                         torch.from_numpy(offs),
                         torch.from_numpy(vals).to(td))
        np.testing.assert_array_equal(
            tsc.float().numpy()[1:], np.asarray(jsc.astype(jnp.float32))[1:])
        diff = (tpool.numpy()[1:].astype(int)
                - np.asarray(jpool)[1:].astype(int))
        assert np.abs(diff).max() <= 1
        for p_, o_ in zip(*np.nonzero(np.abs(diff).max(axis=(2, 3)))):
            rows = np.nonzero((pages == p_ + 1) & (offs == o_))[0]
            frac = np.abs(ratio[rows[-1]] - np.round(ratio[rows[-1]]))
            bad = diff[p_, o_] != 0
            assert np.all(np.abs(frac[bad] - 0.5) < 1e-5)
            near_tie += int(bad.sum())
    assert near_tie <= 2, near_tie
    assert tpool[1, 3:5].abs().max() == 127      # the clipped continuation
    assert float(tsc[4]) == pytest.approx(1e-8 / 127, rel=1e-2)


def test_init_paged_kv_int8_matches_jax():
    jpool = jpk.init_paged_kv(JCFG, 5, 8, kv_dtype="int8")
    tpool = tpk.init_paged_kv(TCFG, 5, 8, kv_dtype="int8", device="cpu")
    assert set(tpool) == set(jpool)
    for name, j in jpool.items():
        assert tpool[name].shape == j.shape
    assert tpool["k"].dtype == torch.int8
    assert tpool["k_scale"].dtype == torch.bfloat16
    bridged = pool_from_jax({k: np.asarray(v) for k, v in jpool.items()},
                            TCFG, device="cpu")
    assert {k: v.dtype for k, v in bridged.items()} == {
        k: v.dtype for k, v in tpool.items()}
    with pytest.raises(ValueError, match="kv_dtype"):
        tpk.init_paged_kv(TCFG, 5, 8, kv_dtype="fp8", device="cpu")


# ---------------------------------------------------------------- attention

DT = {"fp32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
BF16_ATOL = 3e-2     # tests/test_torch_paged_attention.py's bf16 tolerance


def _int8_pools(rng, n_pages, ps, H, K):
    """int8 K/V planes (numpy) and their bf16 scale vectors (JAX and
    torch), the pages at log-uniform amplitudes in [0.25, 1] so that a
    wrong scale shows."""
    planes = [rng.integers(-127, 128, size=(n_pages, ps, H, K)).astype(np.int8)
              for _ in range(2)]
    scales = [_both(np.exp(rng.uniform(np.log(0.25), 0.0, n_pages)) / 127,
                    "bf16") for _ in range(2)]
    return planes, scales


def _both(a, dt=None):
    """(jax array, torch tensor) of a numpy array, in dt when given."""
    if dt is None:
        return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))
    jd, td = DT[dt]
    j = jnp.asarray(a, jd)
    return j, torch.from_numpy(np.array(j, np.float32)).to(td)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("ps", [8, 16])
def test_decode_int8_matches_jax(dt, ps):
    """The quantized plain version against JAX's gather reference (fp32
    1e-5; bf16 equal within the output's rounding) and the Pallas int8
    program in interpret mode (fp32 1e-5; bf16 q at the file's bf16
    tolerance: the program does not round p, the plain version does).
    The wrapper takes the plain version on the CPU; the scales are used
    (ones in their place move the output)."""
    rng = np.random.default_rng(20)
    B, H, K, n_pg = 5, 4, 16, 3
    (kp, vp), ((jks, tks), (jvs, tvs)) = _int8_pools(rng, B * n_pg + 1, ps,
                                                     H, K)
    # Ragged lengths (1, mid-page, page boundary, full table) on
    # scattered pages, and an idle all-null slot.
    perm = rng.permutation(np.arange(1, B * n_pg + 1)).astype(np.int32)
    tables = np.zeros((B, n_pg), np.int32)
    lengths = np.array([1, ps // 2 + 1, ps, n_pg * ps, 1], np.int32)
    for b in range(B - 1):
        n = -(-int(lengths[b]) // ps)
        tables[b, :n] = perm[b * n_pg:b * n_pg + n]
    jq, tq = _both(rng.normal(size=(B, H, K)).astype(np.float32), dt)
    (jk, tk), (jv, tv) = _both(kp), _both(vp)
    (jt, tt), (jl, tl) = _both(tables), _both(lengths)
    out = tpa.paged_attention(tq, tk, tv, tt, tl, k_scale=tks, v_scale=tvs)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    torch.testing.assert_close(out, tpa.reference_paged_attention(
        tq, tk, tv, tt, tl, k_scale=tks, v_scale=tvs), rtol=0, atol=0)
    ref = jax_reference_paged_attention(jq, jk, jv, jt, jl, k_scale=jks,
                                        v_scale=jvs)
    np.testing.assert_allclose(_np(out), _np(ref),
                               atol=1e-5 if dt == "fp32" else 8e-3)
    pallas = jax_paged_attention(jq, jk, jv, jt, jl, k_scale=jks, v_scale=jvs,
                                 interpret=True)
    np.testing.assert_allclose(_np(out), _np(pallas),
                               atol=1e-5 if dt == "fp32" else BF16_ATOL)
    ones = torch.full_like(tks, 1 / 127)
    moved = tpa.paged_attention(tq, tk, tv, tt, tl, k_scale=ones,
                                v_scale=ones)
    assert float((moved.float() - out.float()).abs().max()) > 0.1


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("width", [2, 4])
def test_prefill_int8_matches_jax(dt, width):
    """Chunk rows at ragged offsets (an interior chunk at a page
    boundary, one ending mid-page, a one-token chunk, an inert row)
    against width-sliced and full tables, int8 pools at ps 8; tolerances
    as in test_decode_int8_matches_jax. The inert row (lengths 0) is left
    out of the Pallas comparison: the program writes zeros there, the
    gather versions the mean of V."""
    rng = np.random.default_rng(21)
    B, C, H, K, ps, n_pg = 5, 8, 2, 16, 8, 4
    (kp, vp), ((jks, tks), (jvs, tvs)) = _int8_pools(rng, B * n_pg + 1, ps,
                                                     H, K)
    tables = (rng.permutation(B * n_pg).astype(np.int32) + 1).reshape(B, n_pg)
    cap = width * ps
    rows = [(ps, C), (ps + 3, C - 2), (2, 1), (0, 0), (0, C)]
    offsets = np.array([o for o, _ in rows], np.int32)
    lengths = np.array([o + min(n, cap - o) for o, n in rows], np.int32)
    jq, tq = _both(rng.normal(size=(B, C, H, K)).astype(np.float32), dt)
    (jk, tk), (jv, tv) = _both(kp), _both(vp)
    args = [_both(a) for a in (tables[:, :width].copy(), offsets, lengths)]
    aj, at = [a[0] for a in args], [a[1] for a in args]
    out = tpa.paged_prefill_attention(tq, tk, tv, *at, k_scale=tks,
                                      v_scale=tvs)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out, tpa.reference_paged_prefill_attention(
        tq, tk, tv, *at, k_scale=tks, v_scale=tvs), rtol=0, atol=0)
    ref = jax_reference_paged_prefill_attention(jq, jk, jv, *aj, k_scale=jks,
                                                v_scale=jvs)
    np.testing.assert_allclose(_np(out), _np(ref),
                               atol=1e-5 if dt == "fp32" else 8e-3)
    live = lengths > 0
    pallas = jax_paged_prefill_attention(jq, jk, jv, *aj, k_scale=jks,
                                         v_scale=jvs, interpret=True)
    np.testing.assert_allclose(_np(out)[live], _np(pallas)[live],
                               atol=1e-5 if dt == "fp32" else BF16_ATOL)


def test_quantized_arguments_are_validated():
    q = torch.zeros(1, 2, 8)
    i8 = torch.zeros(3, 4, 2, 8, dtype=torch.int8)
    t = torch.ones(1, 1, dtype=torch.int32)
    n = torch.ones(1, dtype=torch.int32)
    s = torch.ones(3)
    with pytest.raises(ValueError, match="needs k_scale"):
        tpa.paged_attention(q, i8, i8, t, n)
    with pytest.raises(ValueError, match="together"):
        tpa.paged_attention(q, i8, i8, t, n, k_scale=s)
    with pytest.raises(ValueError, match="int8 pools only"):
        tpa.paged_attention(q, i8.float(), i8.float(), t, n, k_scale=s,
                            v_scale=s)
    with pytest.raises(ValueError, match="one scale per page"):
        tpa.paged_prefill_attention(q[:, None], i8, i8, t, n - 1, n,
                                    k_scale=s[:2], v_scale=s[:2])


# ----------------------------------------------------------------- programs

def _prog_weights():
    """tiny_untied weights from seed 5 (the float program test's), int8
    on both sides, the port's in its serving layout."""
    cfg_j = jgpt.GPTConfig.tiny_untied(dtype=jnp.float32)
    cfg_t = tgpt.GPTConfig.tiny_untied(dtype=torch.float32)
    jp = jgpt.quantize_params(jgpt.init_params(cfg_j, jax.random.key(5)))
    tp = tpk.serving_params(cfg_t, params_from_jax(
        {k: np.asarray(v) for k, v in jp.items()}, cfg_t, device="cpu"),
        device="cpu")
    return cfg_j, cfg_t, jp, tp


def _pools_close(tpool, jpool):
    """Scale planes equal (page 0 aside: pad rows write it in an order
    neither side defines); codes within one of JAX's on at most 0.1% of
    the elements (K/V come from fp32 sums in another order, which can
    move a value across a rounding tie)."""
    for name in ("k_scale", "v_scale"):
        np.testing.assert_array_equal(
            tpool[name].float().numpy()[:, 1:],
            np.asarray(jpool[name].astype(jnp.float32))[:, 1:])
    for name in ("k", "v"):
        d = np.abs(tpool[name].numpy()[:, 1:].astype(int)
                   - np.asarray(jpool[name])[:, 1:].astype(int))
        assert d.max() <= 1 and d.mean() < 1e-3, (name, d.max(), d.mean())


@pytest.mark.parametrize("jax_impl", ["gather", "kernel"])
def test_programs_int8_match_jax(jax_impl):
    """prefill_chunk_paged (two chunk dispatches of a 13-token prompt, an
    8-token one and an inert row; width-sliced tables) then
    decode_step_paged, int8 weights and an int8 pool, against JAX's
    programs (its gather or its Pallas int8 programs in interpret mode):
    logits within 1e-4 (fp32 sums in another order, plus what a code
    flipped at a tie moves), scale planes equal, codes as `_pools_close`
    says."""
    cfg_j, cfg_t, jp, tp = _prog_weights()
    rng = np.random.default_rng(9)
    p0 = rng.integers(1, cfg_j.vocab_size, 13).astype(np.int32)
    p1 = rng.integers(1, cfg_j.vocab_size, 8).astype(np.int32)
    tables = np.zeros((3, 4), np.int32)
    tables[0, :3] = [1, 2, 3]
    tables[1, :2] = [4, 5]
    d1, d2 = np.zeros((3, 8), np.int32), np.zeros((3, 8), np.int32)
    d1[0], d1[1], d2[0, :5] = p0[:8], p1, p0[8:]
    script = [(d1, [0, 0, 0], [8, 8, 0], 1), (d2, [8, 8, 0], [5, 0, 0], 2)]
    jpool = jpk.init_paged_kv(cfg_j, 8, 8, kv_dtype="int8")
    tpool = tpk.init_paged_kv(cfg_t, 8, 8, kv_dtype="int8", device="cpu")
    for toks, offs, nv, width in script:
        offs, nv = np.array(offs, np.int32), np.array(nv, np.int32)
        tbl = np.ascontiguousarray(tables[:, :width])
        jl, jpool = jpk.prefill_chunk_paged(
            cfg_j, jp, jnp.asarray(toks), jpool, jnp.asarray(tbl),
            jnp.asarray(offs), jnp.asarray(nv), attn_impl=jax_impl)
        tl, tpool = tpk.prefill_chunk_paged(
            cfg_t, tp, torch.from_numpy(toks), tpool, torch.from_numpy(tbl),
            torch.from_numpy(offs), torch.from_numpy(nv), attn_impl="kernel")
        rows = nv > 0
        np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows],
                                   atol=1e-4)
        _pools_close(tpool, jpool)
    tok, pos = np.array([3, 7, 0], np.int32), np.array([13, 8, 0], np.int32)
    jl, jpool = jpk.decode_step_paged(cfg_j, jp, jnp.asarray(tok), jpool,
                                      jnp.asarray(pos), jnp.asarray(tables),
                                      attn_impl=jax_impl)
    tl, tpool = tpk.decode_step_paged(cfg_t, tp, torch.from_numpy(tok), tpool,
                                      torch.from_numpy(pos),
                                      torch.from_numpy(tables))
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], atol=1e-4)
    _pools_close(tpool, jpool)
    assert tp["wq"].dtype == torch.int8 and tp["wq_scale"].dtype == (
        torch.float32)


# ------------------------------------------------------------------- engine

def _drive(eng, reqs, max_steps=800):
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


def _both_engines(weights, prompts, *, max_tokens=8, **kw):
    jp, tp = weights
    kw.setdefault("n_slots", 4)
    kw.setdefault("max_len", 128)
    jeng = JaxEngine(JCFG, jp, kv_mode="paged", attn_impl="gather", **kw)
    teng = LLMEngine(TCFG, tp, attn_impl="kernel", device="cpu", **kw)
    jout = _drive(jeng, [jeng.submit(p, max_tokens=max_tokens)
                         for p in prompts])
    tout = _drive(teng, [teng.submit(p, max_tokens=max_tokens)
                         for p in prompts])
    acc = teng.page_accounting()
    assert acc["closure"] and acc["refs_consistent"]
    assert acc["free"] == acc["total"]
    return jout, tout, jeng, teng


QUANT_ARMS = [{"weight_dtype": "int8"}, {"kv_dtype": "int8"},
              {"weight_dtype": "int8", "kv_dtype": "int8"}]


@pytest.mark.parametrize("arm", QUANT_ARMS, ids=["w8", "kv8", "w8kv8"])
def test_engine_streams_match_jax_ragged_bucketed(weights, arm):
    """Ragged prompts across the whole width ladder (page 16, max_len
    128: widths 1-8), width-bucketed chunk dispatch: greedy streams equal
    the JAX engine's, and so do the dispatch widths."""
    prompts = _prompts(30, (3, 17, 33, 50, 70, 100))
    jout, tout, jeng, teng = _both_engines(
        weights, prompts, page_size=16, prefill_chunk=16,
        prefill_token_budget=32, prefill_width_bucketing=True, **arm)
    assert tout == jout
    tm, jm = teng.metrics(), jeng.metrics()
    assert tm["prefill_dispatch_widths"] == jm["prefill_dispatch_widths"]
    assert len(tm["prefill_dispatch_widths"]) > 1
    for key in ("llm_weight_dtype", "llm_kv_dtype"):
        assert tm[key] == jm[key]


@pytest.mark.parametrize("arm", QUANT_ARMS, ids=["w8", "kv8", "w8kv8"])
def test_engine_streams_match_jax_under_preemption(weights, arm):
    """A pool of 7 four-token pages for four requests: preempt-by-
    recompute, whose re-prefill rewrites pages and resets their scales."""
    prompts = [[5, 9, 2], [17, 3], [2, 4, 6], [8, 1, 0]]
    jout, tout, jeng, teng = _both_engines(
        weights, prompts, max_tokens=10, max_len=64, page_size=4, n_pages=7,
        prefill_chunk=4, prefill_token_budget=8, **arm)
    assert tout == jout
    assert teng.stats["preemptions"] > 0
    assert teng.stats["preemptions"] == jeng.stats["preemptions"]


def test_engine_int8_bucketed_equals_full_width(weights):
    """tests/test_width_bucketing.py:141 on the port: the scale planes
    ride the sliced tables, so int8 bucketed == int8 full-width."""
    _, tp = weights
    prompts = _prompts(3, (5, 20, 40, 70, 100))
    outs = []
    for bucketing in (True, False):
        eng = LLMEngine(TCFG, tp, n_slots=4, max_len=128, page_size=16,
                        prefill_chunk=16, prefill_token_budget=32,
                        prefill_width_bucketing=bucketing, kv_dtype="int8",
                        device="cpu")
        outs.append(_drive(eng, [eng.submit(p, max_tokens=8)
                                 for p in prompts]))
    assert outs[0] == outs[1]


def test_pool_bytes_halve_plus_scale_planes(weights):
    """tests/test_quant.py:215's pin: cfg.dtype is fp32 here, so the int8
    planes are a quarter of the bytes, plus two [L, P+1] bf16 scale
    planes."""
    _, tp = weights
    kw = dict(n_slots=4, max_len=128, page_size=16, prefill_chunk=16,
              prefill_token_budget=32, device="cpu")
    mb = LLMEngine(TCFG, tp, **kw).metrics()
    q = LLMEngine(TCFG, tp, kv_dtype="int8", weight_dtype="int8", **kw)
    mq = q.metrics()
    assert (mb["llm_kv_dtype"], mq["llm_kv_dtype"]) == ("bf16", "int8")
    assert (mb["llm_weight_dtype"], mq["llm_weight_dtype"]) == ("bf16", "int8")
    scale_bytes = 2 * TCFG.n_layers * (q.n_pages + 1) * 2
    assert mq["kv_pool_bytes"] == mb["kv_pool_bytes"] // 4 + scale_bytes
    assert q.params["wq"].dtype == torch.int8
    assert q.params["wq_scale"].dtype == torch.float32
    assert q.params["wte"].dtype == TCFG.dtype


def test_int8_engine_runs_on_cuda_by_default(weights):
    """The quantized engine's entry point defaults to the card like every
    other: without a GPU it raises unless device="cpu" is given."""
    _, tp = weights
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngine(TCFG, tp, n_slots=2, max_len=32, page_size=8,
                  prefill_chunk=8, prefill_token_budget=8,
                  weight_dtype="int8", kv_dtype="int8")
