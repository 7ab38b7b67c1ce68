"""PyTorch port vs the JAX package: the two paged-attention functions.

The port's plain versions (``reference_paged_attention``,
``reference_paged_prefill_attention``) are held against the JAX Pallas
kernels run in interpret mode (as tests/test_paged_attention.py runs
them on the CPU) and against the JAX gather references, on the same
numpy pools and tables: the ragged cases (length 1, mid-page, page
boundary, full table, idle all-null slot), page sizes {8, 16}, fp32 and
bf16, and width-sliced prefill tables. On the CPU the wrappers take the
plain path — asserted, with the kernel launch counters left at 0. The
int8 pools' parity tests are in tests/test_torch_quant.py. The
CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tpu.ops.paged_attention import (
    paged_attention as jax_paged_attention,
    paged_prefill_attention as jax_paged_prefill_attention,
    reference_paged_attention as jax_reference_paged_attention,
    reference_paged_prefill_attention as jax_reference_paged_prefill_attention,
)
from ray_tpu_torch.ops import paged_attention as tpa

DT = {"fp32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
ATOL = {"fp32": 1e-5, "bf16": 3e-2}   # bf16: output rounding + softmax
                                      # reassociation, as the JAX test


def _pair(a, dt):
    jd, td = DT[dt]
    j = jnp.asarray(a, jd)
    return j, torch.from_numpy(np.array(j, np.float32)).to(td)


def _ragged(rng, *, B, H, K, ps, n_pg):
    """Pools with every slot's pages allocated and ragged lengths: 1,
    mid-page, page boundary, full table, and an all-null idle slot."""
    n_pages = B * n_pg + 1
    k_pool = rng.normal(size=(n_pages, ps, H, K)).astype(np.float32)
    v_pool = rng.normal(size=(n_pages, ps, H, K)).astype(np.float32)
    tables = np.zeros((B, n_pg), np.int32)
    lengths = np.zeros(B, np.int32)
    specs = [1, ps // 2 + 1, ps, n_pg * ps, 1]
    nxt = 1
    for b in range(B):
        length = specs[b % len(specs)]
        if b == B - 1:
            lengths[b] = 1       # idle slot: all-null table
            continue
        for j in range((length + ps - 1) // ps):
            tables[b, j] = nxt
            nxt += 1
        lengths[b] = length
    return k_pool, v_pool, tables, lengths


def _close(t, j, dt):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=ATOL[dt])


@pytest.fixture(autouse=True)
def _zero_counts():
    tpa.reset_launch_counts()
    yield
    for fn in (tpa.paged_attention, tpa.paged_prefill_attention):
        assert (fn.launches, fn.int8_launches) == (0, 0)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("ps", [8, 16])
def test_decode_matches_jax(ps, dt):
    rng = np.random.default_rng(0)
    B, H, K, n_pg = 6, 4, 16, 3
    q = rng.normal(size=(B, H, K)).astype(np.float32)
    k_pool, v_pool, tables, lengths = _ragged(rng, B=B, H=H, K=K, ps=ps,
                                              n_pg=n_pg)
    jq, tq = _pair(q, dt)
    jk, tk = _pair(k_pool, dt)
    jv, tv = _pair(v_pool, dt)
    jt, tt = jnp.asarray(tables), torch.from_numpy(tables)
    jl, tl = jnp.asarray(lengths), torch.from_numpy(lengths)
    out = tpa.paged_attention(tq, tk, tv, tt, tl)       # CPU → plain path
    assert out.dtype == tq.dtype and out.shape == tq.shape
    ref_plain = tpa.reference_paged_attention(tq, tk, tv, tt, tl)
    torch.testing.assert_close(out, ref_plain, rtol=0, atol=0)
    _close(out, jax_paged_attention(jq, jk, jv, jt, jl, interpret=True), dt)
    _close(out, jax_reference_paged_attention(jq, jk, jv, jt, jl), dt)


def test_decode_single_position_is_that_v_row():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(2, 4, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(3, 8, 4, 8)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(3, 8, 4, 8)).astype(np.float32))
    out = tpa.paged_attention(q, k, v, torch.tensor([[1], [2]],
                                                    dtype=torch.int32),
                              torch.tensor([1, 1], dtype=torch.int32))
    torch.testing.assert_close(out[0], v[1, 0], rtol=0, atol=1e-6)
    torch.testing.assert_close(out[1], v[2, 0], rtol=0, atol=1e-6)


def _prefill_case(rng, *, B, C, H, K, ps, n_pg, width):
    k_pool, v_pool, tables, _ = _ragged(rng, B=B, H=H, K=K, ps=ps,
                                        n_pg=n_pg)
    # Ragged chunk rows: interior chunk at a page boundary, a chunk that
    # ends mid-page, a one-token chunk, an inert row (n_valid 0), a
    # chunk at offset 0 and the idle all-null slot.
    offsets = np.zeros(B, np.int32)
    n_valid = np.zeros(B, np.int32)
    cap = width * ps
    for b, (off, n) in enumerate([(ps, C), (ps + 3, C - 2), (2, 1), (0, 0),
                                  (0, C), (0, 1)][:B]):
        off = min(off, cap - 1)
        offsets[b] = off
        n_valid[b] = min(n, cap - off)
    q = rng.normal(size=(B, C, H, K)).astype(np.float32)
    return q, k_pool, v_pool, tables[:, :width].copy(), offsets, (
        offsets + n_valid).astype(np.int32)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("width", [2, 4])
def test_prefill_matches_jax(ps, dt, width):
    """Chunk rows at ragged offsets against a width-sliced table (width
    2 of 4 pages) and the full table."""
    rng = np.random.default_rng(2)
    q, k_pool, v_pool, tables, offsets, lengths = _prefill_case(
        rng, B=6, C=8, H=2, K=16, ps=ps, n_pg=4, width=width)
    jq, tq = _pair(q, dt)
    jk, tk = _pair(k_pool, dt)
    jv, tv = _pair(v_pool, dt)
    args_j = (jnp.asarray(tables), jnp.asarray(offsets), jnp.asarray(lengths))
    args_t = (torch.from_numpy(tables), torch.from_numpy(offsets),
              torch.from_numpy(lengths))
    out = tpa.paged_prefill_attention(tq, tk, tv, *args_t)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    assert torch.isfinite(out.float()).all()            # pad rows finite
    torch.testing.assert_close(
        out, tpa.reference_paged_prefill_attention(tq, tk, tv, *args_t),
        rtol=0, atol=0)
    # A slot with lengths 0 (inert row at offset 0) has no valid position:
    # the kernels write zeros (the l == 0 guard), the gather versions the
    # uniform average of V. The engine discards both; compare the rest.
    live = lengths > 0
    _close(out[live], np.asarray(jax_paged_prefill_attention(
        jq, jk, jv, *args_j, interpret=True), np.float32)[live], dt)
    _close(out, jax_reference_paged_prefill_attention(jq, jk, jv, *args_j),
           dt)


def test_int8_pools_take_the_plain_path_on_cpu():
    """Once a refusal, now the int8 programs' CPU path: both wrappers take
    an int8 pool with its per-page scales to the plain versions (the
    launch counters, int8 ones included, stay 0), and the scales are
    read by page id: doubling one page's V scale doubles exactly that
    page's share of the output."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(1, 2, 8)).astype(np.float32))
    pool = torch.from_numpy(rng.integers(-127, 128, size=(3, 4, 2, 8)).astype(
        np.int8))
    t = torch.tensor([[2]], dtype=torch.int32)
    n = torch.ones(1, dtype=torch.int32)
    ks = torch.full((3,), 0.01)
    vs = ks.clone()
    out = tpa.paged_attention(q, pool, pool, t, n, k_scale=ks, v_scale=vs)
    torch.testing.assert_close(out[0], pool[2, 0].float() * 0.01)
    vs[2] = 0.02
    vs[1] = 5.0                                 # not in the table: unread
    torch.testing.assert_close(
        tpa.paged_attention(q, pool, pool, t, n, k_scale=ks, v_scale=vs),
        2 * out)
    chunk = tpa.paged_prefill_attention(q[:, None], pool, pool, t, n - 1, n,
                                        k_scale=ks, v_scale=vs)
    torch.testing.assert_close(chunk[:, 0], 2 * out)
    assert tpa.paged_attention.int8_launches == 0
    assert tpa.paged_prefill_attention.int8_launches == 0


def test_shape_mismatch_raises():
    with pytest.raises(ValueError, match="shape mismatch"):
        tpa.paged_attention(torch.zeros(1, 2, 8), torch.zeros(2, 4, 3, 8),
                            torch.zeros(2, 4, 3, 8),
                            torch.zeros(1, 1, dtype=torch.int32),
                            torch.ones(1, dtype=torch.int32))
