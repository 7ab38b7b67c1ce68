"""The port's CUDA kernels on the card (marked ``cuda``; skipped without one).

Each kernel against its plain PyTorch version on CUDA tensors (paged:
ragged lengths, idle all-null slots, width-sliced prefill tables, a
partial query tile, float pools and int8 pools with per-page scales;
flash: forward, dq and dkv, causal and not, S != T, an lse cotangent,
the bf16 kernels also at ragged S/T on packed qkv views;
fp32 and bf16, the tensor-core head dims 64 and 128), the launch
counters, the wrappers' refusals (no fallback to the plain path), the
tiny engine with ``attn_impl="kernel"`` against ``"gather"`` on the
card (float, and int8 weights with an int8 pool), and one
gpt2_124m-wide training step with
``attn_impl="flash"`` against ``"xla"``. The file imports neither JAX nor the JAX package, and the
repo's conftest does, so run it with::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

chip_smoke.py holds the same kernels to the same tolerances at OPT-1.3B
shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import gpt
from ray_tpu_torch.models import paged_kv as pk
from ray_tpu_torch.ops import attention as fa
from ray_tpu_torch.ops import paged_attention as pa
from ray_tpu_torch.serve.llm import LLMEngine

pytestmark = pytest.mark.cuda

# fp32: reassociation of fp32 sums only. bf16: each side rounds every
# probability and its output to bf16 (unit roundoff u = 2^-8), so per
# element |out - ref| <= 2u (|ref| + S), S the attention of |V| in fp32
# (chip_smoke.py derives it); 8e-3 > 2u leaves room for the fp32 terms.
FP32_ATOL = 1e-5
BF16_REL = 8e-3
# The int8 programs with bf16 q do not round p (the Pallas programs' math),
# so against the plain version on q.float() (p unrounded, fp32 output) only
# the output's bf16 rounding (half a bf16 ulp of out) and the hi + lo split
# of p·vs (<= 2^-16 S) remain: |out - ref32| <= half_ulp(out) + 4e-5 S.
P_UNROUNDED_S = 4e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernels are built with nvcc)")
    pa.reset_launch_counts()
    fa.reset_launch_counts()
    return torch.device("cuda")


def _pool(rng, n_pages, ps, H, K, dtype, dev):
    def plane():
        return torch.from_numpy(rng.normal(size=(n_pages, ps, H, K)).astype(
            np.float32)).to(dev, dtype)
    return plane(), plane()


def _abs_v(reference, q, kp, vp, *args):
    """S of the bf16 bound: the plain version on fp32 copies with |V|."""
    return reference(q.float(), kp.float(), vp.float().abs(), *args)


def _close(out, ref, dtype, s_abs, rtol=0.0):
    out, ref = out.float(), ref.float()
    assert torch.isfinite(out).all()
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=rtol, atol=FP32_ATOL)
        return
    err = (out - ref).abs()
    share = err / (BF16_REL * (ref.abs() + s_abs))
    share = torch.where(err == 0, torch.zeros_like(share), share)  # 0 / 0
    assert float(share.max()) <= 1.0, float(share.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps,K", [(16, 64), (64, 64), (64, 128)])
def test_decode_kernel_matches_plain(cuda, dtype, ps, K):
    rng = np.random.default_rng(0)
    B, H, n_pg = 5, 4, 3
    kp, vp = _pool(rng, B * n_pg + 1, ps, H, K, dtype, cuda)
    tables = np.zeros((B, n_pg), np.int32)
    lengths = np.array([1, ps // 2 + 1, ps, n_pg * ps, 1], np.int32)
    for b in range(B - 1):                  # the last slot idles on page 0
        n = -(-int(lengths[b]) // ps)
        tables[b, :n] = np.arange(1, n + 1) + b * n_pg
    q = torch.from_numpy(rng.normal(size=(B, H, K)).astype(np.float32)).to(
        cuda, dtype)
    t = torch.from_numpy(tables).to(cuda)
    n = torch.from_numpy(lengths).to(cuda)
    out = pa.paged_attention(q, kp, vp, t, n)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == 1
    assert out.dtype == dtype and out.shape == q.shape
    _close(out, pa.reference_paged_attention(q, kp, vp, t, n), dtype,
           _abs_v(pa.reference_paged_attention, q, kp, vp, t, n))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps,K", [(16, 64), (64, 64), (64, 128)])
@pytest.mark.parametrize("C", [72, 128])
def test_prefill_kernel_matches_plain(cuda, dtype, ps, K, C):
    """Chunk rows at ragged offsets against a width-sliced table; C=72
    leaves a partial query tile."""
    rng = np.random.default_rng(1)
    B, H, n_pg = 5, 2, 512 // ps
    width = n_pg // 2
    kp, vp = _pool(rng, B * n_pg + 1, ps, H, K, dtype, cuda)
    tables = (np.arange(B * n_pg, dtype=np.int32).reshape(B, n_pg) + 1)
    cap = width * ps
    rows = [(0, C), (ps + 3, C - 5), (cap - C, C), (7, 1), (0, 0)]
    offs = np.array([o for o, _ in rows], np.int32)
    lens = np.array([o + v for o, v in rows], np.int32)
    q = torch.from_numpy(rng.normal(size=(B, C, H, K)).astype(
        np.float32)).to(cuda, dtype)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in (tables[:, :width], offs, lens)]
    out = pa.paged_prefill_attention(q, kp, vp, *args)
    torch.cuda.synchronize()
    assert pa.paged_prefill_attention.launches == 1
    ref = pa.reference_paged_prefill_attention(q, kp, vp, *args)
    live = torch.from_numpy(lens > 0).to(cuda)
    assert torch.all(out[~live] == 0)        # inert row: the l == 0 guard
    s_abs = _abs_v(pa.reference_paged_prefill_attention, q, kp, vp, *args)
    _close(out[live], ref[live], dtype, s_abs[live])


def _int8_pool(rng, n_pages, ps, H, K, dev):
    """int8 K/V pools with their bf16 scale vectors: normal rows, each
    page at its own amplitude (log-uniform in [0.25, 4], so a wrong scale
    shows), quantized page by page with the port's own `_quant_write`."""
    out = []
    for _ in range(2):
        amp = np.exp(rng.uniform(np.log(0.25), np.log(4.0), n_pages))
        rows = rng.normal(size=(n_pages, ps, H, K)) * amp[:, None, None, None]
        plane = torch.zeros(n_pages, ps, H, K, dtype=torch.int8, device=dev)
        scale = torch.zeros(n_pages, dtype=torch.bfloat16, device=dev)
        pages = torch.arange(n_pages, device=dev).repeat_interleave(ps)
        offs = torch.arange(ps, device=dev).repeat(n_pages)
        pk._quant_write(plane, scale, pages, offs, torch.from_numpy(
            rows.reshape(-1, H, K).astype(np.float32)).to(dev))
        out += [plane, scale]
    return out          # k_pool, k_scale, v_pool, v_scale


def _abs_v_int8(reference, q, kp, ks, vp, vs, *args):
    """S of the bf16 bound for an int8 pool: the plain version with |V|."""
    return reference(q.float(), kp, vp.abs(), *args, k_scale=ks, v_scale=vs)


def _close_p_unrounded(out, ref32, s_abs):
    """A bf16-q int8 program against the plain version on q.float()."""
    out = out.float()
    _, e = torch.frexp(out)
    half_ulp = torch.where(out == 0, torch.zeros_like(out),
                           torch.ldexp(torch.ones_like(out), e - 9))
    err = (out - ref32).abs()
    assert bool((err <= half_ulp + P_UNROUNDED_S * s_abs).all()), float(
        ((err - half_ulp) / (P_UNROUNDED_S * s_abs)).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps,K", [(16, 64), (64, 64), (16, 128), (64, 128)])
def test_decode_int8_kernel_matches_plain(cuda, dtype, ps, K):
    rng = np.random.default_rng(6)
    B, H, n_pg = 5, 4, 3
    kp, ks, vp, vs = _int8_pool(rng, B * n_pg + 1, ps, H, K, cuda)
    tables = np.zeros((B, n_pg), np.int32)
    lengths = np.array([1, ps // 2 + 1, ps, n_pg * ps, 1], np.int32)
    perm = rng.permutation(np.arange(1, B * n_pg + 1)).astype(np.int32)
    for b in range(B - 1):                  # the last slot idles on page 0
        n = -(-int(lengths[b]) // ps)
        tables[b, :n] = perm[b * n_pg:b * n_pg + n]
    q = torch.from_numpy(rng.normal(size=(B, H, K)).astype(np.float32)).to(
        cuda, dtype)
    t = torch.from_numpy(tables).to(cuda)
    n = torch.from_numpy(lengths).to(cuda)
    out = pa.paged_attention(q, kp, vp, t, n, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert (pa.paged_attention.int8_launches,
            pa.paged_attention.launches) == (1, 0)
    assert out.dtype == dtype and out.shape == q.shape
    ref = pa.reference_paged_attention(q, kp, vp, t, n, k_scale=ks,
                                       v_scale=vs)
    s_abs = _abs_v_int8(pa.reference_paged_attention, q, kp, ks, vp, vs, t,
                        n)
    _close(out, ref, dtype, s_abs, rtol=1e-5)
    if dtype == torch.bfloat16:
        _close_p_unrounded(out, pa.reference_paged_attention(
            q.float(), kp, vp, t, n, k_scale=ks, v_scale=vs), s_abs)


def _ragged_decode_lengths(B, ps, n_pg):
    """B slot lengths cycling through the split paths' edges: the full
    table, a length past it (an idle slot's cursor), 0, an idle slot on
    the null page (1), a length ending on a page boundary mid-table, one
    past it and one short of it, a mid-page length."""
    mid = ps * max(1, n_pg // 2)
    pattern = [n_pg * ps, n_pg * ps + 37, 0, 1, mid, mid + 1, mid - 1,
               ps // 2 + 1]
    return np.array([pattern[b % len(pattern)] for b in range(B)], np.int32)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,n_pg", [(1, 8, 1), (1, 8, 9), (5, 8, 1),
                                      (5, 6, 9), (16, 8, 1), (16, 32, 20)])
def test_decode_splits_match_plain(cuda, dtype, quant, B, H, n_pg):
    """The decode kernel with one split (a one-page table: the block writes
    the output) and with several (the last block to finish merges the
    splits, and leaves its arrival count zero), float and int8 pools,
    at ragged lengths (`_ragged_decode_lengths`; H = 6 leaves a group of
    two heads); ps = 16, so int8's 32-position stages span two pages. A
    slot of length 0 gets zeros (the l == 0 guard; the plain version's
    uniform average is by definition). A second call gives the same
    bits."""
    ps, K = 16, 64
    rng = np.random.default_rng(10)
    n_split = pa.decode_splits(B, H, n_pg, pa._sm_count(cuda))
    assert (n_split == 1) == (n_pg == 1)
    lengths = _ragged_decode_lengths(B, ps, n_pg)
    idle = {b for b in range(B) if lengths[b] <= 1}
    need = [0 if b in idle else min(-(-int(n) // ps), n_pg)
            for b, n in enumerate(lengths)]
    n_pages = sum(need) + 1
    if quant:
        kp, ks, vp, vs = _int8_pool(rng, n_pages, ps, H, K, cuda)
        sc = {"k_scale": ks, "v_scale": vs}
    else:
        kp, vp = _pool(rng, n_pages, ps, H, K, dtype, cuda)
        sc = {}
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    tables = np.zeros((B, n_pg), np.int32)
    at = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[at:at + n]
        at += n
    q = torch.from_numpy(rng.normal(size=(B, H, K)).astype(np.float32)).to(
        cuda, dtype)
    t = torch.from_numpy(tables).to(cuda)
    n = torch.from_numpy(lengths).to(cuda)
    out = pa.paged_attention(q, kp, vp, t, n, **sc)
    again = pa.paged_attention(q, kp, vp, t, n, **sc)
    torch.cuda.synchronize()
    assert (pa.paged_attention.int8_launches,
            pa.paged_attention.launches) == ((2, 0) if quant else (0, 2))
    assert torch.equal(out, again)
    if n_split > 1:           # the last block of each group zeroed its count
        counters = pa._DECODE_COUNTERS[(q.device.index,
                                        pa._stream_ptr(q.device))]
        assert int(counters.abs().sum()) == 0
    live = n > 0
    assert torch.all(out[~live] == 0)
    ref = pa.reference_paged_attention(q, kp, vp, t, n, **sc)
    if quant:
        s_abs = _abs_v_int8(pa.reference_paged_attention, q, kp, ks, vp, vs,
                            t, n)
    else:
        s_abs = _abs_v(pa.reference_paged_attention, q, kp, vp, t, n)
    _close(out[live], ref[live], dtype, s_abs[live], rtol=1e-5 if quant else 0)
    if quant and dtype == torch.bfloat16:
        ref32 = pa.reference_paged_attention(q.float(), kp, vp, t, n, **sc)
        _close_p_unrounded(out[live], ref32[live], s_abs[live])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps,K", [(16, 64), (64, 64), (16, 128), (64, 128)])
@pytest.mark.parametrize("C", [72, 128])
def test_prefill_int8_kernel_matches_plain(cuda, dtype, ps, K, C):
    """As test_prefill_kernel_matches_plain on int8 pools: scattered pages,
    so a 64-key tile at ps = 16 spans four pages with four scales."""
    rng = np.random.default_rng(7)
    B, H, n_pg = 5, 2, 512 // ps
    width = n_pg // 2
    kp, ks, vp, vs = _int8_pool(rng, B * n_pg + 1, ps, H, K, cuda)
    tables = (rng.permutation(B * n_pg).astype(np.int32) + 1).reshape(B, n_pg)
    cap = width * ps
    rows = [(0, C), (ps + 3, C - 5), (cap - C, C), (7, 1), (0, 0)]
    offs = np.array([o for o, _ in rows], np.int32)
    lens = np.array([o + v for o, v in rows], np.int32)
    q = torch.from_numpy(rng.normal(size=(B, C, H, K)).astype(
        np.float32)).to(cuda, dtype)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in (tables[:, :width], offs, lens)]
    out = pa.paged_prefill_attention(q, kp, vp, *args, k_scale=ks,
                                      v_scale=vs)
    torch.cuda.synchronize()
    assert (pa.paged_prefill_attention.int8_launches,
            pa.paged_prefill_attention.launches) == (1, 0)
    ref = pa.reference_paged_prefill_attention(q, kp, vp, *args, k_scale=ks,
                                               v_scale=vs)
    live = torch.from_numpy(lens > 0).to(cuda)
    assert torch.all(out[~live] == 0)        # inert row: the l == 0 guard
    s_abs = _abs_v_int8(pa.reference_paged_prefill_attention, q, kp, ks, vp,
                        vs, *args)
    _close(out[live], ref[live], dtype, s_abs[live], rtol=1e-5)
    if dtype == torch.bfloat16:
        ref32 = pa.reference_paged_prefill_attention(
            q.float(), kp, vp, *args, k_scale=ks, v_scale=vs)
        _close_p_unrounded(out[live], ref32[live], s_abs[live])


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("K", [64, 128])
@pytest.mark.parametrize("ps", [16, 32, 64, 128, 48])
def test_prefill_bf16_page_sizes_and_chunks(cuda, ps, K, quant):
    """bf16 q at each page size: 16, 32, 64 and 128 take the wgmma kernel,
    48 (neither divides nor is a multiple of 64) the mma.sync kernel, all
    counted by the same counter. Chunks of C = 40, 72 and 200 at ragged
    offsets against a width-sliced table, with an inert row; float and
    int8 pools (the int8 program also against the unrounded-p plain
    version)."""
    assert pa.prefill_kernel(torch.bfloat16, K, ps) == (
        "mma" if ps == 48 else "wgmma")
    rng = np.random.default_rng(9)
    B, H = 5, 2
    n_pg = -(-640 // ps)
    width = n_pg - 1
    if quant:
        kp, ks, vp, vs = _int8_pool(rng, B * n_pg + 1, ps, H, K, cuda)
        sc = {"k_scale": ks, "v_scale": vs}
    else:
        kp, vp = _pool(rng, B * n_pg + 1, ps, H, K, torch.bfloat16, cuda)
        sc = {}
    tables = (rng.permutation(B * n_pg).astype(np.int32) + 1).reshape(B, n_pg)
    cap = width * ps
    for C in (40, 72, 200):
        rows = [(0, C), (ps + 3, C - 5), (cap - C, C), (11, 1), (0, 0)]
        offs = np.array([o for o, _ in rows], np.int32)
        lens = np.array([o + v for o, v in rows], np.int32)
        q = torch.from_numpy(rng.normal(size=(B, C, H, K)).astype(
            np.float32)).to(cuda, torch.bfloat16)
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
                for a in (tables[:, :width], offs, lens)]
        pa.reset_launch_counts()
        out = pa.paged_prefill_attention(q, kp, vp, *args, **sc)
        torch.cuda.synchronize()
        assert (pa.paged_prefill_attention.int8_launches,
                pa.paged_prefill_attention.launches) == (
            (1, 0) if quant else (0, 1))
        ref = pa.reference_paged_prefill_attention(q, kp, vp, *args, **sc)
        live = torch.from_numpy(lens > 0).to(cuda)
        assert torch.all(out[~live] == 0)    # inert row: the l == 0 guard
        if quant:
            s_abs = _abs_v_int8(pa.reference_paged_prefill_attention, q, kp,
                                ks, vp, vs, *args)
        else:
            s_abs = _abs_v(pa.reference_paged_prefill_attention, q, kp, vp,
                           *args)
        _close(out[live], ref[live], torch.bfloat16, s_abs[live])
        if quant:
            ref32 = pa.reference_paged_prefill_attention(q.float(), kp, vp,
                                                         *args, **sc)
            _close_p_unrounded(out[live], ref32[live], s_abs[live])


@pytest.mark.parametrize("K", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,T", [(200, 333), (1, 64), (333, 200)])
@pytest.mark.parametrize("packed", [False, True])
def test_flash_fwd_bf16_edges_and_strided_views(cuda, K, causal, S, T, packed):
    """The bf16 forward (wgmma, tensor maps over the views) at ragged S and
    T, on contiguous tensors and on q, k, v taken as views of packed
    [B, S, 3, H, K] tensors, as the train step's qkv projection passes
    them: o keeps q's layout and matches the plain version; lse too."""
    rng = np.random.default_rng(10)
    B, H = 2, 3
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(cuda, torch.bfloat16)
    if packed:
        qkv_q, qkv_kv = t(B, S, 3, H, K), t(B, T, 3, H, K)
        q, k, v = qkv_q[:, :, 0], qkv_kv[:, :, 1], qkv_kv[:, :, 2]
    else:
        q, k, v = t(B, S, H, K), t(B, T, H, K), t(B, T, H, K)
    scale = K ** -0.5
    o, lse = fa.flash_fwd(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches == 1
    o_ref, lse_ref = fa.reference_flash_fwd(q, k, v, causal, scale)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-4)
    s_abs = _flash_abs_sums(q, k, v, q, lse_ref, lse_ref, causal, scale)[0]
    _close(o, o_ref, torch.bfloat16, s_abs)


@pytest.mark.parametrize("K", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,T", [(200, 333), (1, 64), (333, 200)])
@pytest.mark.parametrize("packed", [False, True])
def test_flash_bwd_bf16_edges_and_strided_views(cuda, K, causal, S, T,
                                                packed):
    """The bf16 dq and dkv kernels (wgmma, tensor maps over the views) at
    ragged S and T, on contiguous tensors and on q, k, v taken as views of
    packed [B, S, 3, H, K] tensors, with an lse cotangent: each gradient
    keeps its input's layout and matches the plain version."""
    rng = np.random.default_rng(12)
    B, H = 2, 3
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(cuda, torch.bfloat16)
    if packed:
        qkv_q, qkv_kv = t(B, S, 3, H, K), t(B, T, 3, H, K)
        q, k, v = qkv_q[:, :, 0], qkv_kv[:, :, 1], qkv_kv[:, :, 2]
    else:
        q, k, v = t(B, S, H, K), t(B, T, H, K), t(B, T, H, K)
    do = t(B, S, H, K)
    dlse = t(B, S, H).float()
    scale = K ** -0.5
    o, lse = fa.reference_flash_fwd(q, k, v, causal, scale)
    delta = fa.flash_delta(o, do, dlse)
    dq = fa.flash_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, causal, scale)
    torch.cuda.synchronize()
    assert (fa.flash_dq.launches, fa.flash_dkv.launches) == (1, 1)
    like = lambda x: torch.empty_like(x).stride()
    assert (dq.stride(), dk.stride(), dv.stride()) == (like(q), like(k),
                                                       like(v))
    refs = (fa.reference_flash_dq(q, k, v, do, lse, delta, causal, scale),
            *fa.reference_flash_dkv(q, k, v, do, lse, delta, causal, scale))
    sums = _flash_abs_sums(q, k, v, do, lse, delta, causal, scale)[1:]
    for out, ref, s_abs in zip((dq, dk, dv), refs, sums):
        assert out.dtype == torch.bfloat16 and out.shape == ref.shape
        _close(out, ref, torch.bfloat16, s_abs)


@pytest.mark.parametrize("S,T", [(5, 0), (0, 70)])
def test_flash_bwd_bf16_empty_side(cuda, S, T):
    """No key (T = 0): dq = 0 from the dq kernel; no query row (S = 0):
    dk = dv = 0 from the dkv kernel, whose items then walk no tile."""
    B, H, K = 2, 3, 64
    z = lambda n: torch.randn(B, n, H, K, device=cuda).to(torch.bfloat16)
    q, k, v, do = z(S), z(T), z(T), z(S)
    lse = torch.zeros(B, S, H, device=cuda)
    dq = fa.flash_dq(q, k, v, do, lse, lse, True, 0.125)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, lse, True, 0.125)
    torch.cuda.synchronize()
    for out, ref in zip((dq, dk, dv), (q, k, v)):
        assert out.shape == ref.shape and not out.float().abs().sum()


@pytest.mark.parametrize("name,value,kernels", [
    ("DKV_ROWS", 128, ("flash_dkv",)),
    ("DKV_KEYS", 64, ("flash_dkv",)),
    ("WGMMA_ROWS", 64, ("flash_fwd", "flash_dq")),
])
def test_flash_launchers_refuse_other_box_rows(cuda, monkeypatch, name,
                                               value, kernels):
    """The bf16 flash launchers hold the plan's box rows to their own tile
    constants (expect_tx bytes, shared-memory offsets): a plan with other
    rows is refused at launch, before any kernel runs."""
    q, k, v, do = (torch.randn(1, 64, 2, 64, device=cuda).to(torch.bfloat16)
                   for _ in range(4))
    lse = torch.zeros(1, 64, 2, device=cuda)
    calls = {"flash_fwd": lambda: fa.flash_fwd(q, k, v),
             "flash_dq": lambda: fa.flash_dq(q, k, v, do, lse, lse),
             "flash_dkv": lambda: fa.flash_dkv(q, k, v, do, lse, lse)}
    monkeypatch.setattr(fa, name, value)
    for kern in kernels:
        with pytest.raises(RuntimeError, match=f"{kern} kernel launch"):
            calls[kern]()
        assert getattr(fa, kern).launches == 0


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 2, 8, device=cuda)
    pool = torch.zeros(2, 4, 2, 8, device=cuda)
    t = torch.zeros(1, 1, dtype=torch.int32, device=cuda)
    n = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_attention(q, pool, pool, t, n)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pa.paged_attention(q.half(), pool.half(), pool.half(), t, n)
    q64 = torch.zeros(1, 2, 64, device=cuda)
    pool64 = torch.zeros(2, 4, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="v_pool is on cpu"):
        pa.paged_attention(q64, pool64, pool64.cpu(), t, n)
    strided = torch.zeros(2, 2, 4, 64, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention(q64, strided, pool64, t, n)
    i8 = pool64.to(torch.int8)
    scale = torch.ones(2, device=cuda)
    with pytest.raises(ValueError, match="needs k_scale"):
        pa.paged_attention(q64, i8, i8, t, n)
    with pytest.raises(ValueError, match="k_scale dtype torch.float32"):
        pa.paged_attention(q64, i8, i8, t, n, k_scale=scale,
                           v_scale=scale.bfloat16())
    assert pa.paged_attention.launches == 0
    assert pa.paged_attention.int8_launches == 0


def test_engine_kernel_streams_match_gather_on_the_card(cuda):
    cfg = gpt.GPTConfig.tiny_untied(dtype=torch.float32, d_model=256,
                                    n_heads=4)          # head_dim 64
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = gpt.init_params(cfg, gen, cuda)
    rng = np.random.default_rng(2)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n)))
               for n in (3, 40, 90, 17, 64)]
    outs = {}
    for impl in ("kernel", "gather"):
        eng = LLMEngine(cfg, params, n_slots=4, max_len=128, page_size=16,
                        prefill_chunk=32, prefill_token_budget=64,
                        attn_impl=impl, device=cuda)
        reqs = [eng.submit(p, max_tokens=8) for p in prompts]
        for _ in range(400):
            if all(r.done.is_set() for r in reqs):
                break
            eng.step()
        assert all(r.done.is_set() and r.error is None for r in reqs)
        acc = eng.page_accounting()
        assert acc["closure"] and acc["free"] == acc["total"]
        outs[impl] = [r.out_ids for r in reqs]
    assert pa.paged_attention.launches > 0
    assert pa.paged_prefill_attention.launches > 0
    assert outs["kernel"] == outs["gather"]


def test_engine_int8_kernel_streams_match_gather_on_the_card(cuda):
    """int8 weights and an int8 pool: the int8 programs' streams equal the
    gather engine's (fp32 activations, so neither side rounds p), and no
    float program runs."""
    cfg = gpt.GPTConfig.tiny_untied(dtype=torch.float32, d_model=256,
                                    n_heads=4)          # head_dim 64
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = gpt.init_params(cfg, gen, cuda)
    rng = np.random.default_rng(8)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n)))
               for n in (3, 40, 90, 17, 64)]
    outs = {}
    for impl in ("kernel", "gather"):
        eng = LLMEngine(cfg, params, n_slots=4, max_len=128, page_size=16,
                        prefill_chunk=32, prefill_token_budget=64,
                        attn_impl=impl, weight_dtype="int8", kv_dtype="int8",
                        device=cuda)
        reqs = [eng.submit(p, max_tokens=8) for p in prompts]
        for _ in range(400):
            if all(r.done.is_set() for r in reqs):
                break
            eng.step()
        assert all(r.done.is_set() and r.error is None for r in reqs)
        acc = eng.page_accounting()
        assert acc["closure"] and acc["free"] == acc["total"]
        outs[impl] = [r.out_ids for r in reqs]
    assert pa.paged_attention.int8_launches > 0
    assert pa.paged_prefill_attention.int8_launches > 0
    assert (pa.paged_attention.launches,
            pa.paged_prefill_attention.launches) == (0, 0)
    assert outs["kernel"] == outs["gather"]


def _flash_abs_sums(q, k, v, do, lse, delta, causal, scale):
    """S of the bf16 bound of o, dq, dk, dv (chip_smoke.py derives it):
    the attention of |V|, W |K|, W^T |Q| and p^T |dO|, with
    W = p (|dP| + |delta|) sm_scale >= |ds|, all fp32."""
    qf, kf, vf, df = (t.float() for t in (q, k, v, do))
    s = torch.einsum("bshk,bthk->bhst", qf, kf) * scale
    mask = torch.ones(s.shape[-2:], dtype=torch.bool, device=q.device)
    if causal:
        mask = mask.tril()
    row = lambda x: x.transpose(1, 2)[..., None]
    p = torch.where(mask, torch.exp(s - row(lse)), torch.zeros_like(s))
    dp = torch.einsum("bshk,bthk->bhst", df, vf)
    w = p * (dp.abs() + row(delta).abs()) * scale
    s_o, _ = fa.reference_flash_fwd(qf, kf, vf.abs(), causal, scale)
    return (s_o, torch.einsum("bhst,bthk->bshk", w, kf.abs()),
            torch.einsum("bhst,bshk->bthk", w, qf.abs()),
            torch.einsum("bhst,bshk->bthk", p, df.abs()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,T", [(77, 130), (192, 192)])
def test_flash_kernels_match_plain(cuda, dtype, K, causal, S, T):
    """flash_fwd, flash_dq and flash_dkv each against its plain version
    on the same inputs (the backward from the plain forward's o and lse,
    with an lse cotangent)."""
    rng = np.random.default_rng(3)
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(cuda)
    B, H = 2, 3
    q, k, v, do = (t(B, n, H, K).to(dtype) for n in (S, T, T, S))
    dlse = t(B, S, H)
    scale = K ** -0.5
    o, lse = fa.flash_fwd(q, k, v, causal, scale)
    o_ref, lse_ref = fa.reference_flash_fwd(q, k, v, causal, scale)
    delta = fa.flash_delta(o_ref, do, dlse)
    dq = fa.flash_dq(q, k, v, do, lse_ref, delta, causal, scale)
    dk, dv = fa.flash_dkv(q, k, v, do, lse_ref, delta, causal, scale)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == (1, 1, 1)
    refs = (o_ref, fa.reference_flash_dq(q, k, v, do, lse_ref, delta, causal,
                                         scale),
            *fa.reference_flash_dkv(q, k, v, do, lse_ref, delta, causal,
                                    scale))
    sums = _flash_abs_sums(q, k, v, do, lse_ref, delta, causal, scale)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-4)
    for out, ref, s_abs in zip((o, dq, dk, dv), refs, sums):
        assert out.dtype == dtype and out.shape == ref.shape
        _close(out, ref, dtype, s_abs)


def test_flash_attention_autograd_and_refusals(cuda):
    """The autograd op runs the three kernels once each and gives the
    plain attention's gradients; head dims other than 64 and 128 and
    mixed dtypes are refused, never computed by the plain path."""
    rng = np.random.default_rng(4)
    ts = [torch.from_numpy(rng.normal(size=(2, 96, 4, 64)).astype(
        np.float32)).to(cuda).requires_grad_(True) for _ in range(3)]
    o, lse = fa.flash_attention(*ts, causal=True, return_lse=True)
    (o.square().sum() + lse.sum()).backward()
    assert (fa.flash_fwd.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == (1, 1, 1)
    grads = [x.grad.clone() for x in ts]
    for x in ts:
        x.grad = None
    o, lse = fa.reference_attention(*ts, causal=True, return_lse=True)
    (o.square().sum() + lse.sum()).backward()
    for a, x in zip(grads, ts):
        torch.testing.assert_close(a, x.grad, rtol=1e-4, atol=1e-4)
    q80 = torch.zeros(1, 8, 2, 80, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q80, q80, q80)
    q64 = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_fwd(q64, q64.bfloat16(), q64)
    assert fa.flash_fwd.launches == 1


def test_gpt_train_step_flash_matches_xla_on_the_card(cuda):
    """One training step at gpt2_124m's width (two layers, S=256) with
    the flash kernels against plain attention, from the same weights:
    the loss, the whole gradient and each layer's attention weights'
    gradients within chip_smoke.py's tolerances, which a zeroed dq fails;
    then the launches of remat (forward twice per block)."""
    from ray_tpu_torch.train.optim import adamw
    from ray_tpu_torch.train.spmd import build_training

    cfg = dataclasses.replace(gpt.GPTConfig.gpt2_124m(
        max_seq=256, remat=True, attn_impl="flash"), n_layers=2)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params, state, step = build_training(
        cfg, adamw(3e-4, weight_decay=0.1, mu_dtype=torch.bfloat16), gen,
        cuda)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 256))).to(
        cuda)
    tg = torch.roll(toks, -1, dims=1)

    def run(impl):
        loss = gpt.loss_fn(params, toks, tg,
                           dataclasses.replace(cfg, attn_impl=impl))
        grads = torch.autograd.grad(loss, list(params.values()))
        return float(loss.detach()), dict(zip(params, grads))

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    def attn_err(g, ref):
        return max(rel(g[n][i], ref[n][i]) for n in ("wq", "wk", "wv", "wo")
                   for i in range(cfg.n_layers))

    loss_x, g_x = run("xla")
    loss_f, g_f = run("flash")
    assert abs(loss_f - loss_x) <= 5e-4
    assert rel(torch.cat([g.flatten() for g in g_f.values()]),
               torch.cat([g.flatten() for g in g_x.values()])) <= 2e-2
    assert attn_err(g_f, g_x) <= 5e-2
    real = fa.flash_bwd

    def zero_dq(*args):
        dq, dk, dv = real(*args)
        return torch.zeros_like(dq), dk, dv

    fa.flash_bwd = zero_dq
    try:
        assert attn_err(run("flash")[1], g_x) > 5e-2
    finally:
        fa.flash_bwd = real
    fa.reset_launch_counts()
    losses = []
    for _ in range(3):
        params, state, loss = step(params, state, (toks, tg))
        losses.append(float(loss))
    assert (fa.flash_fwd.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == (12, 6, 6)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
