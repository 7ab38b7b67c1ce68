"""The port's CUDA kernels on the card (marked ``cuda``; skipped without one).

Each kernel against its plain PyTorch version on CUDA tensors (paged:
ragged lengths, idle all-null slots, width-sliced prefill tables, a
partial query tile, float pools and int8 pools with per-page scales;
flash: forward, delta, dq and dkv, causal and not, S != T, an lse
cotangent,
the bf16 kernels also at ragged S/T on packed qkv views;
fp32 and bf16, head dims 64, 80, 128 and 256, the backward at all four
and refusing 96; the bf16 prefill at page sizes 4 to 128, in TMA boxes
and in gathered rows, and the plans its C entry point refuses), the
launch
counters, the wrappers' refusals (no fallback to the plain path), the
tiny engine with ``attn_impl="kernel"`` against ``"gather"`` on the
card (float, and int8 weights with an int8 pool), the prefill kernel at
the speculative verify shape (C = 5 and 2 at ragged cursors) and both
paged kernels at a draft's 12 heads, the engine with the prefix cache
and a draft on the kernels against the plain engine, the one-shot
engines (float and int8) on the decode kernel against the one-shot
gather engine and the dense engine, a drain and resume round trip
(dense and chunked), a tp=2 kernel engine (both shards on the card)
against the tp=1 gather engine and both paged kernels at a tp shard's
heads (16, 8, 6), one
gpt2_124m-wide training step with
``attn_impl="flash"`` against ``"xla"``, ring attention over sp = 4 on
the card against full flash attention, the stochastic rounding's
mean with a generator on the card, the MoE layer on the card against a
plain top-2 loop (also over an ep = 2 mesh of the card, and its routing
bitwise the host's), one pipeline step at pp = 2 against the
sequential step, the fsdp gather Function and a process-mesh step at
world 1 against whole-leaf autograd and the single-controller step, and
the runtime (a num_gpus=1 task's CUDA return
reaching the driver as a CPU tensor, CUDA tensors at top level and
nested in the serializer, an actor's paged-kernel launches, an
LLMDeployment replica's stream equal to the in-process engine's), and a
two-trial Tuner training a small GPT (head dim 64) on the flash kernels,
both trials on the card at once, and the data plane's feeder
(``iter_cuda_batches``: pinned rings, side-stream copies, a consumer on
another stream, a ring of events a column; a Dataset and a pipeline on a
cluster). The
file imports neither JAX nor the JAX package, and the
repo's conftest does, so run it with::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

chip_smoke.py holds the same kernels to the same tolerances at OPT-1.3B
shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

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
@pytest.mark.parametrize("ps,K", [(16, 64), (64, 64), (64, 128), (16, 80),
                                  (64, 80), (16, 256), (64, 256)])
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
@pytest.mark.parametrize("ps,K", [(16, 64), (64, 64), (64, 128), (16, 80),
                                  (64, 80), (16, 256), (64, 256)])
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
@pytest.mark.parametrize("ps,K", [(16, 64), (64, 64), (16, 128), (64, 128),
                                  (16, 80), (64, 80), (16, 256), (64, 256)])
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
@pytest.mark.parametrize("ps,K", [(16, 64), (64, 64), (16, 128), (64, 128),
                                  (16, 80), (64, 80), (16, 256), (64, 256)])
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
@pytest.mark.parametrize("K", [64, 128, 80, 256])
@pytest.mark.parametrize("ps", [16, 32, 64, 128, 48, 24, 96, 20, 4])
def test_prefill_bf16_page_sizes_and_chunks(cuda, ps, K, quant):
    """bf16 q at each page size on the wgmma kernel, counted by one
    counter: 16 to 128 and 24, 48 and 96 (neither divisors nor multiples
    of 64) in TMA boxes of gcd(ps, key tile) rows, up to 16 boxes a tile;
    20 and 4 (no whole 8-row swizzle atom) with rows gathered by cp.async.
    Chunks of C = 40, 72 and 200 at ragged offsets against a width-sliced
    table, with an inert row; float and int8 pools (the int8 program also
    against the unrounded-p plain version)."""
    rng = np.random.default_rng(9)
    B, H = 5, 2
    assert pa.prefill_kernel(torch.bfloat16, K, ps) == "wgmma"
    assert pa.prefill_plan(
        torch.zeros(1, 8, H, K, dtype=torch.bfloat16, device=cuda),
        *[torch.zeros(2, ps, H, K, dtype=torch.int8 if quant
                      else torch.bfloat16, device=cuda)] * 2).gather == (
        ps % 8 != 0)
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


@pytest.mark.parametrize("K", [64, 128, 80, 256])
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


@pytest.mark.parametrize("K", [64, 128, 80])
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


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("ps,wrong", [(64, 0), (48, 0), (20, 4), (4, 4)])
def test_prefill_launcher_refuses_another_plan(cuda, monkeypatch, ps, wrong,
                                               quant):
    """The C entry point holds the page-size rule itself: a plan that
    gathers where the rule boxes (64, 48) or boxes where it gathers (20, 4)
    is refused at launch (cudaErrorInvalidValue), before any kernel runs."""
    K, H = 64, 2
    q = torch.zeros(1, 8, H, K, dtype=torch.bfloat16, device=cuda)
    pool = torch.zeros(3, ps, H, K, dtype=torch.int8 if quant
                       else torch.bfloat16, device=cuda)
    sc = ({"k_scale": torch.ones(3, dtype=torch.bfloat16, device=cuda),
           "v_scale": torch.ones(3, dtype=torch.bfloat16, device=cuda)}
          if quant else {})
    t = torch.ones(1, 1, dtype=torch.int32, device=cuda)
    offs = torch.zeros(1, dtype=torch.int32, device=cuda)
    lens = torch.full((1,), 8, dtype=torch.int32, device=cuda)
    assert pa.prefill_box_rows(K, ps) != wrong
    monkeypatch.setattr(pa, "prefill_box_rows", lambda K, ps: wrong)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        pa.paged_prefill_attention(q, pool, pool, t, offs, lens, **sc)
    assert (pa.paged_prefill_attention.launches,
            pa.paged_prefill_attention.int8_launches) == (0, 0)


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
        eng = LLMEngine(cfg, params, kv_mode="paged", n_slots=4,
                        max_len=128, page_size=16, prefill_chunk=32, prefill_token_budget=64,
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
        eng = LLMEngine(cfg, params, kv_mode="paged", n_slots=4,
                        max_len=128, page_size=16, prefill_chunk=32, prefill_token_budget=64,
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


def _scattered_tables(rng, lengths, ps, n_pg):
    """[B, n_pg] tables over a random permutation of the pool's pages:
    each slot the pages its length needs, 0 (null) after them."""
    need = [min(-(-int(n) // ps), n_pg) for n in lengths]
    perm = rng.permutation(np.arange(1, sum(need) + 1)).astype(np.int32)
    tables = np.zeros((len(lengths), n_pg), np.int32)
    at = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[at:at + n]
        at += n
    return tables, sum(need) + 1


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("C", [5, 2])
def test_prefill_at_the_verify_shape(cuda, C, quant):
    """The speculative verify pass: 16 rows of C = k+1 queries at ragged
    decode cursors (not multiples of the page or the key tile) on the
    decode table's width, with inert rows; 32 heads of 64, ps 64, bf16
    q, float and int8 pools. The q tile's 128 rows are mostly past C."""
    rng = np.random.default_rng(12)
    ps, H, K, n_pg = 64, 32, 64, 16
    cap = n_pg * ps
    cursors = [ps + 3, 700, cap - 1 - C, cap - C, 1, 64, 127, 500, 0, 0,
               333, 900, 0, 5, 1000 - C, 0]
    valid = [C, C, C, C, C, 1, C - 1, C, 0, 0, 1, C, 0, C, C, 0]
    lens = np.array([c + v for c, v in zip(cursors, valid)], np.int32)
    tables, n_pages = _scattered_tables(rng, lens, ps, n_pg)
    if quant:
        kp, ks, vp, vs = _int8_pool(rng, n_pages, ps, H, K, cuda)
        sc = {"k_scale": ks, "v_scale": vs}
    else:
        kp, vp = _pool(rng, n_pages, ps, H, K, torch.bfloat16, cuda)
        sc = {}
    q = torch.from_numpy(rng.normal(size=(16, C, H, K)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    args = [torch.from_numpy(a).to(cuda) for a in
            (tables, np.array(cursors, np.int32), lens)]
    out = pa.paged_prefill_attention(q, kp, vp, *args, **sc)
    torch.cuda.synchronize()
    assert (pa.paged_prefill_attention.int8_launches,
            pa.paged_prefill_attention.launches) == (
        (1, 0) if quant else (0, 1))
    live = args[2] > 0
    assert torch.all(out[~live] == 0)        # inert rows: the l == 0 guard
    ref = pa.reference_paged_prefill_attention(q, kp, vp, *args, **sc)
    if quant:
        s_abs = _abs_v_int8(pa.reference_paged_prefill_attention, q, kp, ks,
                            vp, vs, *args)
    else:
        s_abs = _abs_v(pa.reference_paged_prefill_attention, q, kp, vp,
                       *args)
    _close(out[live], ref[live], torch.bfloat16, s_abs[live])
    if quant:
        ref32 = pa.reference_paged_prefill_attention(q.float(), kp, vp,
                                                     *args, **sc)
        _close_p_unrounded(out[live], ref32[live], s_abs[live])


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernels_at_the_drafts_heads(cuda, dtype, quant):
    """Both paged kernels at gpt2_124m's 12 heads of 64 (a speculative
    draft beside opt_1_3b): three decode head groups of four; decode at
    16 ragged slots, then prefill rows of C = 160 and C = 5."""
    _both_kernels_at_heads(cuda, 12, dtype, quant, seed=13)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [16, 8, 6])
def test_paged_kernels_at_tp_shard_heads(cuda, H, dtype, quant):
    """Both paged kernels at a tensor-parallel shard's heads: opt_1_3b's
    32 at tp=2 (16) and tp=4 (8), the draft's 12 at tp=2 (6: the decode
    kernel's last head group of four is partial)."""
    _both_kernels_at_heads(cuda, H, dtype, quant, seed=14 + H)


def _both_kernels_at_heads(cuda, H, dtype, quant, *, seed):
    """Decode at 16 ragged slots, then prefill rows of C = 160 and C = 5,
    at H heads of 64, each held to its plain version."""
    rng = np.random.default_rng(seed)
    ps, K, n_pg = 64, 64, 16
    lengths = np.array([1, 33, 64, 65, 700, 1023, 1024, 900, 1, 500, 128,
                        129, 17, 1000, 2, 640], np.int32)
    tables, n_pages = _scattered_tables(rng, lengths, ps, n_pg)
    if quant:
        kp, ks, vp, vs = _int8_pool(rng, n_pages, ps, H, K, cuda)
        sc = {"k_scale": ks, "v_scale": vs}
        abs_v = lambda ref, q, *a: _abs_v_int8(ref, q, kp, ks, vp, vs, *a)
    else:
        kp, vp = _pool(rng, n_pages, ps, H, K, dtype, cuda)
        sc = {}
        abs_v = lambda ref, q, *a: _abs_v(ref, q, kp, vp, *a)
    t = torch.from_numpy(tables).to(cuda)
    n = torch.from_numpy(lengths).to(cuda)
    q = torch.from_numpy(rng.normal(size=(16, H, K)).astype(
        np.float32)).to(cuda, dtype)
    out = pa.paged_attention(q, kp, vp, t, n, **sc)
    torch.cuda.synchronize()
    ref = pa.reference_paged_attention(q, kp, vp, t, n, **sc)
    _close(out, ref, dtype, abs_v(pa.reference_paged_attention, q, t, n),
           rtol=1e-5 if quant else 0)
    for C in (160, 5):
        offs = np.maximum(lengths - C, 0).astype(np.int32)
        qp = torch.from_numpy(rng.normal(size=(16, C, H, K)).astype(
            np.float32)).to(cuda, dtype)
        args = (t, torch.from_numpy(offs).to(cuda), n)
        out = pa.paged_prefill_attention(qp, kp, vp, *args, **sc)
        torch.cuda.synchronize()
        ref = pa.reference_paged_prefill_attention(qp, kp, vp, *args, **sc)
        _close(out, ref, dtype, abs_v(pa.reference_paged_prefill_attention,
                                      qp, *args), rtol=1e-5 if quant else 0)
    launched = (pa.paged_attention.int8_launches if quant
                else pa.paged_attention.launches,
                pa.paged_prefill_attention.int8_launches if quant
                else pa.paged_prefill_attention.launches)
    assert launched == (1, 2)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_tp2_kernel_engine_matches_tp1_gather_on_the_card(cuda, quant):
    """A tp=2 kernel engine with both shards on this card (4 heads of 64:
    2 per shard) serves the streams of the tp=1 gather engine, fp32, with
    n_layers x 2 launches of each kernel per decode step and per chunk
    dispatch; int8 weights and KV with the scale planes equal across
    shards."""
    cfg = gpt.GPTConfig.tiny_untied(dtype=torch.float32, d_model=256,
                                    n_heads=4)          # head_dim 64
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = gpt.init_params(cfg, gen, cuda)
    rng = np.random.default_rng(21)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n)))
               for n in (3, 40, 90, 17, 64)]
    q = dict(weight_dtype="int8", kv_dtype="int8") if quant else {}
    kw = dict(kv_mode="paged", n_slots=4, max_len=128, page_size=16,
              prefill_chunk=32, prefill_token_budget=64, **q)
    outs = {}
    for name, extra in (("gather", dict(attn_impl="gather", device=cuda)),
                        ("tp2", dict(attn_impl="kernel", tp=2,
                                     device=[cuda, cuda]))):
        pa.reset_launch_counts()
        eng = LLMEngine(cfg, params, **kw, **extra)
        outs[name] = _serve(eng, prompts)
        acc = eng.page_accounting()
        assert acc["closure"] and acc["free"] == acc["total"]
    m = eng.metrics()
    assert m["llm_tp"] == 2 and m["kv_heads_per_shard"] == 2
    decode, prefill = ((pa.paged_attention.int8_launches,
                        pa.paged_prefill_attention.int8_launches) if quant
                       else (pa.paged_attention.launches,
                             pa.paged_prefill_attention.launches))
    assert decode == 2 * cfg.n_layers * m["decode_steps"] > 0
    assert prefill == 2 * cfg.n_layers * m["prefill_dispatches"] > 0
    if quant:
        for name in ("k_scale", "v_scale"):
            assert torch.equal(eng.cache[0][name], eng.cache[1][name])
    assert outs["tp2"] == outs["gather"]


def test_engine_prefix_cache_and_spec_on_the_card(cuda):
    """The kernel engine with the prefix cache and a draft (two heads of
    64) serves two waves of shared-prefix prompts (copy-on-write at chunk
    20 / page 16) with the streams of the plain gather engine without
    either, fp32; the draft's decode steps and both verify and prefill
    passes launch kernels; the accounting closes with cached pages."""
    cfg = gpt.GPTConfig.tiny_untied(dtype=torch.float32, d_model=256,
                                    n_heads=4)          # head_dim 64
    dcfg = gpt.GPTConfig.tiny_untied(dtype=torch.float32, d_model=128,
                                     n_heads=2, n_layers=1)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = gpt.init_params(cfg, gen, cuda)
    rng = np.random.default_rng(4)
    shared = list(map(int, rng.integers(1, cfg.vocab_size, 56)))
    prompts = [shared + list(map(int, rng.integers(1, cfg.vocab_size, n)))
               for n in (3, 9, 20, 5, 14, 7)]
    kw = dict(kv_mode="paged", n_slots=4, max_len=128, page_size=16,
              prefill_chunk=20,
              prefill_token_budget=40, device=cuda)
    outs = {}
    for name, extra in (("gather", dict(attn_impl="gather")),
                        ("kernel", dict(attn_impl="kernel",
                                        prefix_cache=True, spec_draft=dcfg,
                                        spec_k=3))):
        pa.reset_launch_counts()
        eng = LLMEngine(cfg, params, **kw, **extra)
        outs[name] = []
        for lo in (0, 3):
            reqs = [eng.submit(p, max_tokens=10) for p in prompts[lo:lo + 3]]
            for _ in range(400):
                if all(r.done.is_set() for r in reqs):
                    break
                eng.step()
            assert all(r.done.is_set() and r.error is None for r in reqs)
            outs[name] += [r.out_ids for r in reqs]
        acc = eng.page_accounting()
        assert acc["closure"] and acc["refs_consistent"]
        assert acc["free"] + acc["cached_only"] == acc["total"]
    m = eng.metrics()
    assert m["prefix_hits"] > 0 and m["cow_copies"] > 0 and m["spec_ticks"]
    assert pa.paged_attention.launches > 0
    assert pa.paged_prefill_attention.launches > 0
    assert outs["kernel"] == outs["gather"]


def _serve(eng, prompts, max_tokens=8):
    reqs = [eng.submit(p, max_tokens=max_tokens) for p in prompts]
    for _ in range(400):
        if all(r.done.is_set() for r in reqs):
            break
        eng.step()
    assert all(r.done.is_set() and r.error is None for r in reqs)
    if eng.kv_mode == "paged":
        acc = eng.page_accounting()
        assert acc["closure"] and acc["free"] == acc["total"]
    return [r.out_ids for r in reqs]


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_oneshot_and_dense_engines_on_the_card(cuda, quant):
    """One-shot paged on the decode kernel against the one-shot gather
    engine (fp32 activations: equal streams), float and int8 weights and
    KV, with exactly n_layers decode launches per decode step and no
    prefill launch; the dense engine (no kernel) gives the same streams
    (float)."""
    cfg = gpt.GPTConfig.tiny_untied(dtype=torch.float32, d_model=256,
                                    n_heads=4)          # head_dim 64
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = gpt.init_params(cfg, gen, cuda)
    rng = np.random.default_rng(9)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n)))
               for n in (3, 40, 90, 17, 64)]
    kw = dict(n_slots=4, max_len=128, prefill_buckets=(32, 64, 96),
              device=cuda)
    if quant:
        kw.update(weight_dtype="int8", kv_dtype="int8")
    outs = {}
    for impl in ("gather", "kernel"):
        pa.reset_launch_counts()
        eng = LLMEngine(cfg, params, kv_mode="paged", page_size=16,
                        attn_impl=impl, **kw)
        outs[impl] = _serve(eng, prompts)
    steps = eng.metrics()["decode_steps"]
    want = (0, 0, cfg.n_layers * steps, 0) if quant else (
        cfg.n_layers * steps, 0, 0, 0)
    assert steps and (pa.paged_attention.launches,
                      pa.paged_prefill_attention.launches,
                      pa.paged_attention.int8_launches,
                      pa.paged_prefill_attention.int8_launches) == want
    assert outs["kernel"] == outs["gather"]
    if not quant:
        pa.reset_launch_counts()
        dense = LLMEngine(cfg, params, **kw)
        assert _serve(dense, prompts) == outs["gather"]
        assert pa.paged_attention.launches == 0


@pytest.mark.parametrize("mode", ["dense", "chunked"])
def test_drain_and_resume_on_the_card(cuda, mode):
    """drain(0.0) mid-decode on the card, every continuation resumed on a
    fresh engine: the streams equal the uninterrupted run's (fp32) and
    no resumed token is emitted twice."""
    cfg = gpt.GPTConfig.tiny_untied(dtype=torch.float32, d_model=256,
                                    n_heads=4)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = gpt.init_params(cfg, gen, cuda)
    rng = np.random.default_rng(10)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n)))
               for n in (5, 30, 60, 12, 45)]
    kw = dict(n_slots=4, max_len=128, decode_block=4,
              prefill_buckets=(32, 64, 96), device=cuda)
    if mode == "chunked":
        kw.update(kv_mode="paged", page_size=16, prefill_chunk=32,
                  prefill_token_budget=64, attn_impl="kernel")
    full = _serve(LLMEngine(cfg, params, **kw), prompts, 16)
    src = LLMEngine(cfg, params, **kw)
    reqs = [src.submit(p, max_tokens=16) for p in prompts]
    for _ in range(3):
        src.step()
    out = src.drain(0.0)
    assert out["exported"] and all(r.done.is_set() for r in reqs)
    dst = LLMEngine(cfg, params, **kw)
    resumed = {}
    for c in out["continuations"]:
        i = next(j for j, r in enumerate(reqs)
                 if r.request_id == c["request_id"])
        resumed[i] = dst.submit(c["prompt_ids"], max_tokens=16,
                                generated_ids=c["generated_ids"],
                                stream=True)
    for _ in range(400):
        if all(r.done.is_set() for r in resumed.values()):
            break
        dst.step()
    for i, r in resumed.items():
        assert r.done.is_set() and r.error is None
        streamed = []
        while (t := r.stream.get(timeout=5)) is not None:
            streamed.append(t)
        n = len(reqs[i].out_ids)
        assert r.out_ids == full[i] and streamed == full[i][n:]
    for i, r in enumerate(reqs):
        if i not in resumed:
            assert r.out_ids == full[i]


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
@pytest.mark.parametrize("K", [64, 128, 80, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,T", [(77, 130), (192, 192)])
def test_flash_kernels_match_plain(cuda, dtype, K, causal, S, T):
    """flash_fwd, flash_dq and flash_dkv each against its plain version
    on the same inputs (the backward from the plain forward's o and lse,
    with an lse cotangent); the forward's unrounded o (o32, the training
    path's) against the plain version's, and o bitwise o32 rounded."""
    rng = np.random.default_rng(3)
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(cuda)
    B, H = 2, 3
    q, k, v, do = (t(B, n, H, K).to(dtype) for n in (S, T, T, S))
    dlse = t(B, S, H)
    scale = K ** -0.5
    o, lse, o32 = fa.flash_fwd(q, k, v, causal, scale, with_o32=True)
    o_ref, lse_ref, o32_ref = fa.reference_flash_fwd(q, k, v, causal, scale,
                                                     with_o32=True)
    delta = fa.flash_delta(o_ref, do, dlse)
    dq = fa.flash_dq(q, k, v, do, lse_ref, delta, causal, scale)
    dk, dv = fa.flash_dkv(q, k, v, do, lse_ref, delta, causal, scale)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == (1, 1, 1)
    assert o32.dtype == torch.float32 and torch.equal(o, o32.to(dtype))
    refs = (o_ref, fa.reference_flash_dq(q, k, v, do, lse_ref, delta, causal,
                                         scale),
            *fa.reference_flash_dkv(q, k, v, do, lse_ref, delta, causal,
                                    scale))
    sums = _flash_abs_sums(q, k, v, do, lse_ref, delta, causal, scale)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-4)
    for out, ref, s_abs in zip((o, dq, dk, dv), refs, sums):
        assert out.dtype == dtype and out.shape == ref.shape
        _close(out, ref, dtype, s_abs)
    _close(o32, o32_ref, dtype, sums[0])


def test_flash_attention_autograd_and_refusals(cuda):
    """The autograd op runs the three kernels once each and gives the
    plain attention's gradients; head dims other than 64, 80, 128 and
    256 and mixed dtypes are refused, never computed by the plain path."""
    rng = np.random.default_rng(4)
    ts = [torch.from_numpy(rng.normal(size=(2, 96, 4, 64)).astype(
        np.float32)).to(cuda).requires_grad_(True) for _ in range(3)]
    o, lse = fa.flash_attention(*ts, causal=True, return_lse=True)
    (o.square().sum() + lse.sum()).backward()
    assert (fa.flash_fwd.launches, fa.flash_delta.launches,
            fa.flash_dq.launches, fa.flash_dkv.launches) == (1, 1, 1, 1)
    grads = [x.grad.clone() for x in ts]
    for x in ts:
        x.grad = None
    o, lse = fa.reference_attention(*ts, causal=True, return_lse=True)
    (o.square().sum() + lse.sum()).backward()
    for a, x in zip(grads, ts):
        torch.testing.assert_close(a, x.grad, rtol=1e-4, atol=1e-4)
    q96 = torch.zeros(1, 8, 2, 96, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q96, q96, q96)
    q64 = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_fwd(q64, q64.bfloat16(), q64)
    assert fa.flash_fwd.launches == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_at_head_dim_256(cuda, dtype, causal):
    """Head dim 256 (gptj_6b): dq and dkv against their plain versions
    with S and T off every tile (the dq kernel's 64-key tiles in single K
    or V slots, the dkv kernel's 64-key items whose warpgroups score half
    the walked rows each and own half the head dim, the fp32 kernels'
    32-row walked tiles), from q, k, v read as views of packed qkv
    tensors; a head dim no kernel takes (96) is refused with a ValueError
    naming the ROADMAP item, launching nothing."""
    rng = np.random.default_rng(14)
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(cuda, dtype)
    B, S, T, H, K = 2, 200, 333, 2, 256
    qkv_q, qkv_kv = t(B, S, 3, H, K), t(B, T, 3, H, K)
    q, k, v = qkv_q[:, :, 0], qkv_kv[:, :, 1], qkv_kv[:, :, 2]
    do, dlse = t(B, S, H, K), t(B, S, H).float()
    scale = K ** -0.5
    o_ref, lse_ref = fa.reference_flash_fwd(q, k, v, causal, scale)
    delta = fa.flash_delta(o_ref, do, dlse)
    dq = fa.flash_dq(q, k, v, do, lse_ref, delta, causal, scale)
    dk, dv = fa.flash_dkv(q, k, v, do, lse_ref, delta, causal, scale)
    torch.cuda.synchronize()
    assert (fa.flash_dq.launches, fa.flash_dkv.launches) == (1, 1)
    refs = (fa.reference_flash_dq(q, k, v, do, lse_ref, delta, causal,
                                  scale),
            *fa.reference_flash_dkv(q, k, v, do, lse_ref, delta, causal,
                                    scale))
    sums = _flash_abs_sums(q, k, v, do, lse_ref, delta, causal, scale)[1:]
    for out, ref, s_abs in zip((dq, dk, dv), refs, sums):
        assert out.dtype == dtype and out.shape == ref.shape
        _close(out, ref, dtype, s_abs)
    q96 = torch.zeros(1, 8, 2, 96, device=cuda, dtype=dtype)
    lse96 = torch.zeros(1, 8, 2, device=cuda)
    for fn in (fa.flash_dq, fa.flash_dkv):
        with pytest.raises(ValueError, match="head dim 96.*ROADMAP"):
            fn(q96, q96, q96, q96, lse96, lse96, causal, scale)
    assert (fa.flash_dq.launches, fa.flash_dkv.launches) == (1, 1)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_256_in_head_groups(cuda, causal):
    """Head dim 256 with 128 heads of S = T = 960: the walked rows of all
    heads (about 1 MB each) outgrow the L2, so dq and dkv take their items
    in pairs of complementary ranks by head group, dkv's 15 key tiles
    leaving a middle rank unpaired; both still match their plain versions
    under the bf16 bound."""
    rng = np.random.default_rng(16)
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(cuda, torch.bfloat16)
    B, S, H, K = 8, 960, 16, 256
    q, k, v, do = (t(B, S, H, K) for _ in range(4))
    scale = K ** -0.5
    o_ref, lse_ref = fa.reference_flash_fwd(q, k, v, causal, scale)
    delta = fa.reference_flash_delta(o_ref, do)
    args = (q, k, v, do, lse_ref, delta, causal, scale)
    dq = fa.flash_dq(*args)
    dk, dv = fa.flash_dkv(*args)
    torch.cuda.synchronize()
    refs = (fa.reference_flash_dq(*args), *fa.reference_flash_dkv(*args))
    sums = _flash_abs_sums(q, k, v, do, lse_ref, delta, causal, scale)[1:]
    for out, ref, s_abs in zip((dq, dk, dv), refs, sums):
        _close(out, ref, torch.bfloat16, s_abs)


@pytest.mark.parametrize("K", [64, 80, 128, 256])
@pytest.mark.parametrize("dtypes", [(torch.bfloat16, torch.bfloat16),
                                    (torch.bfloat16, torch.float32),
                                    (torch.float32, torch.float32)])
def test_flash_delta_matches_plain(cuda, K, dtypes):
    """The delta kernel against its plain version, (dO, O) in each dtype
    pair it takes, dO contiguous and as strided rows, with and without
    an lse cotangent (also one expanded from a single value): within
    1e-5 of each row's sum of magnitudes (fp32 sums in other orders), one
    launch a call; dtype pairs and head dims it does not take are
    refused, launching nothing."""
    rng = np.random.default_rng(15)
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(cuda)
    B, S, H = 2, 77, 3
    do = t(B, S, H, K).to(dtypes[0])
    o = t(B, S, H, K).to(dtypes[1])
    packed = t(B, S, 2, H, K).to(dtypes[0])
    packed[:, :, 1] = do
    dlse = t(B, S, H)
    n = 0
    for d in (do, packed[:, :, 1]):
        for dl in (dlse, None, t(1, 1, 1).expand(B, S, H)):
            out = fa.flash_delta(o, d, dl)
            n += 1
            torch.cuda.synchronize()
            ref = fa.reference_flash_delta(o, d, dl)
            assert out.dtype == torch.float32 and out.is_contiguous()
            bound = (d.float() * o.float()).abs().sum(-1)
            if dl is not None:
                bound = bound + dl.abs()
            assert bool(((out - ref).abs() <= 1e-5 * bound).all())
    assert fa.flash_delta.launches == n
    with pytest.raises(ValueError, match="dtypes"):
        fa.flash_delta(o.to(torch.bfloat16), do.float())
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_delta(o[..., :12], do[..., :12])
    assert fa.flash_delta.launches == n


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


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_full_flash_on_the_card(cuda, causal):
    """Ring attention over sp = 4 with every shard on the card, against
    full flash attention on the same bf16 inputs: outputs and the
    gradients of sum(o·cos o) (the ring feeds the dq and dkv kernels an
    lse cotangent) each within 2e-2 of the whole tensor, relative; the
    causal ring launches 4 diagonal and 6 full chunk forwards and skips
    the 6 masked steps."""
    from ray_tpu_torch.parallel.ring import make_sp_mesh, ring_attention_sharded

    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 512, 4, 64)).astype(
        np.float32)).to(cuda, torch.bfloat16).requires_grad_(True)
        for _ in range(3))
    mesh = make_sp_mesh(4, devices=[cuda] * 4)
    o = ring_attention_sharded(q, k, v, mesh, causal=causal, impl="flash")
    assert fa.flash_fwd.launches == (10 if causal else 16)
    ref = fa.flash_attention(q, k, v, causal=causal)

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    assert rel(o, ref) <= 2e-2
    g = torch.autograd.grad((o.float() * torch.cos(o.float())).sum(),
                            (q, k, v))
    g_ref = torch.autograd.grad((ref.float() * torch.cos(ref.float())).sum(),
                                (q, k, v))
    for a, b in zip(g, g_ref):
        assert rel(a, b) <= 2e-2


def test_stochastic_round_mean_on_the_card(cuda):
    """The SR rounding with a generator on the card: representable
    values never move; the mean over 400 generators within 5e-3 of x."""
    from ray_tpu_torch.train.low_precision import stochastic_round_bf16

    y = torch.tensor([1.0, 0.5, -2.0, 0.0], device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    assert torch.equal(stochastic_round_bf16(y, gen).float(), y)
    x = torch.tensor([1.0 + 1 / 512, 3e-4, -2.5e-5], device=cuda)
    acc = torch.zeros(3, dtype=torch.float64, device=cuda)
    for i in range(400):
        gen = torch.Generator(device=cuda).manual_seed(i)
        acc += stochastic_round_bf16(x, gen).double()
    rel = ((acc / 400 - x.double()).abs() / x.double().abs()).max()
    assert float(rel) < 5e-3


def test_moe_layer_on_the_card_matches_plain_loop(cuda):
    """moe_mlp on the card (fp32, capacity unconstrained) against a plain
    top-2 loop within 1e-4 of the whole output, relative; the same on an
    ep = 2 mesh of the card; _top2_dispatch on the card bitwise equal to
    the host's on the same gates, with tokens dropped (factor 0.5)."""
    from ray_tpu_torch.ops import moe

    cfg = moe.MoEConfig(256, 512, 8, capacity_factor=4.0,
                        dtype=torch.float32)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = moe.init_moe_params(cfg, gen, cuda)
    params = {k: v + 0.01 if k.startswith("b_") else v
              for k, v in params.items()}
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 96, 256)).astype(
        np.float32)).to(cuda)
    xf = x.reshape(-1, 256)
    gates = torch.softmax(xf @ params["wg"], dim=-1)
    top_w, top_e = torch.topk(gates, 2, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    ref = torch.zeros_like(xf)
    for g in range(xf.shape[0]):
        for w, e in zip(top_w[g], top_e[g].tolist()):
            up = F.gelu(xf[g] @ params["w_up"][e] + params["b_up"][e],
                        approximate="tanh")
            ref[g] += w * (up @ params["w_down"][e] + params["b_down"][e])
    ref = ref.reshape(x.shape)
    for mesh in (None, [cuda] * 2):
        y, aux = moe.moe_mlp(x, params, cfg, mesh=mesh)
        assert float((y - ref).norm() / ref.norm()) <= 1e-4
        assert torch.isfinite(aux)
    C = dataclasses.replace(cfg, capacity_factor=0.5).capacity(192)
    card = moe._top2_dispatch(gates, C)
    host = moe._top2_dispatch(gates.cpu(), C)
    assert float(card[0].sum()) < 2 * 192
    for a, b in zip(card, host):
        assert torch.equal(a.cpu(), b)


def test_pipeline_step_on_the_card_matches_sequential(cuda):
    """One gpt2_124m-wide step (4 layers, S = 256, B = 4) through the
    pipeline at pp = 2 on the card against the sequential step on the
    same parameters: the loss within 5e-4 and the gradients within 2e-2
    of the whole, relative; the flash launches of 4 microbatches x 4
    layers with remat."""
    from ray_tpu_torch.models.partition import place_on_axis
    from ray_tpu_torch.parallel.mesh import PIPELINE_LOGICAL_RULES

    cfg = dataclasses.replace(gpt.GPTConfig.gpt2_124m(
        max_seq=256, remat=True, attn_impl="flash"), n_layers=4)
    gen = torch.Generator(device=cuda).manual_seed(0)
    whole = gpt.init_params(cfg, gen, cuda)
    mesh = [cuda] * 2
    placed = place_on_axis(whole, gpt.logical_axes(cfg), mesh, "pp",
                           PIPELINE_LOGICAL_RULES)
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 256))).to(
        cuda)
    tg = torch.roll(toks, -1, dims=1)

    def grads(params, fn):
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in params.items()}
        loss = fn(leaves)
        names = list(leaves)
        g = dict(zip(names, torch.autograd.grad(
            loss, [leaves[k] for k in names])))
        for k in {n.partition("@")[0] for n in names if "@" in n}:
            g[k] = torch.cat([g.pop(f"{k}@{r}") for r in range(2)])
        return float(loss.detach()), torch.cat([g[k].flatten().float()
                                       for k in sorted(g)])

    loss_s, g_s = grads(whole, lambda p: gpt.loss_fn(p, toks, tg, cfg))
    fa.reset_launch_counts()
    loss_p, g_p = grads(placed, lambda p: gpt.pipeline_loss_fn(
        p, toks, tg, cfg, mesh, 4))
    assert (fa.flash_fwd.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == (32, 16, 16)
    assert abs(loss_p - loss_s) <= 5e-4
    assert float((g_p - g_s).norm() / g_s.norm()) <= 2e-2


def test_fsdp_gather_and_process_mesh_step_at_world_one_on_the_card(cuda):
    """The fsdp gather Function on the card at world 1: its forward is
    the leaf and its backward the whole-leaf autograd gradient, bitwise;
    and three tiny flash steps through build_training(process_mesh=) at
    world 1 are bitwise the single-controller steps, with no collective."""
    from ray_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from ray_tpu_torch.train import spmd
    from ray_tpu_torch.train.optim import adamw

    mesh = make_mesh(MeshConfig(dp=1, fsdp=1), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    w = torch.randn(2, 64, 128, device=cuda, generator=gen,
                    requires_grad=True)
    x = torch.randn(4, 64, device=cuda, generator=gen)
    got = spmd._GatherLeaf.apply(w, mesh, "fsdp", 1)
    (g_got,) = torch.autograd.grad((x @ got[1]).square().sum(), [w])
    (g_ref,) = torch.autograd.grad((x @ w[1]).square().sum(), [w])
    assert torch.equal(got, w) and torch.equal(g_got, g_ref)

    # Two heads of 64: the flash kernels take head dims 64 and 128.
    cfg = gpt.GPTConfig.tiny(d_model=128, n_heads=2, dtype=torch.float32,
                             attn_impl="flash")
    opt = adamw(1e-2, weight_decay=0.1)
    runs = []
    for pm in (None, mesh):
        params, state, step = spmd.build_training(
            cfg, opt, torch.Generator(device=cuda).manual_seed(0), cuda,
            process_mesh=pm)
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (4, 64))).to(cuda)
        losses = []
        for _ in range(3):
            params, state, loss = step(params, state,
                                       (toks, torch.roll(toks, -1, 1)))
            losses.append(float(loss))
        runs.append((losses, params))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1])
    assert mesh.stats.calls == 0 and fa.flash_fwd.launches > 0


# ------------------------------------------------ the runtime on the card

@pytest.fixture
def cluster(cuda):
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=2, resources={"GPU": 1})
    try:
        yield ray_tpu_torch
    finally:
        ray_tpu_torch.shutdown()


def _cuda_ramp():
    return torch.arange(12, dtype=torch.bfloat16, device="cuda") * 3


def test_task_returns_a_cuda_tensor_as_a_cpu_tensor(cluster):
    out = cluster.get(cluster.remote(num_gpus=1)(_cuda_ramp).remote(),
                      timeout=120)
    want = torch.arange(12, dtype=torch.bfloat16) * 3
    assert out.device.type == "cpu" and torch.equal(out, want)


def test_cuda_tensors_at_top_level_and_nested(cuda):
    """As the JAX runtime's jax.Array (tests/test_torch_runtime_parity.py
    pins that side): at top level a CUDA tensor comes back a CPU tensor
    through the out-of-band path; nested, torch's own pickling keeps it
    on its device, in-band."""
    from ray_tpu_torch.core import serialization as ser

    t = torch.arange(6, dtype=torch.float32, device=cuda)
    head, views = ser.serialize(t)
    out = ser.unpack(ser.pack(t))
    assert len(views) == 1 and out.device.type == "cpu"
    assert torch.equal(out, t.cpu())
    head, views = ser.serialize({"t": t})
    out = ser.unpack(ser.pack({"t": t}))
    assert not views and out["t"].device.type == "cuda"
    assert torch.equal(out["t"], t)


class _KernelEngine:
    """A tiny paged kernel engine (head dim 64) in an actor's worker."""

    def __init__(self):
        cfg = gpt.GPTConfig.tiny_untied(dtype=torch.float32, d_model=256,
                                        n_heads=4)
        self.eng = LLMEngine(cfg, kv_mode="paged", n_slots=4, max_len=128,
                             page_size=16, prefill_chunk=32,
                             prefill_token_budget=64, attn_impl="kernel",
                             device="cuda")

    def serve(self, prompts):
        pa.reset_launch_counts()
        reqs = [self.eng.submit(p, max_tokens=8) for p in prompts]
        for _ in range(400):
            if all(r.done.is_set() for r in reqs):
                break
            self.eng.step()
        assert all(r.error is None for r in reqs)
        return (pa.paged_attention.launches,
                pa.paged_prefill_attention.launches)


def test_an_actor_launches_the_paged_kernels(cluster):
    actor = cluster.remote(num_gpus=1)(_KernelEngine).remote()
    rng = np.random.default_rng(4)
    prompts = [list(map(int, rng.integers(1, 200, n))) for n in (3, 40, 90)]
    decode, prefill = cluster.get(actor.serve.remote(prompts), timeout=300)
    assert decode > 0 and prefill > 0
    cluster.kill(actor)


def test_llm_deployment_replica_on_the_card(cluster):
    """One LLMDeployment replica on cuda (device None: the default) at
    num_gpus=1, the tiny untied model at head dim 64 on the paged
    kernels: its handle stream equals the in-process engine's stream
    from the same seed, and the replica's launch counters moved."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import LLMDeployment

    cfg = gpt.GPTConfig.tiny_untied(dtype=torch.float32, d_model=256,
                                    n_heads=4)
    knobs = dict(kv_mode="paged", page_size=16, prefill_chunk=32,
                 prefill_token_budget=64, attn_impl="kernel")
    rng = np.random.default_rng(5)
    prompts = [list(map(int, rng.integers(1, 200, n))) for n in (3, 40, 90)]
    eng = LLMEngine(cfg, n_slots=4, max_len=128, device="cuda", **knobs)
    want = []
    for p in prompts:
        req = eng.submit(p, max_tokens=8)
        while not req.done.is_set():
            eng.step()
        want.append(list(req.out_ids))
    del eng
    try:
        handle = serve.run(serve.deployment(LLMDeployment, name="cardllm")
                           .options(num_replicas=1,
                                    ray_actor_options={"num_gpus": 1})
                           .bind(cfg, n_slots=4, max_len=128,
                                 engine_kwargs=knobs), timeout=300.0)
        got = [list(handle.stream({"prompt_ids": p, "max_tokens": 8}))
               for p in prompts]
        assert got == want
        m = cluster.get(handle.method("metrics"), timeout=60)
        assert m["decode_steps"] > 0 and m["prefill_dispatches"] > 0
    finally:
        serve.shutdown()


def _tune_trial(config):
    """A card Tune trial: a small GPT (bf16, head dim 64, remat, flash)
    at ``config["lr"]`` for 3 steps on the trial's device, each step's
    flash launches (counters zeroed just before it) and the calls of
    the plain versions so far reported with its loss."""
    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.optim import adamw
    from ray_tpu_torch.train.spmd import build_training

    plain = {"calls": 0}
    for name in ("reference_flash_fwd", "reference_flash_dq",
                 "reference_flash_dkv"):
        def counted(*a, _real=getattr(fa, name), **k):
            plain["calls"] += 1
            return _real(*a, **k)
        setattr(fa, name, counted)
    dev = session.get_device()
    cfg = gpt.GPTConfig.tiny(d_model=128, n_heads=2, d_ff=256, max_seq=128,
                             remat=True, attn_impl="flash")
    params, state, step = build_training(
        cfg, adamw(config["lr"], weight_decay=0.1, mu_dtype=torch.bfloat16),
        torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 128))).to(dev)
    batch = (toks, torch.roll(toks, -1, dims=1))
    for _ in range(3):
        fa.reset_launch_counts()
        params, state, loss = step(params, state, batch)
        session.report({"loss": float(loss), "device": str(dev),
                        "launches": [fa.flash_fwd.launches,
                                     fa.flash_dq.launches,
                                     fa.flash_dkv.launches],
                        "plain_calls": plain["calls"]})


def test_tuner_trials_train_on_the_flash_kernels(cluster):
    """Two trials at num_gpus 0.5 (both on the card at once): each on
    ``cuda:0`` (``session.get_device()``), 4 forward (remat), 2 dq and 2
    dkv launches a step for the 2 layers, no plain version run, the
    loss finite and falling."""
    from ray_tpu_torch import tune

    grid = tune.Tuner(
        _tune_trial, param_space={"lr": tune.grid_search([1e-3, 3e-3])},
        tune_config=tune.TuneConfig(metric="loss", mode="min"),
        resources_per_trial={"CPU": 1, "GPU": 0.5}).fit(timeout=600)
    assert grid.errors == []
    assert len(grid) == 2
    for t in grid.trials:
        losses = [r["loss"] for r in t.reports]
        assert len(losses) == 3 and np.isfinite(losses).all()
        assert losses[-1] < losses[0]
        assert {r["device"] for r in t.reports} == {"cuda:0"}
        assert [r["launches"] for r in t.reports] == [[4, 2, 2]] * 3
        assert t.reports[-1]["plain_calls"] == 0


# ----------------------------------------------- the data plane's feeder

@pytest.mark.parametrize("dtype", [None, torch.int64, torch.bfloat16])
def test_cuda_batch_iterator_stages_through_pinned_buffers(cuda, dtype):
    """iter_cuda_batches' feeder on the card: every column copied from a
    pinned buffer of its ring (prefetch + 1 slots, reused once the copy
    that read them finished) on a side stream, the values the batch's,
    read on another stream than the copies'."""
    from ray_tpu_torch.data.dataset import CudaBatchIterator

    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, 50257, (8, 1024)).astype(np.int32),
                "x": rng.normal(size=(8, 3)).astype(np.float32)}
               for _ in range(7)]
    it = CudaBatchIterator(iter(batches), dtype=dtype, prefetch=2)
    consumer = torch.cuda.Stream()
    seen = []
    with torch.cuda.stream(consumer):
        for b in it:
            assert b["tokens"].device.type == "cuda"
            seen.append({k: (v.float() * 1).cpu() for k, v in b.items()})
    assert len(seen) == 7
    for got, want in zip(seen, batches):
        for k, arr in want.items():
            ref = torch.from_numpy(arr)
            ref = ref if dtype is None else ref.to(dtype)
            assert torch.equal(got[k], ref.float()), k
    stats = it.stats()
    assert stats["batches"] == 7 and stats["copies"] == 14
    assert stats["pinned_copies"] == 14
    assert stats["bytes_copied"] == sum(
        a.size * (a.itemsize if dtype is None else
                  torch.empty((), dtype=dtype).element_size())
        for b in batches for a in b.values())
    assert stats["copy_device_ms"] > 0 and stats["h2d_gb_s"] > 0
    assert all(len(ring) == 3 for ring in it._rings.values())
    assert all(s.host.is_pinned() for ring in it._rings.values()
               for s in ring)


def test_cuda_batch_iterator_holds_a_ring_of_events_per_column(cuda):
    """A long feed holds at most prefetch + 1 event pairs a column: each
    slot's copy time is folded into a running sum when the slot is reused
    or stats() reads it, and its events are dropped. copy_device_ms is the
    sum of every copy's time (a second stats() reads the same), and a
    ragged last batch takes a view of its slot's pinned buffer instead of
    a ring of its own."""
    from ray_tpu_torch.data.dataset import CudaBatchIterator

    rng = np.random.default_rng(1)
    prefetch, n = 2, 40
    batches = [{"tokens": rng.integers(0, 50257, (8 if i < n - 1 else 3,
                                                 256)).astype(np.int32),
                "x": rng.normal(size=(8 if i < n - 1 else 3, 4)).astype(
                    np.float32)} for i in range(n)]
    it = CudaBatchIterator(iter(batches), prefetch=prefetch)
    held = []
    for b, want in zip(it, batches):
        assert torch.equal(b["tokens"].cpu(), torch.from_numpy(
            want["tokens"]))
        held.append(sum(s.done is not None for ring in it._rings.values()
                        for s in ring))
    assert max(held) <= 2 * (prefetch + 1)
    assert len(it._rings) == 2
    assert all(len(ring) == prefetch + 1 for ring in it._rings.values())
    first = it.stats()
    assert first["copies"] == 2 * n and first["copy_device_ms"] > 0
    assert all(s.done is None and s.start is None
               for ring in it._rings.values() for s in ring)
    assert it.stats()["copy_device_ms"] == first["copy_device_ms"]


def test_dataset_iter_cuda_batches_on_the_card(cluster):
    from ray_tpu_torch import data as rd

    ds = rd.range(64).map_batches(lambda b: {"id": b["id"],
                                             "sq": b["id"] ** 2})
    got = list(ds.iter_cuda_batches(batch_size=16))
    assert [b["id"].device.type for b in got] == ["cuda"] * 4
    assert torch.cat([b["sq"] for b in got]).cpu().tolist() == [
        i * i for i in range(64)]
    pipe = ds.window(blocks_per_window=2)
    assert sum(int(b["id"].sum()) for b in pipe.iter_cuda_batches(
        batch_size=8, dtype=torch.float32)) == sum(range(64))
