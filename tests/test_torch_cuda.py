"""The port's CUDA kernels on the card (marked ``cuda``; skipped without one).

Each kernel against its plain PyTorch version on CUDA tensors (ragged
lengths, idle all-null slots, width-sliced prefill tables, a partial
query tile, fp32 and bf16, the tensor-core head dims 64 and 128), the
launch counters, the wrappers' refusals (no fallback to the plain path),
and the tiny engine with ``attn_impl="kernel"`` against ``"gather"`` on
the card. The file imports neither JAX nor the JAX package, and the
repo's conftest does, so run it with::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

chip_smoke.py holds the same kernels to the same tolerances at OPT-1.3B
shapes.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import gpt
from ray_tpu_torch.ops import paged_attention as pa
from ray_tpu_torch.serve.llm import LLMEngine

pytestmark = pytest.mark.cuda

# fp32: reassociation of fp32 sums only. bf16: each side rounds every
# probability and its output to bf16 (unit roundoff u = 2^-8), so per
# element |out - ref| <= 2u (|ref| + S), S the attention of |V| in fp32
# (chip_smoke.py derives it); 8e-3 > 2u leaves room for the fp32 terms.
FP32_ATOL = 1e-5
BF16_REL = 8e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernels are built with nvcc)")
    pa.reset_launch_counts()
    return torch.device("cuda")


def _pool(rng, n_pages, ps, H, K, dtype, dev):
    def plane():
        return torch.from_numpy(rng.normal(size=(n_pages, ps, H, K)).astype(
            np.float32)).to(dev, dtype)
    return plane(), plane()


def _abs_v(reference, q, kp, vp, *args):
    """S of the bf16 bound: the plain version on fp32 copies with |V|."""
    return reference(q.float(), kp.float(), vp.float().abs(), *args)


def _close(out, ref, dtype, s_abs):
    out, ref = out.float(), ref.float()
    assert torch.isfinite(out).all()
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=0, atol=FP32_ATOL)
        return
    share = (out - ref).abs() / (BF16_REL * (ref.abs() + s_abs))
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
    assert pa.paged_attention.launches == 0


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
