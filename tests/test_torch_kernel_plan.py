"""The host-side plan of the port's wgmma attention kernels, on the CPU.

The bf16 flash forward and paged prefill kernels (``ops/csrc/
attn_wgmma.cuh``) read their tiles by TMA from tensor maps that the
wrappers describe in plain Python and pass through the C ABI: which
kernel a (dtype, head dim, page size) takes, and each map's geometry
(dims innermost first, byte strides, box, swizzle). These tests hold
those numbers on CPU tensors; the kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""

import pytest
import torch

from ray_tpu_torch.ops import attention as fa
from ray_tpu_torch.ops import paged_attention as pa

WORDS = pa.TMAP_WORDS


def _fields(words):
    """One map's TMAP_WORDS numbers → (elem bytes, rank, dims, strides,
    box, swizzle), each list cut to the rank."""
    assert len(words) == WORDS
    elem, rank = words[0], words[1]
    return (elem, rank, words[2:2 + rank], words[7:7 + rank - 1],
            words[11:11 + rank], words[16])


def test_contiguous_map_is_innermost_first():
    t = torch.zeros(2, 300, 3, 64, dtype=torch.bfloat16)
    elem, rank, dims, strides, box, swz = _fields(
        pa.tensor_map(t, (1, 128, 1, 64), 128))
    assert (elem, rank, swz) == (2, 4, 128)
    assert dims == [64, 3, 300, 2]
    assert strides == [64 * 2, 3 * 64 * 2, 300 * 3 * 64 * 2]
    assert box == [64, 1, 128, 1]


@pytest.mark.parametrize("K", [64, 128])
def test_packed_qkv_views_keep_their_strides(K):
    """q, k, v as views of one [B, S, 3, H, K] projection: each map
    starts at its own view and walks the packed tensor's strides."""
    B, S, H = 2, 40, 3
    qkv = torch.zeros(B, S, 3, H, K, dtype=torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    maps = fa.flash_plan(q, k, v)
    assert len(maps) == 3 * WORDS
    row = 3 * H * K * 2                         # bytes from one s to the next
    for i, t in enumerate((q, k, v)):
        _elem, _rank, dims, strides, box, _ = _fields(
            maps[i * WORDS:(i + 1) * WORDS])
        assert dims == [K, H, S, B]
        assert strides == [K * 2, row, S * row]
        rows = pa.WGMMA_ROWS if i == 0 else pa.key_tile(K)
        assert box == [64, 1, rows, 1]
        assert t.data_ptr() - q.data_ptr() == i * H * K * 2


def test_transposed_view_strides():
    """[B, H, S, K] storage read as [B, S, H, K] through a transpose."""
    base = torch.zeros(2, 3, 50, 64, dtype=torch.bfloat16)
    t = base.transpose(1, 2)
    _e, _r, dims, strides, _b, _s = _fields(
        pa.tensor_map(t, (1, 128, 1, 64), 128))
    assert dims == [64, 3, 50, 2]
    assert strides == [50 * 64 * 2, 64 * 2, 3 * 50 * 64 * 2]


@pytest.mark.parametrize("make", [
    lambda: torch.zeros(2, 9, 3, 68, dtype=torch.bfloat16)[..., :64],
    lambda: torch.zeros(2, 9, 3 * 64 + 4, dtype=torch.bfloat16)[
        ..., :3 * 64].view(2, 9, 3, 64),
    lambda: torch.zeros(2 * 9 * 3 * 64 + 1, dtype=torch.bfloat16)[
        1:].view(2, 9, 3, 64),
], ids=["row-stride-136-bytes", "seq-stride-392-bytes", "base-2-bytes-off"])
def test_sixteen_byte_rule_raises(make):
    with pytest.raises(ValueError, match="16-byte"):
        pa.tensor_map(make(), (1, 128, 1, 64), 128)


def test_strided_inner_dim_and_wide_box_raise():
    t = torch.zeros(2, 9, 3, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="innermost"):
        pa.tensor_map(t.transpose(2, 3), (1, 128, 1, 3), 128)
    with pytest.raises(ValueError, match="swizzle span"):
        pa.tensor_map(t.new_zeros(2, 9, 3, 128), (1, 128, 1, 128), 128)
    with pytest.raises(ValueError, match="box"):
        pa.tensor_map(t, (128, 1, 64), 128)


@pytest.mark.parametrize("ps,kernel", [
    (8, "wgmma"), (16, "wgmma"), (32, "wgmma"), (64, "wgmma"),
    (128, "wgmma"), (256, "wgmma"), (48, "mma"), (24, "mma"), (96, "mma"),
    (4, "mma")])
@pytest.mark.parametrize("K", [64, 128])
def test_prefill_kernel_by_page_size(ps, kernel, K):
    assert pa.wgmma_page_size(ps) == (kernel == "wgmma")
    assert pa.prefill_kernel(torch.bfloat16, K, ps) == kernel
    assert pa.prefill_kernel(torch.float32, K, ps) == "fma"


def test_prefill_kernel_refuses_other_shapes():
    with pytest.raises(ValueError, match="head_dim"):
        pa.prefill_kernel(torch.bfloat16, 80, 64)
    with pytest.raises(ValueError, match="no prefill kernel"):
        pa.prefill_kernel(torch.float16, 64, 64)


@pytest.mark.parametrize("K,tile,boxes", [(64, 128, 1), (128, 64, 2)])
def test_head_dim_128_is_two_column_boxes(K, tile, boxes):
    assert pa.key_tile(K) == tile
    assert pa.column_boxes(K) == boxes
    q = torch.zeros(1, 8, 2, K, dtype=torch.bfloat16)
    _e, _r, dims, _s, box, swz = _fields(fa.flash_plan(q, q, q)[:WORDS])
    assert dims[0] == K and box[0] * boxes == K and box[0] * 2 == swz


@pytest.mark.parametrize("ps", [16, 64, 128])
@pytest.mark.parametrize("K", [64, 128])
def test_prefill_plan_float_pool(ps, K):
    """The pool layer as [(P+1)·ps, H, K] in boxes of gcd(ps, key tile)
    rows and 64 swizzled columns; q in 128-row boxes."""
    B, C, H, P1 = 3, 40, 2, 9
    q = torch.zeros(B, C, H, K, dtype=torch.bfloat16)
    pool = torch.zeros(P1, ps, H, K, dtype=torch.bfloat16)
    maps = pa.prefill_plan(q, pool, pool)
    qf = _fields(maps[:WORDS])
    assert qf[2] == [K, H, C, B] and qf[4] == [64, 1, pa.WGMMA_ROWS, 1]
    rows = min(ps, pa.key_tile(K))
    for i in (1, 2):
        elem, rank, dims, strides, box, swz = _fields(
            maps[i * WORDS:(i + 1) * WORDS])
        assert (elem, rank, swz) == (2, 3, 128)
        assert dims == [K, H, P1 * ps]
        assert strides == [K * 2, H * K * 2]
        assert box == [64, 1, rows]


@pytest.mark.parametrize("ps", [16, 64])
@pytest.mark.parametrize("K", [64, 128])
def test_prefill_plan_int8_pool(ps, K):
    """An int8 pool is read as whole unswizzled rows of codes (the
    producer's widening warps swizzle them into bf16 tiles)."""
    q = torch.zeros(2, 72, 4, K, dtype=torch.bfloat16)
    pool = torch.zeros(5, ps, 4, K, dtype=torch.int8)
    maps = pa.prefill_plan(q, pool, pool)
    elem, rank, dims, strides, box, swz = _fields(maps[WORDS:2 * WORDS])
    assert (elem, rank, swz) == (1, 3, 0)
    assert dims == [K, 4, 5 * ps] and strides == [K, 4 * K]
    assert box == [K, 1, min(ps, pa.key_tile(K))]


def test_plan_words_cross_the_c_abi():
    """The flat list becomes a C long long array of 3 maps."""
    q = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    arr = pa._c_array(fa.flash_plan(q, q, q))
    assert len(arr) == 3 * WORDS and list(arr) == fa.flash_plan(q, q, q)
    assert pa._addr(None) is None and pa._addr(arr) > 0
