"""The host-side plan of the port's wgmma attention kernels, on the CPU.

The bf16 flash forward, dq and dkv kernels and the paged prefill kernel
(``ops/csrc/attn_wgmma.cuh``, ``ops/csrc/flash_bwd.cu``) read their
tiles by TMA from tensor maps that the wrappers describe in plain Python
and pass through the C ABI: which
kernel a (dtype, head dim, page size) takes, and each map's geometry
(dims innermost first, byte strides, box, swizzle). These tests hold
those numbers on CPU tensors; the kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""

import math

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


@pytest.mark.parametrize("K", [64, 80, 128, 256])
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
    (128, "wgmma"), (256, "wgmma"), (48, "wgmma"), (24, "wgmma"),
    (96, "wgmma"), (4, "wgmma")])
@pytest.mark.parametrize("K", [64, 80, 128, 256])
def test_prefill_kernel_by_page_size(ps, kernel, K):
    """bf16 q takes the wgmma kernel at every page size: TMA boxes of
    gcd(ps, key tile) rows where ps is a multiple of 8, gathered rows
    (box rows 0) at any other."""
    assert pa.prefill_box_rows(K, ps) == (
        math.gcd(ps, pa.key_tile(K)) if ps % 8 == 0 else 0)
    assert pa.prefill_kernel(torch.bfloat16, K, ps) == kernel
    assert pa.prefill_kernel(torch.float32, K, ps) == "fma"


def test_prefill_kernel_refuses_other_shapes():
    with pytest.raises(ValueError, match="head_dim"):
        pa.prefill_kernel(torch.bfloat16, 96, 64)
    with pytest.raises(ValueError, match="no prefill kernel"):
        pa.prefill_kernel(torch.float16, 64, 64)
    with pytest.raises(ValueError, match="page_size 0"):
        pa.prefill_kernel(torch.bfloat16, 64, 0)
    # Head dim 256 takes the wgmma kernel at every page size (48: a
    # gptj_6b engine's, in boxes of 16 rows); 96 is no head dim of a
    # kernel at any page size.
    assert pa.prefill_kernel(torch.bfloat16, 256, 64) == "wgmma"
    assert pa.prefill_kernel(torch.float32, 256, 48) == "fma"
    assert pa.prefill_kernel(torch.bfloat16, 256, 48) == "wgmma"
    with pytest.raises(ValueError, match="head_dim 96"):
        pa.prefill_kernel(torch.bfloat16, 96, 48)


@pytest.mark.parametrize("ps,rows", [
    (4, {64: 0, 80: 0, 128: 0, 256: 0}), (12, {64: 0, 80: 0, 128: 0, 256: 0}),
    (20, {64: 0, 80: 0, 128: 0, 256: 0}), (24, {64: 8, 80: 8, 128: 8, 256: 8}),
    (48, {64: 16, 80: 16, 128: 16, 256: 16}),
    (96, {64: 32, 80: 32, 128: 32, 256: 32}),
    (100, {64: 0, 80: 0, 128: 0, 256: 0})])
@pytest.mark.parametrize("K", [64, 80, 128, 256])
def test_prefill_plan_pieces_stay_within_a_page(ps, rows, K):
    """The producer's pieces of a key tile at page sizes that once took the
    mma.sync kernel: TMA boxes of whole 8-row swizzle atoms (each at a
    multiple of 1024 bytes of the tile) where ps is a multiple of 8,
    single gathered rows elsewhere. Every key of a tile is in exactly one
    piece, and for the first tiles of a slot every piece's keys lie in one
    page. The plan carries the pool maps only where it boxes."""
    tile = pa.key_tile(K)
    assert pa.prefill_box_rows(K, ps) == rows[K]
    # The producer's pieces: (first key of the tile, keys), as its loops
    # walk them (`paged_prefill.cu`: boxes of box rows, or single rows).
    n = rows[K] or 1
    pieces = [(first, n) for first in range(0, tile, n)]
    covered = sorted(k for first, n in pieces for k in range(first, first + n))
    assert covered == list(range(tile))
    for first, n in pieces:
        if rows[K]:
            assert n % 8 == 0 and (first * 128) % 1024 == 0
        for t in range(8):                      # key0 = t · tile
            pages = {(t * tile + first + i) // ps for i in range(n)}
            assert len(pages) == 1
    q = torch.zeros(2, 40, 3, K, dtype=torch.bfloat16)
    for dtype in (torch.bfloat16, torch.int8):
        pool = torch.zeros(5, ps, 3, K, dtype=dtype)
        plan = pa.prefill_plan(q, pool, pool)
        assert (plan.box_rows, plan.gather) == (rows[K], not rows[K])
        assert len(plan.maps) == 3 * WORDS
        for i in (1, 2):
            words = plan.maps[i * WORDS:(i + 1) * WORDS]
            if plan.gather:
                assert words == [0] * WORDS
            else:
                assert _fields(words)[4][-1] == rows[K]


@pytest.mark.parametrize("K,tile,boxes", [(64, 128, 1), (128, 64, 2)])
def test_head_dim_128_is_two_column_boxes(K, tile, boxes):
    assert pa.key_tile(K) == tile
    assert pa.column_boxes(K) == boxes
    q = torch.zeros(1, 8, 2, K, dtype=torch.bfloat16)
    _e, _r, dims, _s, box, swz = _fields(fa.flash_plan(q, q, q)[:WORDS])
    assert dims[0] == K and box[0] * boxes == K and box[0] * 2 == swz


@pytest.mark.parametrize("K,tile,boxes,padded", [
    (64, 128, 1, 64), (80, 64, 2, 128), (128, 64, 2, 128), (256, 64, 4, 256)])
def test_column_boxes_cover_every_column(K, tile, boxes, padded):
    """Every map a wgmma kernel reads is boxes of 64 columns, one 128-byte
    swizzle span each, and a row's boxes cover all its K columns: head dim
    80 is two boxes, the second reading columns 64-127 of which TMA
    zero-fills 80-127 (no device memory read for them), 256 four. The
    kernels stage `padded_head_dim` columns a row."""
    assert pa.key_tile(K) == tile
    assert pa.column_boxes(K) == boxes
    assert pa.padded_head_dim(K) == padded == boxes * pa.BOX_COLS
    assert (boxes - 1) * pa.BOX_COLS < K <= boxes * pa.BOX_COLS
    q = torch.zeros(2, 200, 3, K, dtype=torch.bfloat16)
    pool = torch.zeros(5, 64, 3, K, dtype=torch.bfloat16)
    plans = [fa.flash_plan(q, q, q), fa.flash_dq_plan(q, q, q, q),
             fa.flash_dkv_plan(q, q, q, q), pa.prefill_plan(q, pool, pool).maps]
    for words in plans:
        for i in range(len(words) // WORDS):
            elem, _rank, dims, _st, box, swz = _fields(
                words[i * WORDS:(i + 1) * WORDS])
            assert dims[0] == K and box[0] == pa.BOX_COLS
            assert box[0] * elem == swz == pa.SWIZZLE_BYTES


@pytest.mark.parametrize("ps", [16, 64, 128])
@pytest.mark.parametrize("K", [64, 80, 128, 256])
def test_prefill_plan_float_pool(ps, K):
    """The pool layer as [(P+1)·ps, H, K] in boxes of gcd(ps, key tile)
    rows and 64 swizzled columns; q in 128-row boxes."""
    B, C, H, P1 = 3, 40, 2, 9
    q = torch.zeros(B, C, H, K, dtype=torch.bfloat16)
    pool = torch.zeros(P1, ps, H, K, dtype=torch.bfloat16)
    maps = pa.prefill_plan(q, pool, pool).maps
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
@pytest.mark.parametrize("K", [64, 80, 128, 256])
def test_prefill_plan_int8_pool(ps, K):
    """An int8 pool is read as whole unswizzled rows of codes (the
    producer's widening warps swizzle them into bf16 tiles)."""
    q = torch.zeros(2, 72, 4, K, dtype=torch.bfloat16)
    pool = torch.zeros(5, ps, 4, K, dtype=torch.int8)
    maps = pa.prefill_plan(q, pool, pool).maps
    elem, rank, dims, strides, box, swz = _fields(maps[WORDS:2 * WORDS])
    assert (elem, rank, swz) == (1, 3, 0)
    assert dims == [K, 4, 5 * ps] and strides == [K, 4 * K]
    assert box == [K, 1, min(ps, pa.key_tile(K))]


def _bwd_views(packed, B, S, T, H, K):
    """q, k, v, dO: views of packed [B, S, 3, H, K] projections (q of
    one, k and v of another, as the train step passes them) or dense."""
    bf = dict(dtype=torch.bfloat16)
    if packed:
        qkv_q = torch.zeros(B, S, 3, H, K, **bf)
        qkv_kv = torch.zeros(B, T, 3, H, K, **bf)
        q, k, v = qkv_q[:, :, 0], qkv_kv[:, :, 1], qkv_kv[:, :, 2]
    else:
        q, k, v = (torch.zeros(B, n, H, K, **bf) for n in (S, T, T))
    return q, k, v, torch.zeros(B, S, H, K, **bf)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("S,T", [(200, 333), (1, 64), (333, 200)])
@pytest.mark.parametrize("K", [64, 80, 128, 256])
def test_dq_plan(K, S, T, packed):
    """dq is query-major: q and dO in boxes of 128 rows (an item), k and v
    in boxes of the forward's key tile (64 at head dim 256, where each
    ring slot holds one K or one V tile: three 32 KB slots beside the
    item's 128 KB of Q and dO), each map over its own view and strides."""
    B, H = 2, 3
    views = _bwd_views(packed, B, S, T, H, K)
    maps = fa.flash_dq_plan(*views)
    assert len(maps) == 4 * WORDS
    kt = fa.dq_key_tile(K)
    assert kt == pa.key_tile(K) == (128 if K == 64 else 64)
    if K == 256:   # Q and dO of an item, three slots, barriers, alignment
        smem = (2 * pa.WGMMA_ROWS * K * 2 + 3 * kt * K * 2
                + 8 * (4 + 3 * 3) + 1024)
        assert smem == 230_504 <= 232_448
    rows = (pa.WGMMA_ROWS, kt, kt, pa.WGMMA_ROWS)
    for i, (t, r) in enumerate(zip(views, rows)):
        elem, rank, dims, strides, box, swz = _fields(
            maps[i * WORDS:(i + 1) * WORDS])
        assert (elem, rank, swz) == (2, 4, 128)
        assert dims == [K, H, t.shape[1], B]
        assert strides == [t.stride(2) * 2, t.stride(1) * 2, t.stride(0) * 2]
        assert box == [64, 1, r, 1]
    if packed:   # q, k, v read in place: the packed row is 3·H·K elements
        assert views[0].stride(1) == 3 * H * K
    # The forward's three maps are dq's first three.
    assert maps[:3 * WORDS] == fa.flash_plan(*views[:3])



@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("S,T", [(200, 333), (1, 64), (333, 200)])
@pytest.mark.parametrize("K", [64, 80, 128, 256])
def test_dkv_plan(K, S, T, packed):
    """dkv is key-major: an item is DKV_KEYS keys (k, v boxes; 64 at head
    dim 256, where the two warpgroups share the keys, each scoring half
    the walked tile's rows and owning half the head dim of dk and dv),
    the walked tiles DKV_ROWS query rows (q, dO boxes); a head dim of 128
    is two 64-column boxes, and so is 80 (the second box's columns past 80
    read as zeros), 256 four."""
    B, H = 2, 3
    views = _bwd_views(packed, B, S, T, H, K)
    maps = fa.flash_dkv_plan(*views)
    assert len(maps) == 4 * WORDS
    assert (fa.DKV_KEYS, fa.DKV_KEYS_SPLIT, fa.DKV_ROWS) == (128, 64, 64)
    keys = fa.dkv_keys(K)
    assert keys == (fa.DKV_KEYS_SPLIT if K == 256 else fa.DKV_KEYS)
    if K == 256:
        # K and V of one item, two Q/dO stages, the shared P^T and dS^T
        # tiles ([keys x rows] bf16 each), the stages' lse and delta rows,
        # 13 barriers (the ring's, then the tiles' three), alignment.
        kv, stage = 2 * keys * K * 2, 2 * fa.DKV_ROWS * K * 2
        pt = 2 * keys * fa.DKV_ROWS * 2
        smem = kv + 2 * stage + pt + 2 * 2 * fa.DKV_ROWS * 4 + 8 * 13 + 1024
        assert (kv, stage, pt, smem) == (65_536, 65_536, 16_384, 215_144)
        assert smem <= 232_448
    rows = (fa.DKV_ROWS, keys, keys, fa.DKV_ROWS)
    for i, (t, r) in enumerate(zip(views, rows)):
        elem, rank, dims, strides, box, swz = _fields(
            maps[i * WORDS:(i + 1) * WORDS])
        assert dims == [K, H, t.shape[1], B]
        assert strides == [t.stride(2) * 2, t.stride(1) * 2, t.stride(0) * 2]
        assert box == [64, 1, r, 1]
        assert 64 * pa.column_boxes(K) == pa.padded_head_dim(K) >= K
        assert swz == 128 and elem == 2


@pytest.mark.parametrize("make", [
    lambda: torch.zeros(2, 9, 3, 68, dtype=torch.bfloat16)[..., :64],
    lambda: torch.zeros(2 * 9 * 3 * 64 + 1, dtype=torch.bfloat16)[
        1:].view(2, 9, 3, 64),
], ids=["row-stride-136-bytes", "base-2-bytes-off"])
def test_bwd_plans_refuse_unaligned_do(make):
    """dO is mapped like q: a view TMA cannot read raises (the wrapper's
    `_kernel_operands` copies such a view to a contiguous one first)."""
    q = torch.zeros(2, 9, 3, 64, dtype=torch.bfloat16)
    for plan in (fa.flash_dq_plan, fa.flash_dkv_plan):
        with pytest.raises(ValueError, match="16-byte"):
            plan(q, q, q, make())
    assert not fa._aligned(make())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_row_vectors_are_the_kernels_layout(dtype):
    """lse and delta reach the kernels as contiguous fp32 [B, S, H]: row
    s of head h of batch b at (b·S + s)·H + h, which dq reads per item
    and dkv's staging warp per walked tile, whatever layout and dtype
    the caller passed."""
    B, S, H = 2, 37, 3
    q = torch.zeros(B, S, H, 64, dtype=torch.bfloat16)
    lse = torch.arange(B * H * S, dtype=torch.float32).view(B, H, S).to(
        dtype).transpose(1, 2)                       # strided [B, S, H]
    delta = torch.full((B, S, H), 0.5, dtype=dtype)
    rl, rd = fa._row_vectors(q, lse, delta)
    for r in (rl, rd):
        assert r.dtype == torch.float32 and r.is_contiguous()
        assert r.shape == (B, S, H) and r.stride() == (S * H, H, 1)
    flat = rl.flatten()
    b, s, h = 1, 20, 2
    assert flat[(b * S + s) * H + h] == lse[b, s, h].float()
    with pytest.raises(ValueError, match="row vector"):
        fa._row_vectors(q, lse[:, :-1])


def test_plan_words_cross_the_c_abi():
    """The flat list becomes a C long long array of 3 maps."""
    q = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    arr = pa._c_array(fa.flash_plan(q, q, q))
    assert len(arr) == 3 * WORDS and list(arr) == fa.flash_plan(q, q, q)
    assert pa._addr(None) is None and pa._addr(arr) > 0
    for plan in (fa.flash_dq_plan, fa.flash_dkv_plan):
        arr = pa._c_array(plan(q, q, q, q))
        assert len(arr) == 4 * WORDS and list(arr) == plan(q, q, q, q)


# ------------------------------------------------- the decode kernel's split-K


def test_decode_ring_fits_four_blocks_per_sm():
    """Three 16 KB stages, 256 bytes of int8 scales each and six
    mbarriers: 49,968 bytes a block, four blocks in an SM's 228 KB
    (csrc/paged_decode.cu asserts the same four)."""
    assert pa.DECODE_SMEM_BYTES == 49968
    assert pa.DECODE_BLOCKS_PER_SM == 4


@pytest.mark.parametrize("B,H,n_pg,n_sm,n_split", [
    (16, 32, 16, 132, 16),   # the timed shape: 16 slots of 1,024 at ps 64
    (16, 32, 32, 132, 16),   # light load: the same view, a 2,048 table
    (1, 32, 32, 132, 32),    # one slot at 2,048: a split per page
    (5, 4, 3, 132, 3),       # few units: at most one split per page
    (64, 32, 32, 132, 4),
    (200, 32, 4, 132, 1),    # units fill four waves alone: no split
    (16, 32, 1, 132, 1),     # a one-page table
    (16, 32, 32, 114, 14),   # an H100 PCIe's 114 SMs
    (7, 6, 64, 132, 64),     # a ragged head group counts as one unit
])
def test_decode_splits(B, H, n_pg, n_sm, n_split):
    assert pa.decode_splits(B, H, n_pg, n_sm) == n_split


@pytest.mark.parametrize("K,itemsize,rows", [(64, 2, 16), (128, 2, 8),
                                              (64, 4, 8), (128, 4, 4),
                                              (64, 1, 32), (128, 1, 16),
                                              (80, 2, 8), (80, 4, 4),
                                              (80, 1, 16), (256, 2, 4),
                                              (256, 4, 2), (256, 1, 8)])
def test_decode_stage_rows(K, itemsize, rows):
    assert pa.decode_stage_rows(K, itemsize) == rows


@pytest.mark.parametrize("lengths,n_pg,parts", [
    ([1024] * 16, 16, [4] * 16),             # timed: one wave of 512 blocks
    ([2048] * 2 + [1] * 14, 32, [16] * 2 + [1] * 14),   # light load
    ([2048], 32, [32]),                      # one slot: a split per page
    ([0, 1, 64, 65, 2148] + [2048] * 11, 32,  # past the table: 2048
     [1, 1, 1, 1, 5] + [5] * 11),
])
def test_decode_live_splits(lengths, n_pg, parts):
    """How many of the grid's splits each slot uses, from the whole
    batch's live stages (H 32, ps 64, bf16 K 64: 16 positions a stage; the
    H100's 132 SMs)."""
    n_split = pa.decode_splits(len(lengths), 32, n_pg)
    assert pa.decode_live_splits(lengths, 64, n_pg, 32, n_split, 16) == parts


@pytest.mark.parametrize("n_parts", [1, 3, 6, 32])
def test_decode_split_positions_cover_each_live_position_once(n_parts):
    """Each split's positions are a contiguous range starting on a stage,
    the ranges in split order cover the slot's min(length, n_pg·ps) live
    positions once, their stage counts differ by at most one, and no split
    is empty while n_parts is at most the live stages."""
    for ps, rows in ((16, 16), (16, 32), (64, 16), (8, 16)):
        for n_pg in (1, 16, 32):
            for length in (0, 1, ps - 1, ps, ps + 1, 100, 1024, 2047, 2048,
                           2148, 5000):
                parts = pa.decode_split_positions(length, ps, n_pg, n_parts,
                                                  rows)
                end = min(length, n_pg * ps)
                stages = -(-end // rows) if end > 0 else 0
                assert len(parts) == n_parts
                assert parts[0][0] == 0 and parts[-1][1] == max(end, 0)
                for (b0, e0), (b1, _e1) in zip(parts, parts[1:]):
                    assert e0 == b1 and b1 % rows == 0
                sizes = [-(-(e - b) // rows) for b, e in parts]
                assert max(sizes) - min(sizes) <= 1
                assert min(sizes) > 0 or n_parts > stages


def test_decode_split_positions_edges():
    # An idle slot (one position on the null page) uses one split.
    assert pa.decode_live_splits([1], 64, 32, 32, 12, 16) == [1]
    assert pa.decode_split_positions(1, 64, 32, 1, 16) == [(0, 1)]
    # A cursor past the table reads the whole table, no further.
    assert pa.decode_split_positions(2148, 64, 32, 6, 16)[-1] == (1696, 2048)
    assert pa.decode_split_positions(0, 64, 32, 1, 16) == [(0, 0)]
    # 64 stages of 16 positions in 3 splits: 21, 21 and 22 stages.
    assert pa.decode_split_positions(1024, 64, 16, 3, 16) == [
        (0, 336), (336, 672), (672, 1024)]
