"""Ragged paged attention: CUDA kernels for Hopper and their plain versions.

Counterpart of ``ray_tpu/ops/paged_attention.py``. Two kernels, written
by hand in CUDA C++ for sm_90a (sources in ``ops/csrc/``, built by
``ops/_build.py`` at first use and called through ctypes), each with a
float and an int8 program:

- `paged_attention`: single-query decode attention straight against one
  layer's page pool, split-K over the positions (replaces the Pallas
  `_decode_kernel`);
- `paged_prefill_attention`: a C-query chunk at an arbitrary offset,
  causal within the chunk (replaces the Pallas `_prefill_kernel`).

A pool in q's dtype takes the float program. An int8 pool comes with the
layer's per-page scale vectors ``k_scale``/``v_scale`` [P+1] (bf16, the
pool's own scale planes; the plain versions take any float dtype) and
takes the int8 program, which dequantizes each page in the kernel (``code · scale[page id]``, fp32): no float plane is ever written
to device memory. As in the Pallas int8 programs, both products then run
in fp32 and the probabilities are NOT rounded to q's dtype.

Beside each sits its plain PyTorch version (`reference_paged_attention`,
`reference_paged_prefill_attention`): it reconstitutes each slot's
contiguous timeline (dequantized in fp32 for an int8 pool) and runs
full-softmax attention, rounding the probabilities to q's dtype before
the PV product — the JAX gather references' math, which differs there
from the int8 Pallas programs'. The plain versions are the kernels'
oracle and the engine's ``attn_impl="gather"`` path.

Dispatch is by the device of the tensors, nothing else: a CPU tensor
goes to the plain version, a CUDA tensor to the kernel (which raises on
a shape or dtype it does not take). There is no fallback from a failed
launch. Each wrapper counts its kernel launches in plain integer
attributes, the float program's in ``.launches`` and the int8
program's in ``.int8_launches`` (``paged_attention.launches``), so a
run can show which programs its main path went through.

Layouts are the JAX package's: pool ``[P+1, ps, H, K]`` (one layer; row
0 is the null page), q ``[B, H, K]`` for decode and ``[B, C, H, K]``
for prefill, tables ``[B, n_pg]`` int32 (``n_pg`` may be a width-sliced
view: every loop bound comes from ``tables.shape[1]``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ray_tpu_torch._device import check_device

NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)      # the kernels' instantiations
_MAX_SMEM_BYTES = 232448   # what one block may opt in to on Hopper


def _check_shapes(q, k_pool, v_pool, H, K):
    P, ps, Hp, Kp = k_pool.shape
    if (Hp, Kp) != (H, K) or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"pool/query shape mismatch: q {tuple(q.shape)}, k_pool "
            f"{tuple(k_pool.shape)}, v_pool {tuple(v_pool.shape)}")
    return ps


def _quantized(k_pool, v_pool, k_scale, v_scale) -> bool:
    """True for an int8 pool with its scale vectors, False for a float
    pool without; anything in between raises."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come together")
    int8 = k_pool.dtype == torch.int8 or v_pool.dtype == torch.int8
    if k_scale is None:
        if int8:
            raise ValueError("an int8 pool needs k_scale and v_scale")
        return False
    if not (k_pool.dtype == v_pool.dtype == torch.int8):
        raise ValueError(f"scales given with a {k_pool.dtype} pool "
                         "(int8 pools only)")
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        if s.shape != (k_pool.shape[0],):
            raise ValueError(f"{name} shape {tuple(s.shape)} != "
                             f"({k_pool.shape[0]},) (one scale per page)")
    return True


def _cuda_operands(q, k_pool, v_pool, index_arrays, quant):
    """Validate the kernel's operands: one CUDA device, float32/bfloat16
    q, pools of q's dtype (int8 for the int8 program), contiguous and
    16-byte aligned (the kernels read rows in 16-byte vectors). Index
    arrays become contiguous int32 on that device (a no-op when they
    already are)."""
    dev = q.device
    check_device(dev, k_pool=k_pool, v_pool=v_pool, **dict(index_arrays))
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"kernel takes float32 or bfloat16, got {q.dtype}")
    pool_dtype = torch.int8 if quant else q.dtype
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        want = q.dtype if name == "q" else pool_dtype
        if t.dtype != want:
            raise ValueError(f"{name} dtype {t.dtype} != {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return [t.to(torch.int32).contiguous() for _name, t in index_arrays]


def _scale_operands(dev, k_scale, v_scale):
    """The int8 program's scale vectors: bf16 (the pool's own planes,
    read as they are), contiguous, on ``dev``."""
    check_device(dev, k_scale=k_scale, v_scale=v_scale)
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        if s.dtype != torch.bfloat16:
            raise ValueError(f"{name} dtype {s.dtype} != torch.bfloat16 "
                             "(the kernel reads the pool's bf16 scales)")
    return k_scale.contiguous(), v_scale.contiguous()


def _stream_ptr(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _ptr(t):
    """A tensor's address for the C ABI, NULL for None."""
    return None if t is None else t.data_ptr()


# ------------------------------------------------ the kernels' host plan
#
# The wgmma kernels (csrc/attn_wgmma.cuh) read their tiles by TMA. What
# they read is decided here, in plain Python, and passed through the C
# ABI: which kernel a shape takes, and each tensor map's geometry.

WGMMA_ROWS = 128           # query rows per block of the wgmma kernels
SWIZZLE_BYTES = 128        # a bf16 tile row: 64 columns in one swizzle span
TMAP_WORDS = 17            # numbers per tensor map (csrc/hopper.cuh)


def key_tile(K: int) -> int:
    """Keys per tile of the wgmma kernels: 128 at head dim 64, 64 at 128
    (one bf16 K or V tile is 16 KB either way)."""
    return 128 if K == 64 else 64


def column_boxes(K: int) -> int:
    """64-column TMA boxes per bf16 row: a 128-byte swizzle span holds 64
    bf16 columns, so a head dim of 128 is read as two boxes."""
    return K * 2 // SWIZZLE_BYTES


def tensor_map(t: torch.Tensor, box, swizzle: int) -> list[int]:
    """The geometry of a TMA tensor map over the view ``t``, read in boxes
    of ``box`` elements (one per dim, torch order): the TMAP_WORDS numbers
    the C entry points encode — element bytes, rank, dims innermost first
    (5, zero-padded), the byte strides of dims 1.. (4), the box innermost
    first (5) and the swizzle in bytes. Raises ValueError for a view TMA
    cannot read: a strided innermost dim, a base or stride that is not a
    multiple of 16 bytes, a box row longer than the swizzle span."""
    item, rank = t.element_size(), t.dim()
    if len(box) != rank or not 1 <= rank <= 5:
        raise ValueError(f"box {tuple(box)} for a rank-{rank} tensor")
    if rank > 1 and t.stride(-1) != 1:
        raise ValueError(f"innermost dim strided ({t.stride(-1)}): TMA reads "
                         "rows of contiguous elements")
    strides = [t.stride(i) * item for i in reversed(range(rank - 1))]
    if any(s % 16 for s in strides) or t.data_ptr() % 16:
        raise ValueError(f"TMA needs 16-byte aligned rows: base "
                         f"{t.data_ptr() % 16} bytes off, byte strides "
                         f"{strides}")
    inner = box[-1] * item
    if inner % 16 or (swizzle and inner > swizzle):
        raise ValueError(f"box row of {inner} bytes (a multiple of 16, at "
                         f"most the {swizzle}-byte swizzle span)")
    pad = lambda xs, n: xs + [0] * (n - len(xs))
    return [item, rank, *pad(list(t.shape)[::-1], 5), *pad(strides, 4),
            *pad(list(box)[::-1], 5), swizzle]


def wgmma_page_size(ps: int) -> bool:
    """Page sizes the wgmma prefill kernel takes: a key tile is whole TMA
    boxes of gcd(ps, key tile) rows, each a multiple of the 8-row swizzle
    atom, so ps is 8, 16 or 32, or a multiple of 64."""
    return ps > 0 and ps % 8 == 0 and (64 % ps == 0 or ps % 64 == 0)


def prefill_kernel(dtype, K: int, ps: int) -> str:
    """The kernel `paged_prefill_attention` launches for a (q dtype, head
    dim, page size): "wgmma" (bf16 q at the page sizes of
    `wgmma_page_size`), "mma" (bf16 q at any other page size: the
    mma.sync kernel), "fma" (fp32 q). The C entry point holds the same
    rule."""
    if dtype == torch.float32:
        return "fma"
    if dtype != torch.bfloat16 or K not in _HEAD_DIMS:
        raise ValueError(f"no prefill kernel for {dtype} at head_dim {K}")
    return "wgmma" if wgmma_page_size(ps) else "mma"


def prefill_plan(q, k_pool, v_pool):
    """The wgmma prefill kernel's tensor maps: q [B, C, H, K] in boxes of
    128 rows and 64 columns; each pool layer viewed as [(P+1)·ps, H, K],
    in boxes of gcd(ps, key tile) rows (one per page piece of a key
    tile) — 64-column swizzled boxes for a bf16 pool, whole unswizzled
    rows of codes for an int8 one. → a flat list of 3 x TMAP_WORDS."""
    _B, _C, H, K = q.shape
    ps = k_pool.shape[1]
    rows = math.gcd(ps, key_tile(K))
    cols = K // column_boxes(K)
    maps = tensor_map(q, (1, WGMMA_ROWS, 1, cols), SWIZZLE_BYTES)
    for pool in (k_pool, v_pool):
        flat = pool.view(-1, H, K)
        if pool.dtype == torch.int8:
            maps += tensor_map(flat, (rows, 1, K), 0)
        else:
            maps += tensor_map(flat, (rows, 1, cols), SWIZZLE_BYTES)
    return maps


# The decode kernel's split-K rule (csrc/paged_decode.cu, which checks the
# n_split it is given against its own copy of the rule). A block takes a
# group of DECODE_HEAD_GROUP heads of one slot and one split of the slot's
# live positions, through a ring of DECODE_STAGES 16 KB stages; the ring and
# its barriers take DECODE_SMEM_BYTES, so 4 blocks fit in an SM's 228 KB.
DECODE_HEAD_GROUP = 4
DECODE_STAGES = 3
DECODE_SMEM_BYTES = DECODE_STAGES * (16384 + 256) + 2 * DECODE_STAGES * 8
DECODE_BLOCKS_PER_SM = 233472 // (DECODE_SMEM_BYTES + 1024)
DECODE_WAVES = 4
H100_SMS = 132


def decode_splits(B: int, H: int, n_pg: int, n_sm: int = H100_SMS) -> int:
    """How many splits of the positions per (slot, head group) the decode
    kernel's grid has for B slots of H heads on a table n_pg pages wide:
    DECODE_WAVES waves of resident blocks (``n_sm`` SMs x
    DECODE_BLOCKS_PER_SM) over the B · ceil(H / DECODE_HEAD_GROUP) units,
    at most one split per table page, at least one. Reads no lengths: the
    host never waits for the device; each slot then uses
    `decode_live_splits` of them. The C entry point holds the same rule."""
    units = B * -(-H // DECODE_HEAD_GROUP)
    n = DECODE_WAVES * n_sm * DECODE_BLOCKS_PER_SM // units
    return max(1, min(n, n_pg))


def decode_stage_rows(K: int, itemsize: int) -> int:
    """Positions per 16 KB stage of the decode kernel (R): K and V rows of
    DECODE_HEAD_GROUP heads, so 16 at K 64 bf16, 32 for int8 codes."""
    return 16384 // (2 * DECODE_HEAD_GROUP * K * itemsize)


def _live_stages(length: int, ps: int, n_pg: int, rows: int) -> int:
    """Stages of ``rows`` positions over a slot's live positions, at most
    the table's n_pg·ps (an idle slot's cursor can walk past its table)."""
    n = min(length, n_pg * ps)
    return -(-n // rows) if n > 0 else 0


def decode_live_splits(lengths, ps: int, n_pg: int, H: int, n_split: int,
                       rows: int, n_sm: int = H100_SMS) -> list[int]:
    """How many of the grid's n_split splits each slot uses, as every block
    of the decode kernel works it out on the device from all the lengths:
    the slot's share of one wave of ``n_sm`` x DECODE_BLOCKS_PER_SM blocks
    by its live stages (of ``rows`` positions, `decode_stage_rows`) against
    the whole batch's, rounded down, at most n_split, at most one per
    stage, at least one. So a lightly loaded batch spreads its few live
    slots over many blocks and a full one keeps one wave; the blocks with
    work take the grid's first indices, and the rest exit at once."""
    live = [_live_stages(int(n), ps, n_pg, rows) for n in lengths]
    groups = -(-H // DECODE_HEAD_GROUP)
    wave = n_sm * DECODE_BLOCKS_PER_SM
    total = max(1, sum(live) * groups)
    return [max(1, min(n_split, n, n * wave // total)) for n in live]


def decode_split_positions(length: int, ps: int, n_pg: int, n_parts: int,
                           rows: int) -> list[tuple[int, int]]:
    """The positions [begin, end) each of a slot's n_parts splits reads, as
    the decode kernel's blocks take them: of the slot's live stages
    (`_live_stages`), split s takes [s·n // n_parts, (s+1)·n // n_parts),
    cut at the slot's last live position. Every live position lies in
    exactly one split; with n_parts <= n (as `decode_live_splits` gives)
    none is empty."""
    n = _live_stages(length, ps, n_pg, rows)
    end = min(length, n_pg * ps)
    return [(s * n // n_parts * rows, min((s + 1) * n // n_parts * rows, end))
            for s in range(n_parts)]


def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


_DECODE_COUNTERS: dict = {}


def _decode_counters(dev, stream: int, n: int) -> torch.Tensor:
    """The decode kernel's arrival counters, one per (slot, head group):
    an int32 buffer kept per (device, stream), zeroed when it is made or
    grown; the last block of each group to arrive zeroes its counter
    again, so every launch on the stream finds them zero (launches on one
    stream run in order; another stream has its own buffer)."""
    key = (dev.index, stream)
    buf = _DECODE_COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _DECODE_COUNTERS[key] = buf
    return buf


def _c_array(words):
    return (ctypes.c_longlong * len(words))(*words)


def _addr(arr):
    """The address of a ctypes array for the C ABI, NULL for None (the
    caller keeps the array alive across the call)."""
    return None if arr is None else ctypes.addressof(arr)


def paged_attention(q, k_pool, v_pool, tables, lengths, *, sm_scale=None,
                    k_scale=None, v_scale=None):
    """Single-token decode attention straight against the KV page pool.

    q: [B, H, K] (post-rotary); k_pool, v_pool: [P+1, ps, H, K] one
    layer's pool, in q's dtype or int8 with ``k_scale``/``v_scale`` [P+1]
    (the layer's per-page scales, bf16 on CUDA); tables: [B, n_pg] int page ids
    (unallocated tail = 0); lengths: [B] valid kv positions per slot (the
    current token's K/V already written). → [B, H, K] in q.dtype. CPU
    tensors take the plain version; CUDA tensors launch the kernel on a
    grid of `decode_splits` splits per (slot, head group), of which each
    slot uses `decode_live_splits` (the last block of each head group
    merges them when there are several, from an fp32 workspace allocated
    here, counting arrivals in `_decode_counters`); the kernel reads the
    pool by TMA from tensor maps that its C entry point encodes, so
    nothing is planned here."""
    quant = _quantized(k_pool, v_pool, k_scale, v_scale)
    B, H, K = q.shape
    ps = _check_shapes(q, k_pool, v_pool, H, K)
    n_pg = tables.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(K)
    if q.device.type == "cpu":
        return reference_paged_attention(q, k_pool, v_pool, tables, lengths,
                                         sm_scale=sm_scale, k_scale=k_scale,
                                         v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    tables, lengths = _cuda_operands(
        q, k_pool, v_pool, (("tables", tables), ("lengths", lengths)), quant)
    if K not in _HEAD_DIMS:
        raise ValueError(f"decode kernel takes head_dim in "
                         f"{_HEAD_DIMS}, got {K}")
    out = torch.empty_like(q)
    if B == 0 or n_pg == 0:
        return out.zero_()
    from ray_tpu_torch.ops import _build

    lib = _build.library()
    n_split = decode_splits(B, H, n_pg, _sm_count(q.device))
    stream = _stream_ptr(q.device)
    ws = counters = None
    if n_split > 1:
        ws = torch.empty(n_split * B * H * (K + 2), dtype=torch.float32,
                         device=q.device)
        counters = _decode_counters(
            q.device, stream, B * -(-H // DECODE_HEAD_GROUP))
    common = (tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
              _ptr(ws), _ptr(counters), B, H, K, ps, n_pg, k_pool.shape[0],
              n_split, float(sm_scale), stream)
    if quant:
        ks, vs = _scale_operands(q.device, k_scale, v_scale)
        rc = lib.rtt_paged_decode_attention_int8(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), ks.data_ptr(), vs.data_ptr(), *common)
        _build.check(rc, "paged_attention int8 kernel launch")
        paged_attention.int8_launches += 1
    else:
        rc = lib.rtt_paged_decode_attention(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), *common)
        _build.check(rc, "paged_attention kernel launch")
        paged_attention.launches += 1
    return out


paged_attention.launches = 0
paged_attention.int8_launches = 0


def paged_prefill_attention(q, k_pool, v_pool, tables, offsets, lengths, *,
                            sm_scale=None, k_scale=None, v_scale=None):
    """Chunked-prefill attention straight against the KV page pool.

    q: [B, C, H, K] — each slot's chunk of C queries starting at absolute
    position ``offsets[b]``; pools as in `paged_attention` (float, or
    int8 with ``k_scale``/``v_scale``); tables: [B, n_pg] (may be a
    width-sliced view); lengths: [B] valid kv positions (offset + valid
    chunk tokens, <= n_pg * page_size). → [B, C, H, K] in q.dtype; rows
    past a slot's valid chunk tokens are finite but meaningless (the
    engine discards them). CPU tensors take the plain version; CUDA
    tensors launch the kernel: with bf16 q the wgmma kernel at page sizes
    8, 16, 32 and multiples of 64, the mma.sync kernel at any other (a
    shape rule, `prefill_kernel`, that the C entry point holds too); with
    fp32 q the FMA kernel. Every one counts in the same counter."""
    quant = _quantized(k_pool, v_pool, k_scale, v_scale)
    B, C, H, K = q.shape
    ps = _check_shapes(q, k_pool, v_pool, H, K)
    n_pg = tables.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(K)
    if q.device.type == "cpu":
        return reference_paged_prefill_attention(
            q, k_pool, v_pool, tables, offsets, lengths, sm_scale=sm_scale,
            k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    tables, offsets, lengths = _cuda_operands(
        q, k_pool, v_pool,
        (("tables", tables), ("offsets", offsets), ("lengths", lengths)),
        quant)
    if K not in _HEAD_DIMS:
        raise ValueError(f"prefill kernel takes head_dim in "
                         f"{_HEAD_DIMS}, got {K}")
    out = torch.empty_like(q)
    if B == 0 or C == 0 or n_pg == 0:
        return out.zero_()
    from ray_tpu_torch.ops import _build

    lib = _build.library()
    if lib.rtt_paged_prefill_smem_bytes(
            _DTYPE_CODES[q.dtype], int(quant), K, ps) > _MAX_SMEM_BYTES:
        raise ValueError(f"page_size {ps} too large for the prefill kernel "
                         f"at head_dim {K}")
    maps = None
    if prefill_kernel(q.dtype, K, ps) == "wgmma":
        maps = _c_array(prefill_plan(q, k_pool, v_pool))
    common = (tables.data_ptr(), offsets.data_ptr(), lengths.data_ptr(),
              out.data_ptr(), B, C, H, K, ps, n_pg, float(sm_scale),
              _addr(maps), _stream_ptr(q.device))
    if quant:
        ks, vs = _scale_operands(q.device, k_scale, v_scale)
        rc = lib.rtt_paged_prefill_attention_int8(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), ks.data_ptr(), vs.data_ptr(), *common)
        _build.check(rc, "paged_prefill_attention int8 kernel launch")
        paged_prefill_attention.int8_launches += 1
    else:
        rc = lib.rtt_paged_prefill_attention(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), *common)
        _build.check(rc, "paged_prefill_attention kernel launch")
        paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0
paged_prefill_attention.int8_launches = 0


def reset_launch_counts() -> None:
    """Zero both wrappers' launch counters, float and int8."""
    for fn in (paged_attention, paged_prefill_attention):
        fn.launches = 0
        fn.int8_launches = 0


def _gather_timeline(k_pool, v_pool, tables, k_scale=None, v_scale=None):
    """Each slot's contiguous [B, T, H, K] timeline, T = n_pg · ps; an
    int8 pool's pages dequantized in fp32 (``page.float() * scale[page
    id]``)."""
    B, n_pg = tables.shape
    _P, ps, H, K = k_pool.shape
    idx = tables.long()
    k_view, v_view = k_pool[idx], v_pool[idx]          # [B, n_pg, ps, H, K]
    if k_scale is not None:
        k_view = k_view.float() * k_scale[idx].float()[..., None, None, None]
        v_view = v_view.float() * v_scale[idx].float()[..., None, None, None]
    return (k_view.reshape(B, n_pg * ps, H, K),
            v_view.reshape(B, n_pg * ps, H, K))


def reference_paged_attention(q, k_pool, v_pool, tables, lengths, *,
                              sm_scale=None, k_scale=None, v_scale=None):
    """Plain version of `paged_attention`: gather each slot's timeline and
    run full-softmax attention. Scores in fp32 from the input-dtype (or
    dequantized fp32) operands; probabilities cast to q.dtype before the
    PV product (as the gather reference does, int8 pools included),
    which then accumulates in fp32. → q.dtype."""
    _quantized(k_pool, v_pool, k_scale, v_scale)
    B, H, K = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(K)
    k_view, v_view = _gather_timeline(k_pool, v_pool, tables, k_scale,
                                      v_scale)
    T = k_view.shape[1]
    s = torch.einsum("bhk,bthk->bht", q.float(), k_view.float()) * sm_scale
    mask = (torch.arange(T, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])                     # [B, T]
    s = torch.where(mask[:, None, :], s, torch.full_like(s, NEG_INF))
    probs = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bht,bthk->bhk", probs.float(),
                        v_view.float()).to(q.dtype)


def reference_paged_prefill_attention(q, k_pool, v_pool, tables, offsets,
                                      lengths, *, sm_scale=None,
                                      k_scale=None, v_scale=None):
    """Plain version of `paged_prefill_attention`: gather each slot's
    timeline (T = tables.shape[1] · ps, so a width-sliced table shrinks
    the work the same way it shrinks the kernel's) and run causal
    attention for the C-query chunk at its offset, with the roundings of
    `reference_paged_attention`. → q.dtype.

    A slot with ``lengths[b] == 0`` (an inert row at offset 0) has no
    valid position: here it gets the uniform average of its V rows, from
    the kernel zeros (its l == 0 guard), exactly as the JAX reference and
    Pallas kernel differ. Callers discard such rows."""
    _quantized(k_pool, v_pool, k_scale, v_scale)
    B, C, H, K = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(K)
    k_view, v_view = _gather_timeline(k_pool, v_pool, tables, k_scale,
                                      v_scale)
    T = k_view.shape[1]
    s = torch.einsum("bchk,bthk->bhct", q.float(), k_view.float()) * sm_scale
    tpos = torch.arange(T, device=q.device)
    qpos = (offsets.to(q.device)[:, None]
            + torch.arange(C, device=q.device)[None, :])          # [B, C]
    mask = ((tpos[None, None, :] <= qpos[:, :, None])
            & (tpos[None, None, :] < lengths.to(q.device)[:, None, None]))
    s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
    probs = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhct,bthk->bchk", probs.float(),
                        v_view.float()).to(q.dtype)


__all__ = [
    "paged_attention", "paged_prefill_attention",
    "reference_paged_attention", "reference_paged_prefill_attention",
    "reset_launch_counts", "NEG_INF", "prefill_kernel", "prefill_plan",
    "tensor_map", "key_tile", "column_boxes", "wgmma_page_size",
    "decode_splits", "decode_live_splits", "decode_split_positions",
    "decode_stage_rows",
]
