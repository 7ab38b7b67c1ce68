"""Flash attention: CUDA kernels for Hopper and their plain versions.

Counterpart of ``ray_tpu/ops/attention.py``. Four kernels, written by
hand in CUDA C++ for sm_90a (sources in ``ops/csrc/flash_fwd.cu``,
``ops/csrc/flash_delta.cu`` and ``ops/csrc/flash_bwd.cu``, built by
``ops/_build.py`` at first use and called through ctypes):

- `flash_fwd`: blockwise attention → (o, lse) (replaces the Pallas
  `_fwd_kernel`);
- `flash_delta`: the backward's row term rowsum(dO·O) - dlse (replaces
  no Pallas kernel: the jnp ops of `_bwd_impl` that XLA fuses);
- `flash_dq`: dq = Σ_kv ds·K (replaces `_dq_kernel`);
- `flash_dkv`: dk = Σ_q dsᵀ·Q and dv = Σ_q pᵀ·dO (replaces `_dkv_kernel`).

`flash_attention` is the public op: a ``torch.autograd.Function`` over
them whose backward differentiates both o and lse. An incoming lse
cotangent is folded into ``delta = rowsum(dO·O) - dlse`` (as the JAX
``_bwd_impl`` does), so a ring-attention combine can differentiate
through lse.

Beside each kernel sits its plain PyTorch version (`reference_flash_fwd`,
`reference_flash_delta`, `reference_flash_dq`, `reference_flash_dkv`;
`reference_flash_bwd` composes the last three): each follows its kernel's
roundings step by step (scores in fp32 from input-dtype operands,
probabilities rounded to the input dtype before P·V and l summed
unrounded, ds rounded before ds·K and dsᵀ·Q, p rounded before pᵀ·dO), so
the kernel is held against its own plain version on the card. `reference_attention` is the twin of the JAX
oracle of the same name.

Dispatch is by the device of the tensors, nothing else: a CPU tensor goes
to the plain version, a CUDA tensor to the kernel (which raises on a
dtype or head dim it does not take). There is no fallback from a failed
launch. Each kernel wrapper counts its launches in a plain integer
attribute (``flash_fwd.launches``, ...).

Layouts are the JAX package's at the API: q ``[B, S, H, K]``, k and v
``[B, T, H, K]``, lse ``[B, S, H]`` fp32. The kernels read and write any
layout whose head dim is contiguous and whose rows are 16-byte aligned
(the ``_proj`` outputs of the model are), and each gradient comes back
with its input's strides. The mask is aligned at the top left: row s
sees key t when t < T and, if causal, s >= t. A row with no visible key
gets o = 0 and lse = -1e30.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ray_tpu_torch._device import check_device
from ray_tpu_torch.ops.paged_attention import (  # shared with the paged kernels
    _DTYPE_CODES, _HEAD_DIMS, BOX_COLS, NEG_INF, ROADMAP_HEAD_DIMS,
    SWIZZLE_BYTES, WGMMA_ROWS, _addr, _c_array, _ptr, _stream_ptr, key_tile,
    tensor_map)

def _scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale


def _visible(S, T, causal, device):
    """[S, T] bool: key t is visible to row s."""
    kpos = torch.arange(T, device=device)[None, :]
    if not causal:
        return torch.ones(S, T, dtype=torch.bool, device=device)
    return torch.arange(S, device=device)[:, None] >= kpos


# ------------------------------------------------------------ plain versions

def reference_attention(q, k, v, *, causal=True, sm_scale=None,
                        return_lse=False):
    """Plain attention with the JAX oracle's semantics (fp32 logits and
    softmax, probabilities cast to q.dtype before the PV product)."""
    sm_scale = _scale(q, sm_scale)
    S, T = q.shape[1], k.shape[1]
    logits = torch.einsum("bshk,bthk->bhst", q.float(), k.float()) * sm_scale
    if causal:
        logits = torch.where(_visible(S, T, True, q.device)[None, None],
                             logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    o = torch.einsum("bhst,bthk->bshk", probs, v)
    if return_lse:
        return o, torch.logsumexp(logits, dim=-1).transpose(1, 2)
    return o


def _scores(q, k, causal, sm_scale):
    """fp32 scores [B, H, S, T] of input-dtype operands and the mask."""
    s = torch.einsum("bshk,bthk->bhst", q.float(), k.float()) * sm_scale
    return s, _visible(q.shape[1], k.shape[1], causal, q.device)


def reference_flash_fwd(q, k, v, causal=True, sm_scale=None,
                        with_o32=False):
    """Plain version of `flash_fwd` → (o [B, S, H, K] q.dtype, lse
    [B, S, H] fp32), and with ``with_o32`` o before its rounding to
    q.dtype (fp32) after them. Probabilities relative to the row maximum
    are rounded to v.dtype before P·V; l sums them unrounded. A row with
    no visible key gets o = 0 and lse = -1e30, said explicitly: a softmax
    would give it the mean of V."""
    sm_scale = _scale(q, sm_scale)
    s, mask = _scores(q, k, causal, sm_scale)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = torch.cat([s, s.new_full((*s.shape[:-1], 1), NEG_INF)],
                  dim=-1).amax(dim=-1, keepdim=True)         # T may be 0
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)                          # [B, H, S, 1]
    empty = l == 0
    l_safe = torch.where(empty, torch.ones_like(l), l)
    o32 = torch.einsum("bhst,bthk->bshk", p.to(v.dtype).float(), v.float())
    o32 = (o32 / l_safe.transpose(1, 2)).contiguous()
    lse = torch.where(empty, torch.full_like(l, NEG_INF), m + torch.log(l_safe))
    lse = lse[..., 0].transpose(1, 2).contiguous()
    o = o32.to(q.dtype).contiguous()
    return (o, lse, o32) if with_o32 else (o, lse)


def _p_ds(q, k, v, do, lse, delta, causal, sm_scale):
    """p (fp32) and ds (rounded to q.dtype), both [B, H, S, T]."""
    s, mask = _scores(q, k, causal, sm_scale)
    row = lambda x: x.float().transpose(1, 2)[..., None]     # [B, H, S, 1]
    p = torch.where(mask, torch.exp(s - row(lse)), torch.zeros_like(s))
    dp = torch.einsum("bshk,bthk->bhst", do.float(), v.float())
    ds = (p * (dp - row(delta)) * sm_scale).to(q.dtype)
    return p, ds


def reference_flash_dq(q, k, v, do, lse, delta, causal=True, sm_scale=None):
    """Plain version of `flash_dq`: dq = ds·K in fp32, → q.dtype."""
    sm_scale = _scale(q, sm_scale)
    _p, ds = _p_ds(q, k, v, do, lse, delta, causal, sm_scale)
    return torch.einsum("bhst,bthk->bshk", ds.float(),
                        k.float()).to(q.dtype).contiguous()


def reference_flash_dkv(q, k, v, do, lse, delta, causal=True, sm_scale=None):
    """Plain version of `flash_dkv` → (dk = dsᵀ·Q, dv = round(p)ᵀ·dO),
    fp32 sums rounded to k's and v's dtype."""
    sm_scale = _scale(q, sm_scale)
    p, ds = _p_ds(q, k, v, do, lse, delta, causal, sm_scale)
    dk = torch.einsum("bhst,bshk->bthk", ds.float(), q.float()).to(k.dtype)
    dv = torch.einsum("bhst,bshk->bthk", p.to(do.dtype).float(),
                      do.float()).to(v.dtype)
    return dk.contiguous(), dv.contiguous()


def reference_flash_delta(o, do, dlse=None):
    """Plain version of `flash_delta`: rowsum(float(dO)·float(O)) - dlse,
    fp32 [B, S, H], with torch ops as the JAX package computes it outside
    its kernels."""
    delta = (do.float() * o.float()).sum(dim=-1)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


def reference_flash_bwd(q, k, v, o, lse, do, dlse, causal=True,
                        sm_scale=None):
    """Plain backward → (dq, dk, dv), the twin of the JAX `_bwd_impl`."""
    delta = reference_flash_delta(o, do, dlse)
    dq = reference_flash_dq(q, k, v, do, lse, delta, causal, sm_scale)
    return (dq, *reference_flash_dkv(q, k, v, do, lse, delta, causal,
                                     sm_scale))


# ----------------------------------------------------------------- kernels

def _check_shapes(q, k, v):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or (
            q.shape[0], q.shape[2], q.shape[3]) != (
            k.shape[0], k.shape[2], k.shape[3]):
        raise ValueError(f"flash attention takes q [B, S, H, K] and k, v "
                         f"[B, T, H, K]; got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")


def _aligned(t) -> bool:
    """Head dim contiguous and every row start 16-byte aligned."""
    step = 16 // t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(t.stride(i) % step == 0 for i in range(3)))


def _kernel_operands(q, *others, kernel="flash_fwd"):
    """Validate the kernels' operands: one CUDA device, float32/bfloat16
    of one dtype, a head dim of 64, 80, 128 or 256. A tensor whose rows
    are not 16-byte aligned (or whose head dim is strided) is copied to a
    contiguous one; every other layout is read in place."""
    check_device(q.device, **{f"operand{i}": t for i, t in enumerate(others)})
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    for t in others:
        if t.dtype != q.dtype:
            raise ValueError(f"operand dtype {t.dtype} != q dtype {q.dtype}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"{kernel} takes head_dim in {_HEAD_DIMS}, got head "
                         f"dim {q.shape[-1]} ({ROADMAP_HEAD_DIMS})")
    return [t if _aligned(t) else t.contiguous() for t in (q, *others)]


def _rows(*tensors):
    """The (b, s, h) element strides of each tensor, as a C array."""
    vals = [t.stride(i) for t in tensors for i in range(3)]
    return (ctypes.c_longlong * len(vals))(*vals)


def _on_cuda(q):
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return True


def _row_vectors(q, *vecs):
    """lse / delta as contiguous fp32 [B, S, H] on q's device."""
    B, S, H = q.shape[:3]
    out = []
    for x in vecs:
        if x.shape != (B, S, H):
            raise ValueError(f"row vector {tuple(x.shape)} != {(B, S, H)}")
        check_device(q.device, row=x)
        out.append(x.to(torch.float32).contiguous())
    return out


# Keys per work item of the dkv kernel (two warpgroups of 64; at head dim
# 256 both share 64 and split the head dim) and query rows per tile it
# walks: flash_bwd.cu's DKV_KEYS, DKV_KEYS_SPLIT and DKV_ROWS, whose
# launcher refuses maps with other box rows.
DKV_KEYS = 128
DKV_KEYS_SPLIT = 64
DKV_ROWS = 64


def dkv_keys(K: int) -> int:
    """Keys per work item of the bf16 dkv kernel at head dim K."""
    return DKV_KEYS_SPLIT if K == 256 else DKV_KEYS


def dq_key_tile(K: int) -> int:
    """Keys per tile of the bf16 dq kernel: `key_tile` (64 at head dim 256,
    where each ring slot holds one K or one V tile: flash_bwd.cu
    `DqCfg`)."""
    return key_tile(K)


def _maps(*views):
    """tensor_map of each (view, rows per box) in 64-column swizzled boxes
    (`column_boxes` of them a row; at head dim 80 the second box's columns
    past 80 arrive as zeros)."""
    return [w for t, rows in views
            for w in tensor_map(t, (1, rows, 1, BOX_COLS), SWIZZLE_BYTES)]


def flash_plan(q, k, v):
    """The flash forward kernel's tensor maps, read in place from the
    views (their own strides; the rows of a [B, S, 3, H, K] qkv
    projection's q, k and v are 16-byte aligned): q in boxes of 128 rows,
    k and v in boxes of `key_tile` rows, each 64 columns wide (a head dim
    of 80 or 128 is two column boxes, 256 four). bf16 only: fp32 takes the
    FMA kernel and
    no map. → a flat list of 3 x TMAP_WORDS."""
    kt = key_tile(q.shape[-1])
    return _maps((q, WGMMA_ROWS), (k, kt), (v, kt))


def flash_dq_plan(q, k, v, do):
    """The bf16 dq kernel's tensor maps (query-major: an item is 128 rows):
    q and dO in boxes of 128 rows, k and v in boxes of `dq_key_tile` rows,
    each read in place with its own strides. → 4 x TMAP_WORDS (q, k, v,
    dO). lse and delta are not mapped: the kernel reads them from the
    contiguous fp32 [B, S, H] rows `_row_vectors` gives it."""
    kt = dq_key_tile(q.shape[-1])
    return _maps((q, WGMMA_ROWS), (k, kt), (v, kt), (do, WGMMA_ROWS))


def flash_dkv_plan(q, k, v, do):
    """The bf16 dkv kernel's tensor maps (key-major: an item is
    `dkv_keys` keys, the walked tiles DKV_ROWS query rows): k and v in
    boxes of `dkv_keys` rows, q and dO in boxes of DKV_ROWS. → 4 x
    TMAP_WORDS (q, k, v, dO). The lse and delta rows of each walked tile
    are staged by the kernel from the [B, S, H] rows: a box of one head's
    rows would be 4·H bytes apart, which TMA cannot read as a box."""
    keys = dkv_keys(q.shape[-1])
    return _maps((q, DKV_ROWS), (k, keys), (v, keys), (do, DKV_ROWS))


def flash_fwd(q, k, v, causal=True, sm_scale=None, with_o32=False):
    """Flash forward → (o [B, S, H, K] in q.dtype with q's layout, lse
    [B, S, H] fp32), and with ``with_o32`` o unrounded in fp32 after them
    (the bf16 kernel writes it beside o; fp32 o is unrounded already).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16: wgmma on TMA-fed tiles, `flash_plan`; fp32: FMA)."""
    _check_shapes(q, k, v)
    sm_scale = _scale(q, sm_scale)
    if not _on_cuda(q):
        return reference_flash_fwd(q, k, v, causal, sm_scale, with_o32)
    q, k, v = _kernel_operands(q, k, v)
    B, S, H, K = q.shape
    T = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty(B, S, H, device=q.device, dtype=torch.float32)
    o32 = None
    if with_o32 and q.dtype != torch.float32:
        o32 = torch.empty_like(o, dtype=torch.float32)   # o's strides
    from ray_tpu_torch.ops import _build

    lib = _build.library()
    rows = _rows(q, k, v, o)
    maps = (_c_array(flash_plan(q, k, v)) if q.dtype == torch.bfloat16
            else None)
    rc = lib.rtt_flash_fwd(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), _ptr(o32), B, S, T, H, K,
        ctypes.addressof(rows), int(bool(causal)), float(sm_scale),
        _addr(maps), _stream_ptr(q.device))
    _build.check(rc, "flash_fwd kernel launch")
    flash_fwd.launches += 1
    if with_o32:
        return o, lse, o if o32 is None else o32
    return o, lse


flash_fwd.launches = 0


def flash_dq(q, k, v, do, lse, delta, causal=True, sm_scale=None):
    """dq from the saved lse and the row term delta ([B, S, H] fp32) →
    [B, S, H, K] in q.dtype with q's layout. CPU tensors take the plain
    version; CUDA tensors launch the kernel (bf16: wgmma on TMA-fed
    tiles, `flash_dq_plan`; fp32: FMA)."""
    _check_shapes(q, k, v)
    sm_scale = _scale(q, sm_scale)
    if not _on_cuda(q):
        return reference_flash_dq(q, k, v, do, lse, delta, causal, sm_scale)
    q, k, v, do = _kernel_operands(q, k, v, do, kernel="flash_dq")
    lse, delta = _row_vectors(q, lse, delta)
    B, S, H, K = q.shape
    T = k.shape[1]
    dq = torch.empty_like(q)
    from ray_tpu_torch.ops import _build

    lib = _build.library()
    rows = _rows(q, k, v, do, dq)
    maps = (_c_array(flash_dq_plan(q, k, v, do))
            if q.dtype == torch.bfloat16 else None)
    rc = lib.rtt_flash_dq(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        B, S, T, H, K, ctypes.addressof(rows), int(bool(causal)),
        float(sm_scale), _addr(maps), _stream_ptr(q.device))
    _build.check(rc, "flash_dq kernel launch")
    flash_dq.launches += 1
    return dq


flash_dq.launches = 0


def flash_dkv(q, k, v, do, lse, delta, causal=True, sm_scale=None):
    """(dk, dv) from the saved lse and the row term delta → each
    [B, T, H, K] with its input's dtype and layout. CPU tensors take the
    plain version; CUDA tensors launch the kernel (bf16: wgmma on
    TMA-fed tiles, `flash_dkv_plan`; fp32: FMA)."""
    _check_shapes(q, k, v)
    sm_scale = _scale(q, sm_scale)
    if not _on_cuda(q):
        return reference_flash_dkv(q, k, v, do, lse, delta, causal, sm_scale)
    q, k, v, do = _kernel_operands(q, k, v, do, kernel="flash_dkv")
    lse, delta = _row_vectors(q, lse, delta)
    B, S, H, K = q.shape
    T = k.shape[1]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    from ray_tpu_torch.ops import _build

    lib = _build.library()
    rows = _rows(q, k, v, do, dk, dv)
    maps = (_c_array(flash_dkv_plan(q, k, v, do))
            if q.dtype == torch.bfloat16 else None)
    rc = lib.rtt_flash_dkv(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, S, T, H, K, ctypes.addressof(rows),
        int(bool(causal)), float(sm_scale), _addr(maps),
        _stream_ptr(q.device))
    _build.check(rc, "flash_dkv kernel launch")
    flash_dkv.launches += 1
    return dk, dv


flash_dkv.launches = 0


# Element types the delta kernel reads, as (dO, O): the bf16 path, the
# head-dim-256 path (O32_HEAD_DIMS: the forward's fp32 o), and fp32.
_DELTA_DTYPES = ((torch.bfloat16, torch.bfloat16),
                 (torch.bfloat16, torch.float32),
                 (torch.float32, torch.float32))


def flash_delta(o, do, dlse=None):
    """delta = rowsum(float(dO)·float(O)) - dlse → fp32 [B, S, H],
    contiguous: the row term of both backward kernels. CPU tensors take
    the plain version; CUDA tensors launch the kernel
    (``ops/csrc/flash_delta.cu``), which reads dO and O with their own
    strides (rows 16-byte aligned, head dim contiguous; others are copied
    first) and dlse with its own."""
    if o.dim() != 4 or o.shape != do.shape:
        raise ValueError(f"flash_delta takes o and dO of one [B, S, H, K] "
                         f"shape; got {tuple(o.shape)}, {tuple(do.shape)}")
    if not _on_cuda(do):
        return reference_flash_delta(o, do, dlse)
    check_device(do.device, o=o)
    if (do.dtype, o.dtype) not in _DELTA_DTYPES:
        raise ValueError(f"flash_delta takes (dO, O) dtypes in "
                         f"{_DELTA_DTYPES}, got ({do.dtype}, {o.dtype})")
    B, S, H, K = do.shape
    if K % 8:
        raise ValueError(f"flash_delta takes a head dim that is a multiple "
                         f"of 8, got {K}")
    do, o = (t if _aligned(t) else t.contiguous() for t in (do, o))
    if dlse is not None:
        if dlse.shape != (B, S, H):
            raise ValueError(f"dlse {tuple(dlse.shape)} != {(B, S, H)}")
        check_device(do.device, dlse=dlse)
        dlse = dlse.to(torch.float32)
    delta = torch.empty(B, S, H, device=do.device, dtype=torch.float32)
    from ray_tpu_torch.ops import _build

    lib = _build.library()
    rows = _rows(do, o, do if dlse is None else dlse)
    rc = lib.rtt_flash_delta(
        _DTYPE_CODES[do.dtype], _DTYPE_CODES[o.dtype], do.data_ptr(),
        o.data_ptr(), _ptr(dlse), delta.data_ptr(), B, S, H, K,
        ctypes.addressof(rows), _stream_ptr(do.device))
    _build.check(rc, "flash_delta kernel launch")
    flash_delta.launches += 1
    return delta


flash_delta.launches = 0


def flash_bwd(q, k, v, o, lse, do, dlse=None, causal=True, sm_scale=None):
    """(dq, dk, dv) through the three backward kernels (their plain
    versions on CPU tensors); dlse, when given, is folded into delta."""
    delta = flash_delta(o, do, dlse)
    dq = flash_dq(q, k, v, do, lse, delta, causal, sm_scale)
    return (dq, *flash_dkv(q, k, v, do, lse, delta, causal, sm_scale))


def reset_launch_counts() -> None:
    """Zero the four kernels' launch counters."""
    flash_fwd.launches = 0
    flash_delta.launches = 0
    flash_dq.launches = 0
    flash_dkv.launches = 0


# Head dims whose backward reads delta = rowsum(dO · O) from O before its
# rounding (fp32, which the forward writes beside O). The JAX VJP, and the
# port at the other head dims, read the rounded O, whose error reaches
# every key of a row alike: at gptj_6b's 16 heads of 256 that moved the
# worst layer's attention gradients 5.1% from plain attention's, past the
# train limit of 5%, and 4.3% from the unrounded O; two plain paths differ
# by 4.2% there (PERF.md; tools/flash_grad_noise.py). At 64-128 no check
# showed the fault, and the rounded O keeps the reference's numerics.
O32_HEAD_DIMS = (256,)


class _FlashAttention(torch.autograd.Function):
    """(o, lse) = flash_fwd(q, k, v); backward through flash_bwd with
    both cotangents (``None`` for one the caller did not use). delta
    reads o32 at O32_HEAD_DIMS, o elsewhere."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o32 = (any(ctx.needs_input_grad[:3])
               and q.shape[-1] in O32_HEAD_DIMS)
        o, lse, *rest = flash_fwd(q, k, v, causal, sm_scale, with_o32=o32)
        ctx.save_for_backward(q, k, v, rest[0] if o32 else o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        if do is None and dlse is None:
            return None, None, None, None, None
        q, k, v, o, lse = ctx.saved_tensors   # o: fp32 at O32_HEAD_DIMS
        if do is None:
            do = torch.zeros_like(q)
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, dlse, ctx.causal,
                               ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal=True, sm_scale=None,
                    return_lse=False):
    """Blockwise flash attention, differentiable in q, k, v (and through
    lse when it is returned).

    q: [B, S, H, K]; k, v: [B, T, H, K]; causal: row s attends keys t <= s.
    → o [B, S, H, K] (q.dtype), or (o, lse [B, S, H] fp32)."""
    _check_shapes(q, k, v)
    o, lse = _FlashAttention.apply(q, k, v, bool(causal),
                                   float(_scale(q, sm_scale)))
    return (o, lse) if return_lse else o


__all__ = [
    "flash_attention", "flash_fwd", "flash_dq", "flash_dkv", "flash_bwd",
    "O32_HEAD_DIMS", "flash_plan", "flash_dq_plan", "flash_dkv_plan", "dq_key_tile",
    "dkv_keys",
    "flash_delta", "reference_attention", "reference_flash_fwd",
    "reference_flash_delta",
    "reference_flash_dq", "reference_flash_dkv", "reference_flash_bwd",
    "reset_launch_counts", "NEG_INF",
]
