"""Flash attention: CUDA kernels for Hopper and their plain versions.

Counterpart of ``ray_tpu/ops/attention.py``. Three kernels, written by
hand in CUDA C++ for sm_90a (sources in ``ops/csrc/flash_fwd.cu`` and
``ops/csrc/flash_bwd.cu``, built by ``ops/_build.py`` at first use and
called through ctypes):

- `flash_fwd`: blockwise attention → (o, lse) (replaces the Pallas
  `_fwd_kernel`);
- `flash_dq`: dq = Σ_kv ds·K (replaces `_dq_kernel`);
- `flash_dkv`: dk = Σ_q dsᵀ·Q and dv = Σ_q pᵀ·dO (replaces `_dkv_kernel`).

`flash_attention` is the public op: a ``torch.autograd.Function`` over
them whose backward differentiates both o and lse. An incoming lse
cotangent is folded into ``delta = rowsum(dO·O) - dlse`` (as the JAX
``_bwd_impl`` does), so a ring-attention combine can differentiate
through lse.

Beside each kernel sits its plain PyTorch version (`reference_flash_fwd`,
`reference_flash_dq`, `reference_flash_dkv`; `reference_flash_bwd`
composes the last two): each follows its kernel's roundings step by step
(scores in fp32 from input-dtype operands, probabilities rounded to the
input dtype before P·V and l summed unrounded, ds rounded before ds·K and
dsᵀ·Q, p rounded before pᵀ·dO), so the kernel is held against its own
plain version on the card. `reference_attention` is the twin of the JAX
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
    _DTYPE_CODES, _HEAD_DIMS, NEG_INF, SWIZZLE_BYTES, WGMMA_ROWS, _addr,
    _c_array, _stream_ptr, column_boxes, key_tile, tensor_map)


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


def reference_flash_fwd(q, k, v, causal=True, sm_scale=None):
    """Plain version of `flash_fwd` → (o [B, S, H, K] q.dtype, lse
    [B, S, H] fp32). Probabilities relative to the row maximum are
    rounded to v.dtype before P·V; l sums them unrounded. A row with no
    visible key gets o = 0 and lse = -1e30, said explicitly: a softmax
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
    o = torch.einsum("bhst,bthk->bshk", p.to(v.dtype).float(), v.float())
    o = (o / l_safe.transpose(1, 2)).to(q.dtype).contiguous()
    lse = torch.where(empty, torch.full_like(l, NEG_INF), m + torch.log(l_safe))
    return o, lse[..., 0].transpose(1, 2).contiguous()


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


def flash_delta(o, do, dlse=None):
    """delta = rowsum(float(dO)·float(O)) - dlse, fp32 [B, S, H]: the row
    term of both backward kernels, computed with torch ops as the JAX
    package computes it outside its kernels."""
    delta = (do.float() * o.float()).sum(dim=-1)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


def reference_flash_bwd(q, k, v, o, lse, do, dlse, causal=True,
                        sm_scale=None):
    """Plain backward → (dq, dk, dv), the twin of the JAX `_bwd_impl`."""
    delta = flash_delta(o, do, dlse)
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


def _kernel_operands(q, *others):
    """Validate the kernels' operands: one CUDA device, float32/bfloat16
    of one dtype, head dim 64 or 128. A tensor whose rows are not 16-byte
    aligned (or whose head dim is strided) is copied to a contiguous one;
    every other layout is read in place."""
    check_device(q.device, **{f"operand{i}": t for i, t in enumerate(others)})
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    for t in others:
        if t.dtype != q.dtype:
            raise ValueError(f"operand dtype {t.dtype} != q dtype {q.dtype}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"flash kernels take head_dim in {_HEAD_DIMS}, got "
                         f"{q.shape[-1]}")
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


# Keys per work item of the dkv kernel (two warpgroups of 64) and query rows
# per tile it walks: flash_bwd.cu's DKV_KEYS and DKV_ROWS, whose launcher
# refuses maps with other box rows.
DKV_KEYS = 128
DKV_ROWS = 64


def _maps(K, *views):
    """tensor_map of each (view, rows per box) in 64-column swizzled boxes."""
    cols = K // column_boxes(K)
    return [w for t, rows in views
            for w in tensor_map(t, (1, rows, 1, cols), SWIZZLE_BYTES)]


def flash_plan(q, k, v):
    """The flash forward kernel's tensor maps, read in place from the
    views (their own strides; the rows of a [B, S, 3, H, K] qkv
    projection's q, k and v are 16-byte aligned): q in boxes of 128 rows,
    k and v in boxes of `key_tile` rows, each 64 columns wide (a head dim
    of 128 is two column boxes). bf16 only: fp32 takes the FMA kernel and
    no map. → a flat list of 3 x TMAP_WORDS."""
    K = q.shape[-1]
    kt = key_tile(K)
    return _maps(K, (q, WGMMA_ROWS), (k, kt), (v, kt))


def flash_dq_plan(q, k, v, do):
    """The bf16 dq kernel's tensor maps (query-major: an item is 128 rows):
    q and dO in boxes of 128 rows, k and v in boxes of `key_tile` rows,
    each read in place with its own strides. → 4 x TMAP_WORDS (q, k, v,
    dO). lse and delta are not mapped: the kernel reads them from the
    contiguous fp32 [B, S, H] rows `_row_vectors` gives it."""
    K = q.shape[-1]
    kt = key_tile(K)
    return _maps(K, (q, WGMMA_ROWS), (k, kt), (v, kt), (do, WGMMA_ROWS))


def flash_dkv_plan(q, k, v, do):
    """The bf16 dkv kernel's tensor maps (key-major: an item is DKV_KEYS
    keys, the walked tiles DKV_ROWS query rows): k and v in boxes of
    DKV_KEYS rows, q and dO in boxes of DKV_ROWS. → 4 x TMAP_WORDS (q, k,
    v, dO). The lse and delta rows of each walked tile are staged by the
    kernel from the [B, S, H] rows: a box of one head's rows would be
    4·H bytes apart, which TMA cannot read as a box."""
    K = q.shape[-1]
    return _maps(K, (q, DKV_ROWS), (k, DKV_KEYS), (v, DKV_KEYS),
                 (do, DKV_ROWS))


def flash_fwd(q, k, v, causal=True, sm_scale=None):
    """Flash forward → (o [B, S, H, K] in q.dtype with q's layout, lse
    [B, S, H] fp32). CPU tensors take the plain version; CUDA tensors
    launch the kernel (bf16: wgmma on TMA-fed tiles, `flash_plan`; fp32:
    FMA)."""
    _check_shapes(q, k, v)
    sm_scale = _scale(q, sm_scale)
    if not _on_cuda(q):
        return reference_flash_fwd(q, k, v, causal, sm_scale)
    q, k, v = _kernel_operands(q, k, v)
    B, S, H, K = q.shape
    T = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty(B, S, H, device=q.device, dtype=torch.float32)
    from ray_tpu_torch.ops import _build

    lib = _build.library()
    rows = _rows(q, k, v, o)
    maps = (_c_array(flash_plan(q, k, v)) if q.dtype == torch.bfloat16
            else None)
    rc = lib.rtt_flash_fwd(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), B, S, T, H, K, ctypes.addressof(rows),
        int(bool(causal)), float(sm_scale), _addr(maps),
        _stream_ptr(q.device))
    _build.check(rc, "flash_fwd kernel launch")
    flash_fwd.launches += 1
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
    q, k, v, do = _kernel_operands(q, k, v, do)
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
    q, k, v, do = _kernel_operands(q, k, v, do)
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


def flash_bwd(q, k, v, o, lse, do, dlse=None, causal=True, sm_scale=None):
    """(dq, dk, dv) through the two backward kernels (their plain
    versions on CPU tensors); dlse, when given, is folded into delta."""
    delta = flash_delta(o, do, dlse)
    dq = flash_dq(q, k, v, do, lse, delta, causal, sm_scale)
    return (dq, *flash_dkv(q, k, v, do, lse, delta, causal, sm_scale))


def reset_launch_counts() -> None:
    """Zero the three kernels' launch counters."""
    flash_fwd.launches = 0
    flash_dq.launches = 0
    flash_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """(o, lse) = flash_fwd(q, k, v); backward through flash_bwd with
    both cotangents (``None`` for one the caller did not use)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, lse = flash_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        if do is None and dlse is None:
            return None, None, None, None, None
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
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
    "flash_plan", "flash_dq_plan", "flash_dkv_plan",
    "flash_delta", "reference_attention", "reference_flash_fwd",
    "reference_flash_dq", "reference_flash_dkv", "reference_flash_bwd",
    "reset_launch_counts", "NEG_INF",
]
