"""Ragged paged attention: CUDA kernels for Hopper and their plain versions.

Counterpart of ``ray_tpu/ops/paged_attention.py``. Two kernels, written
by hand in CUDA C++ for sm_90a (sources in ``ops/csrc/``, built by
``ops/_build.py`` at first use and called through ctypes):

- `paged_attention`: single-query decode attention straight against one
  layer's page pool (replaces the Pallas `_decode_kernel`);
- `paged_prefill_attention`: a C-query chunk at an arbitrary offset,
  causal within the chunk (replaces the Pallas `_prefill_kernel`).

Beside each sits its plain PyTorch version (`reference_paged_attention`,
`reference_paged_prefill_attention`): it reconstitutes each slot's
contiguous timeline and runs full-softmax attention — the kernels'
oracle and the engine's ``attn_impl="gather"`` path.

Dispatch is by the device of the tensors, nothing else: a CPU tensor
goes to the plain version, a CUDA tensor to the kernel (which raises on
a shape or dtype it does not take). There is no fallback from a failed
launch. Each wrapper counts its kernel launches in a plain integer
attribute (``paged_attention.launches``), so a run can show that its
main path went through the kernels.

Layouts are the JAX package's: pool ``[P+1, ps, H, K]`` (one layer; row
0 is the null page), q ``[B, H, K]`` for decode and ``[B, C, H, K]``
for prefill, tables ``[B, n_pg]`` int32 (``n_pg`` may be a width-sliced
view: every loop bound comes from ``tables.shape[1]``).
"""

from __future__ import annotations

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


def _no_int8(k_scale, v_scale):
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError("int8 pools not yet ported")


def _cuda_operands(q, k_pool, v_pool, index_arrays):
    """Validate the kernel's operands: one CUDA device, float32/bfloat16
    q and pools of the same dtype, contiguous and 16-byte aligned (the
    kernels read rows in 16-byte vectors). Index arrays become contiguous
    int32 on that device (a no-op when they already are)."""
    dev = q.device
    check_device(dev, k_pool=k_pool, v_pool=v_pool, **dict(index_arrays))
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"kernel takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return [t.to(torch.int32).contiguous() for _name, t in index_arrays]


def _stream_ptr(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def paged_attention(q, k_pool, v_pool, tables, lengths, *, sm_scale=None,
                    k_scale=None, v_scale=None):
    """Single-token decode attention straight against the KV page pool.

    q: [B, H, K] (post-rotary); k_pool, v_pool: [P+1, ps, H, K] one
    layer's pool; tables: [B, n_pg] int page ids (unallocated tail = 0);
    lengths: [B] valid kv positions per slot (the current token's K/V
    already written). → [B, H, K] in q.dtype. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    _no_int8(k_scale, v_scale)
    B, H, K = q.shape
    ps = _check_shapes(q, k_pool, v_pool, H, K)
    n_pg = tables.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(K)
    if q.device.type == "cpu":
        return reference_paged_attention(q, k_pool, v_pool, tables, lengths,
                                         sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    tables, lengths = _cuda_operands(
        q, k_pool, v_pool, (("tables", tables), ("lengths", lengths)))
    if K not in _HEAD_DIMS:
        raise ValueError(f"decode kernel takes head_dim in "
                         f"{_HEAD_DIMS}, got {K}")
    out = torch.empty_like(q)
    if B == 0 or n_pg == 0:
        return out.zero_()
    from ray_tpu_torch.ops import _build

    lib = _build.library()
    rc = lib.rtt_paged_decode_attention(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, H, K, ps, n_pg, float(sm_scale),
        _stream_ptr(q.device))
    _build.check(rc, "paged_attention kernel launch")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def paged_prefill_attention(q, k_pool, v_pool, tables, offsets, lengths, *,
                            sm_scale=None, k_scale=None, v_scale=None):
    """Chunked-prefill attention straight against the KV page pool.

    q: [B, C, H, K] — each slot's chunk of C queries starting at absolute
    position ``offsets[b]``; tables: [B, n_pg] (may be a width-sliced
    view); lengths: [B] valid kv positions (offset + valid chunk tokens,
    <= n_pg * page_size). → [B, C, H, K] in q.dtype; rows past a slot's
    valid chunk tokens are finite but meaningless (the engine discards
    them). CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    _no_int8(k_scale, v_scale)
    B, C, H, K = q.shape
    ps = _check_shapes(q, k_pool, v_pool, H, K)
    n_pg = tables.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(K)
    if q.device.type == "cpu":
        return reference_paged_prefill_attention(
            q, k_pool, v_pool, tables, offsets, lengths, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    tables, offsets, lengths = _cuda_operands(
        q, k_pool, v_pool,
        (("tables", tables), ("offsets", offsets), ("lengths", lengths)))
    if K not in _HEAD_DIMS:
        raise ValueError(f"prefill kernel takes head_dim in "
                         f"{_HEAD_DIMS}, got {K}")
    out = torch.empty_like(q)
    if B == 0 or C == 0 or n_pg == 0:
        return out.zero_()
    from ray_tpu_torch.ops import _build

    lib = _build.library()
    if lib.rtt_paged_prefill_smem_bytes(
            _DTYPE_CODES[q.dtype], K, ps) > _MAX_SMEM_BYTES:
        raise ValueError(f"page_size {ps} too large for the prefill kernel "
                         f"at head_dim {K}")
    rc = lib.rtt_paged_prefill_attention(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), tables.data_ptr(), offsets.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, C, H, K, ps, n_pg,
        float(sm_scale), _stream_ptr(q.device))
    _build.check(rc, "paged_prefill_attention kernel launch")
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0


def reset_launch_counts() -> None:
    """Zero both wrappers' launch counters."""
    paged_attention.launches = 0
    paged_prefill_attention.launches = 0


def _gather_timeline(k_pool, v_pool, tables):
    """Each slot's contiguous [B, T, H, K] timeline, T = n_pg · ps."""
    B, n_pg = tables.shape
    _P, ps, H, K = k_pool.shape
    idx = tables.long()
    return (k_pool[idx].reshape(B, n_pg * ps, H, K),
            v_pool[idx].reshape(B, n_pg * ps, H, K))


def reference_paged_attention(q, k_pool, v_pool, tables, lengths, *,
                              sm_scale=None, k_scale=None, v_scale=None):
    """Plain version of `paged_attention`: gather each slot's timeline and
    run full-softmax attention. Scores in fp32 from the input-dtype
    operands; probabilities cast to q.dtype before the PV product (as
    the reference does), which then accumulates in fp32. → q.dtype."""
    _no_int8(k_scale, v_scale)
    B, H, K = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(K)
    k_view, v_view = _gather_timeline(k_pool, v_pool, tables)
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
    attention for the C-query chunk at its offset. → q.dtype.

    A slot with ``lengths[b] == 0`` (an inert row at offset 0) has no
    valid position: here it gets the uniform average of its V rows, from
    the kernel zeros (its l == 0 guard), exactly as the JAX reference and
    Pallas kernel differ. Callers discard such rows."""
    _no_int8(k_scale, v_scale)
    B, C, H, K = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(K)
    k_view, v_view = _gather_timeline(k_pool, v_pool, tables)
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
    "reset_launch_counts", "NEG_INF",
]
