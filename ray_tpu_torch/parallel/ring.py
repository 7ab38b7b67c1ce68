"""Ring attention: sequence parallelism over an ``sp`` mesh (PyTorch).

Counterpart of ``ray_tpu/parallel/ring.py`` (`_combine`,
`ring_attention`, `ring_attention_sharded`). The sequence is split into
contiguous chunks, one per shard; shard i holds query chunk i and
attends to every key/value chunk in turn, and the per-chunk partial
results merge with the (o, lse) log-sum-exp combine. Each partial comes
from the flash kernels (``impl="flash"``: ``ops/attention.py``, the CUDA
kernels on CUDA tensors and their plain versions on CPU tensors) or from
plain attention (``impl="xla"``).

The port is single-controller, as its tensor-parallel engine is: the
mesh is a list of devices (`make_sp_mesh`; a device may repeat) and one
process runs every shard in turn. The JAX ring rotates K/V with
``ppermute`` inside a ``scan``; here rotation s hands shard i the chunk
(i - s) mod n by ``.to(mesh[i])`` (a no-op when the devices are the
same). Autograd differentiates through ``.to()``, the combine, and the
flash kernels' lse (their backward folds the lse cotangent into delta).

Causal chunking, as in the reference: shard i attends its own chunk
causally (the diagonal), chunk src < i in full, and skips src > i. The
reference's skipped branch returns (0, -1e30), which `_combine` merges
into (o, lse) bit for bit (w1 = 1, denom = 1); the port launches nothing
for it. The partials are combined in the reference's order: the held
chunk, then rotations 1, 2, ..., so bf16 o rounds as the reference's.
"""

from __future__ import annotations

import functools

import torch

from ray_tpu_torch.ops.attention import (NEG_INF, flash_attention,
                                         reference_attention)
from ray_tpu_torch.parallel.mesh import device_mesh


def make_sp_mesh(sp: int, *, devices=None) -> list[torch.device]:
    """The sequence-parallel mesh: ``sp`` devices, one per sequence
    chunk. By default the first ``sp`` visible CUDA devices (raises when
    there are fewer); an explicit ``devices`` list may repeat a device."""
    return device_mesh(sp, axis="sp", devices=devices)


def _combine(o1, lse1, o2, lse2):
    """Merge two partial attention results. o: [B, S, H, K], lse:
    [B, S, H] fp32. The weights are cast to o's dtype before the
    products, as in the reference."""
    m = torch.maximum(lse1, lse2)
    m_safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    w1 = torch.exp(lse1 - m_safe)
    w2 = torch.exp(lse2 - m_safe)
    denom = w1 + w2
    empty = denom == 0.0
    denom_safe = torch.where(empty, torch.ones_like(denom), denom)
    o = (o1 * (w1 / denom_safe)[..., None].to(o1.dtype)
         + o2 * (w2 / denom_safe)[..., None].to(o2.dtype))
    lse = torch.where(empty, torch.full_like(denom, NEG_INF),
                      m_safe + torch.log(denom_safe))
    return o, lse


def _attn_fn(impl: str, sm_scale):
    if impl == "flash":
        return functools.partial(flash_attention, sm_scale=sm_scale,
                                 return_lse=True)
    if impl == "xla":
        return functools.partial(reference_attention, sm_scale=sm_scale,
                                 return_lse=True)
    raise ValueError(f"unknown ring attention impl {impl!r}")


def ring_attention(q_chunks, k_chunks, v_chunks, mesh, *, causal=True,
                   sm_scale=None, impl="flash") -> list[torch.Tensor]:
    """Ring attention over ``mesh`` (a list of devices, one per shard).

    ``q_chunks[i]``, ``k_chunks[i]``, ``v_chunks[i]``: shard i's chunk,
    [B, S_local, H, K] on ``mesh[i]``; the global sequence is the chunks
    in order. → shard i's output chunk on ``mesh[i]``, per shard."""
    n = len(mesh)
    if not (len(q_chunks) == len(k_chunks) == len(v_chunks) == n):
        raise ValueError(f"{n} shards but {len(q_chunks)}, {len(k_chunks)}, "
                         f"{len(v_chunks)} q/k/v chunks")
    attn = _attn_fn(impl, sm_scale)
    out = []
    for i, dev in enumerate(mesh):
        q = q_chunks[i]
        # Step 0: the held chunk (the causal diagonal).
        o, lse = attn(q, k_chunks[i], v_chunks[i], causal=causal)
        if n == 1:
            out.append(o)
            continue
        for s in range(1, n):
            src = (i - s) % n            # the chunk shard i holds now
            if causal and src > i:       # invisible: the exact no-op
                continue
            o2, lse2 = attn(q, k_chunks[src].to(dev), v_chunks[src].to(dev),
                            causal=False)
            o, lse = _combine(o, lse, o2, lse2)
        out.append(o)
    return out


def ring_attention_sharded(q, k, v, mesh, *, causal=True, sm_scale=None,
                           impl="flash") -> torch.Tensor:
    """Global [B, S, H, K] q, k, v: S splits into ``len(mesh)``
    contiguous chunks, chunk i placed on ``mesh[i]``; the output chunks
    join on q's device. Batch and heads are not sharded."""
    n = len(mesh)
    S = q.shape[1]
    if S % n or k.shape[1] != S or v.shape[1] != S:
        raise ValueError(f"ring attention splits the sequence into sp={n} "
                         f"equal chunks; got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    split = lambda x: [c.to(d) for c, d in zip(torch.chunk(x, n, dim=1),
                                               mesh)]
    outs = ring_attention(split(q), split(k), split(v), mesh, causal=causal,
                          sm_scale=sm_scale, impl=impl)
    return torch.cat([o.to(q.device) for o in outs], dim=1)


__all__ = ["make_sp_mesh", "ring_attention", "ring_attention_sharded"]
