"""bf16 master weights with stochastic rounding (PyTorch).

Counterpart of ``ray_tpu/train/low_precision.py``
(`stochastic_round_bf16`, `sr_apply_updates`). Keeping the master
weights in bf16 halves the parameter and gradient residency (2 + 2
bytes per parameter against 4 + 4), the lever that fits a larger model
on one device; plain bf16 masters stall, because an update under half a
bf16 ulp of its weight rounds away. Stochastic rounding rounds up with
the probability of the truncated fraction, so the expected weight
change is the fp32 update.

The rounding is the reference's bit trick on the fp32 pattern: add 16
uniform random bits to the low half and clear it. The pattern is
monotone in the magnitude, so the carry into the kept half happens with
exactly the truncated share (for negative values the magnitude rounds,
unbiased either way). The sum is taken in int32, which wraps mod 2^32
and so gives the reference's uint32 bits, negative values included.

The noise is the port's own: ``jax.random``'s bits cannot be reproduced,
so each leaf draws from a ``torch.Generator`` on the leaf's device,
seeded from (base_key, count, leaf index) (the reference folds the same
three into its key). Replay stays deterministic; the rounded bits differ
from the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.train.optim import update_slices


def _round_with_noise(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """fp32 x → bf16, rounded with ``noise`` (int32 in [0, 65536), x's
    shape): the fp32 bits plus the noise, the low 16 bits cleared
    (0xFFFF0000 as int32 is -65536), then an exact cast."""
    bits = (x.float().contiguous().view(torch.int32) + noise) & -65536
    return bits.view(torch.float32).to(torch.bfloat16)


def _noise(shape, generator: torch.Generator) -> torch.Tensor:
    return torch.randint(0, 1 << 16, tuple(shape), generator=generator,
                         device=generator.device, dtype=torch.int32)


def stochastic_round_bf16(x: torch.Tensor,
                          generator: torch.Generator) -> torch.Tensor:
    """Round fp32 → bf16 stochastically: E[result] == x (within bf16's
    range). Deterministic given (x, the generator's state); the
    generator lies on x's device."""
    return _round_with_noise(x, _noise(x.shape, generator))


def _leaf_generator(base_key: int, count: int, index: int,
                    device) -> torch.Generator:
    seed = np.random.SeedSequence([base_key, count, index]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


def sr_apply_updates(params: dict[str, torch.Tensor], updates, count: int,
                     base_key: int = 0x5121) -> None:
    """``optim.apply_updates`` for bf16 masters, in place: each bf16
    leaf becomes the stochastically rounded fp32 sum of its fp32 view
    and its update; other leaves take the plain fp32 add and cast.

    Leaves are indexed in sorted name order (the reference's tree order
    of a dict); leaf i draws its noise from a generator seeded from
    (base_key, count, i). A lazy update is applied slice by slice, each
    slice's noise drawn in turn from the leaf's generator. Each update
    is consumed and dropped as it is applied."""
    with torch.no_grad():
        for i, k in enumerate(sorted(params)):
            if k not in updates:
                continue
            p = params[k]
            gen = (_leaf_generator(base_key, count, i, p.device)
                   if p.dtype == torch.bfloat16 else None)
            for idx, u in update_slices(updates.pop(k)):
                x = p[idx].float() + u.float()
                p[idx] = (x.to(p.dtype) if gen is None else
                          _round_with_noise(x, _noise(x.shape, gen)))


__all__ = ["stochastic_round_bf16", "sr_apply_updates"]
