"""AdamW with optax's semantics (PyTorch).

Counterpart of ``optax.adamw`` as the JAX package's train step uses it
(``bench.py``: ``adamw(3e-4, weight_decay=0.1, mu_dtype=bfloat16)``).
The port may not import optax, and ``torch.optim.AdamW`` cannot keep the
first moment in bf16, so this is an init/update pair that follows
optax 0.2.6's ``scale_by_adam`` → ``add_decayed_weights`` →
``scale_by_learning_rate`` chain step by step:

- the new first moment ``(1 - b1)·g + b1·mu`` is computed from the stored
  one, used for the update, and only then cast to ``mu_dtype``. As the
  jitted JAX step computes it, b1 is first rounded to mu's dtype (a
  weak-typed Python scalar: 0.9 → 0.8984375 in bf16) and the product and
  sum are fp32 (XLA keeps the fused expression's excess precision; an
  eager optax call would round the product to bf16 as well);
- the second moment ``(1 - b2)·g² + b2·nu`` stays in the parameters' dtype;
- bias correction counts from 1, ``1 - b**count`` in fp32;
- ``eps`` is added after the square root;
- weight decay applies to every leaf (no mask), and the update is
  ``-lr·(m̂/(√v̂ + eps) + wd·p)``, added to p in p's dtype.

Parameters, gradients and moments are dicts of tensors keyed alike. The
state's tensors are updated in place (the counterpart of donating the
JAX state); ``update`` returns the updates, ``apply_updates`` adds them
to the parameters in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch


@dataclasses.dataclass
class AdamState:
    count: int                       # steps taken (optax's int32 count)
    mu: dict[str, torch.Tensor]      # first moment, in mu_dtype
    nu: dict[str, torch.Tensor]      # second moment, in the params' dtype


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def _in_dtype(x: float, dtype: torch.dtype) -> float:
    """x rounded to dtype, as JAX rounds a weak-typed scalar operand."""
    return float(torch.tensor(x, dtype=dtype))


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count computed in fp32, as optax does."""
    one = torch.tensor(1.0, dtype=torch.float32)
    return float(one - torch.tensor(decay, dtype=torch.float32) ** count)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4,
          mu_dtype: torch.dtype | None = None) -> GradientTransformation:
    """optax.adamw(learning_rate, b1, b2, eps, eps_root=0, mu_dtype,
    weight_decay, mask=None) with a constant learning rate; the defaults
    are optax's."""

    def init(params: dict[str, torch.Tensor]) -> AdamState:
        with torch.no_grad():
            return AdamState(
                count=0,
                mu={k: torch.zeros_like(p, dtype=mu_dtype or p.dtype)
                    for k, p in params.items()},
                nu={k: torch.zeros_like(p) for k, p in params.items()})

    def update(grads, state: AdamState, params):
        count = state.count + 1
        bc1 = _bias_correction(b1, count)
        bc2 = _bias_correction(b2, count)
        updates = {}
        with torch.no_grad():
            for k, g in grads.items():
                m = state.mu[k]
                mu = (1 - b1) * g + _in_dtype(b1, m.dtype) * m.float()
                nu = state.nu[k]
                nu.mul_(b2).add_(g.square().mul_(1 - b2))
                u = (mu / bc1).div_((nu / bc2).sqrt_().add_(eps))
                u.add_(params[k], alpha=weight_decay).mul_(-learning_rate)
                state.mu[k].copy_(mu)
                updates[k] = u
        state.count = count
        return updates, state

    return GradientTransformation(init, update)


def apply_updates(params: dict[str, torch.Tensor],
                  updates: dict[str, torch.Tensor]) -> None:
    """p += u in place, in p's dtype (optax.apply_updates without the
    copy)."""
    with torch.no_grad():
        for k, u in updates.items():
            params[k].add_(u.to(params[k].dtype))


__all__ = ["adamw", "apply_updates", "AdamState", "GradientTransformation"]
