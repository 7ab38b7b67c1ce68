"""AdamW and Adafactor with optax's semantics (PyTorch).

Counterparts of ``optax.adamw`` and ``optax.adafactor`` as the JAX
package's train step uses them (``bench.py``: ``adamw(3e-4,
weight_decay=0.1, mu_dtype=bfloat16)``; ``BENCH_OPT=adafactor`` and
``adafactor_sr``: ``adafactor(3e-4)``). The port may not import optax,
and ``torch.optim`` has neither a bf16 first moment nor optax's
Adafactor, so each is an init/update pair that follows optax 0.2.6 step
by step.

`adamw`: ``scale_by_adam`` → ``add_decayed_weights`` →
``scale_by_learning_rate``:

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
  ``-lr·(m̂/(√v̂ + eps) + wd·p)``.

`adafactor`: ``scale_by_factored_rms`` → ``clip_by_block_rms`` →
``scale_by_learning_rate`` → ``scale_by_param_block_rms`` (when
``multiply_by_parameter_scale``) → ``scale(-1)``, no momentum, no weight
decay:

- a leaf's second moment is factored over its two largest dims, chosen
  by ``np.argsort`` of its shape (so ties resolve as optax resolves
  them), when the second largest is at least ``min_dim_size_to_factor``;
  otherwise it is kept whole;
- the decay is ``1 - (count + 1)^-decay_rate`` in fp32, from step 0;
- the moments are computed in fp32 and stored in the parameter's dtype
  each step (bf16 masters have bf16 moments), and the update is formed
  from the stored (rounded) moments, as optax forms it. As the jitted
  JAX step computes it, an unfactored moment's factor ``v^-0.5`` is
  taken in fp32 (XLA keeps the fused expression's excess precision),
  while the factored row and column factors are rounded to the moment's
  dtype (a bf16 master's factors then differ from XLA's in the last bit
  now and then: the backends' rsqrt differ);
- the update's block RMS (for the clip) and the parameter's block RMS
  (``max(rms(p), 1e-3)``, for the scale) are taken over the whole leaf.

On a rank of a process mesh (``adafactor(...).on_mesh(shardings,
mesh)``, which ``train/spmd.py::build_training`` takes) a leaf is the
rank's piece of the whole leaf: the factored dims are chosen from the
whole shape, a row or column mean over a dimension that fsdp or tp
splits is all-reduced over those axes before use (the pieces are even,
so the mean of their means is the whole mean), and each block RMS is
the root of the all-reduced sum of squares over the whole leaf's
element count. Under dp it runs unchanged.

A stacked leaf ([L, ...], dim 0 not factored) is walked one layer slice
at a time, so no whole-leaf fp32 temporary is made beyond the gradient
itself: at ``llama3_8b`` one fp32 copy of ``w_gate`` is 7.5 GB. The two
whole-leaf RMS values take a first pass over the slices (which also
updates the moments); the second pass recomputes each slice's scaled
update from the stored moments (bit for bit the first pass's) and hands
it out. So the slicing changes only the order of the fp32 sums of the
two RMS values. Adafactor's updates are therefore lazy: ``updates[k]``
is an iterable of ``(index, update)`` pairs, ``index`` selecting a
slice of the leaf (``Ellipsis`` for the whole leaf), and the leaf's
moments are updated when its update is first iterated; consume every
update once (``apply_updates``, ``low_precision.sr_apply_updates``)
before the next call. AdamW's updates are whole tensors.

Parameters, gradients and moments are dicts of tensors keyed alike
(the gradients any mapping). The state's tensors are updated in place
(the counterpart of donating the JAX state); ``apply_updates`` adds the
updates to the parameters in place, as ``optax.apply_updates`` adds
them: ``p + u`` in the promoted dtype, cast to p's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import numpy as np
import torch


@dataclasses.dataclass
class AdamState:
    count: int                       # steps taken (optax's int32 count)
    mu: dict[str, torch.Tensor]      # first moment, in mu_dtype
    nu: dict[str, torch.Tensor]      # second moment, in the params' dtype


class GradientTransformation(NamedTuple):
    """optax's pair, and ``on_mesh(shardings, mesh)``: the same
    transformation for a rank of a process mesh whose leaves are the
    pieces ``shardings`` (``parallel/mesh.py::Sharding`` by name) give
    it; None where the update is elementwise and needs nothing else."""
    init: Callable
    update: Callable
    on_mesh: Callable | None = None


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


@dataclasses.dataclass
class FactoredState:
    """optax's ``FactoredState``: per leaf, the row and column moments
    of a factored leaf (``v`` a [1] placeholder) or the whole moment
    ``v`` of an unfactored one (``v_row``, ``v_col`` placeholders)."""
    count: int
    v_row: dict[str, torch.Tensor]
    v_col: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]


def _factored_dims(shape: tuple, min_dim_size_to_factor: int):
    """optax's ``_factored_dims``: (d1, d0), the second largest and the
    largest dim by ``np.argsort`` of the shape, or None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def _layer_slices(shape: tuple, dims):
    """The slices a leaf is walked in: one per index of dim 0 when dim 0
    is not factored (a stacked leaf), else the whole leaf; and the
    factored dims within a slice."""
    if len(shape) >= 2 and (dims is None or 0 not in dims):
        return range(shape[0]), None if dims is None else (dims[0] - 1,
                                                           dims[1] - 1)
    return (Ellipsis,), dims


def adafactor(learning_rate: float, min_dim_size_to_factor: int = 128,
              decay_rate: float = 0.8, decay_offset: int = 0,
              multiply_by_parameter_scale: bool = True,
              clipping_threshold: float | None = 1.0,
              eps: float = 1e-30) -> GradientTransformation:
    """optax.adafactor(learning_rate, min_dim_size_to_factor, decay_rate,
    decay_offset, multiply_by_parameter_scale, clipping_threshold,
    momentum=None, weight_decay_rate=None, eps, factored=True) with a
    constant learning rate; the defaults are optax's. See the module
    docstring for the lazy, sliced updates and for ``on_mesh``."""

    def on_mesh(shardings, mesh):
        """The transformation for the pieces ``shardings`` gives a rank
        of ``mesh``."""
        layout = _PieceLayout(shardings, mesh)

        def init(params: dict[str, torch.Tensor]) -> FactoredState:
            state = FactoredState(count=0, v_row={}, v_col={}, v={})
            with torch.no_grad():
                for k, p in params.items():
                    z = lambda shape: torch.zeros(shape, dtype=p.dtype,
                                                  device=p.device)
                    dims = _factored_dims(layout.whole_shape(k, p.shape),
                                          min_dim_size_to_factor)
                    if dims is None:
                        state.v_row[k], state.v_col[k] = z(1), z(1)
                        state.v[k] = z(p.shape)
                    else:
                        d1, d0 = dims
                        state.v_row[k] = z(np.delete(p.shape, d0).tolist())
                        state.v_col[k] = z(np.delete(p.shape, d1).tolist())
                        state.v[k] = z(1)
            return state

        def leaf_update(k, grads, state, param, decay, keep):
            """The leaf's update, slice by slice (a generator: see
            above)."""
            g = grads[k]
            p = param.detach()
            dtype = p.dtype
            dims = _factored_dims(layout.whole_shape(k, p.shape),
                                  min_dim_size_to_factor)
            idxs, sdims = _layer_slices(tuple(p.shape), dims)
            # A slice's dimension j is the leaf's j + off.
            off = 0 if idxs == (Ellipsis,) else 1

            def mean(x, dim, leaf_dim, keepdim=False):
                """x's mean over ``dim``, the leaf's ``leaf_dim``
                (all-reduced where that dimension is split), with
                jnp.mean's arithmetic: an fp32 sum, divided, cast to x's
                dtype (torch's own bf16 mean rounds twice)."""
                m = x.float().mean(dim=dim, keepdim=keepdim)
                return layout.mean(m, k, leaf_dim).to(x.dtype)

            row_means = {}

            def scaled(i):
                """The factored-rms update of slice i from the stored
                moments."""
                gi = g[i]
                if sdims is None:
                    v = state.v[k][i]
                    return (gi * v.float() ** -0.5).to(
                        torch.promote_types(gi.dtype, v.dtype))
                d1, d0 = sdims
                vr, vc = state.v_row[k][i], state.v_col[k][i]
                if i not in row_means:
                    rd1 = d1 - 1 if d1 > d0 else d1
                    row_means[i] = mean(vr, rd1, d1 + off, keepdim=True)
                row = (vr / row_means[i]) ** -0.5
                return gi * row.unsqueeze(d0) * (vc ** -0.5).unsqueeze(d1)

            usq = torch.zeros((), dtype=torch.float32, device=p.device)
            psq = torch.zeros((), dtype=torch.float32, device=p.device)
            for i in idxs:                 # pass 1: moments, the two sums
                gi = g[i]
                gsq = gi * gi + eps
                if sdims is None:
                    v = state.v[k][i]
                    v.copy_(decay * v.float() + keep * gsq.float())
                else:
                    d1, d0 = sdims
                    for vv, axis in ((state.v_row[k][i], d0),
                                     (state.v_col[k][i], d1)):
                        vv.copy_(decay * vv.float()
                                 + keep * mean(gsq, axis, axis + off).float())
                u = scaled(i)
                usq += (u * u).float().sum()
                psq += (p[i] * p[i]).float().sum()
            usq, psq = layout.total(k, torch.stack([usq, psq]))
            n = math.prod(layout.whole_shape(k, p.shape))
            clip = None
            if clipping_threshold is not None:
                rms = torch.sqrt((usq / n).to(u.dtype))
                clip = torch.clamp(rms / clipping_threshold, min=1.0)
            pscale = None
            if multiply_by_parameter_scale:
                prms = torch.sqrt((psq / n).to(dtype))
                pscale = torch.where(prms <= 1e-3,
                                     torch.full_like(prms, 1e-3), prms)
            for i in idxs:                 # pass 2: the update, slice by slice
                u = scaled(i)
                if clip is not None:
                    u = u / clip
                u = u * learning_rate
                if pscale is not None:
                    u = u * pscale
                yield i, -u

        def update(grads, state: FactoredState, params):
            # The decay of this step, in fp32 as optax's _decay_rate_pow.
            t = torch.tensor(state.count - decay_offset + 1,
                             dtype=torch.float32)
            decay_t = 1.0 - t ** (-decay_rate)
            decay, keep = float(decay_t), float(1.0 - decay_t)
            updates = {k: leaf_update(k, grads, state, params[k], decay, keep)
                       for k in grads}
            state.count += 1
            return updates, state

        return GradientTransformation(init, update, on_mesh)

    return on_mesh({}, None)


class _PieceLayout:
    """Where a rank's leaves lie in the whole ones: ``shardings`` by name
    (a name without one, or no mesh, is whole)."""

    def __init__(self, shardings: dict, mesh):
        self.shardings = shardings if mesh is not None else {}
        self.mesh = mesh

    def whole_shape(self, k, shape) -> tuple:
        shape = list(shape)
        s = self.shardings.get(k)
        for split in () if s is None else s.splits:
            shape[split.dim] *= split.count
        return tuple(shape)

    def mean(self, m: torch.Tensor, k, leaf_dim: int) -> torch.Tensor:
        """``m``, a mean over the rank's part of the leaf's ``leaf_dim``,
        as the mean over the whole dimension."""
        s = self.shardings.get(k)
        for split in () if s is None else s.splits:
            if split.dim == leaf_dim:
                return self.mesh.all_reduce_mean(m, split.axes)
        return m

    def total(self, k, sums: torch.Tensor) -> torch.Tensor:
        """``sums`` over the rank's piece as sums over the whole leaf."""
        s = self.shardings.get(k)
        if s is None or not s.splits:
            return sums
        return self.mesh.all_reduce_sum(sums, s.axes)


def update_slices(u):
    """(index, update) pairs of one leaf's update: a tensor is one pair
    over the whole leaf; a lazy adafactor update yields its slices."""
    if isinstance(u, torch.Tensor):
        return ((Ellipsis, u),)
    return u


def apply_updates(params: dict[str, torch.Tensor], updates) -> None:
    """p += u in place, as optax.apply_updates computes it (``p + u`` in
    the promoted dtype, cast to p's), slice by slice for a lazy update."""
    with torch.no_grad():
        for k, u in updates.items():
            for i, us in update_slices(u):
                p = params[k][i]
                if us.dtype == p.dtype:
                    p.add_(us)
                else:
                    p.copy_(p + us)


__all__ = ["adamw", "adafactor", "apply_updates", "update_slices",
           "AdamState", "FactoredState", "GradientTransformation"]
