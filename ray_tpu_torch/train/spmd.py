"""The single-device train step (PyTorch).

Counterpart of ``ray_tpu/train/spmd.py``'s ``make_train_step`` and
``build_training`` for one device: the loss's gradients by autograd,
then the optimizer's update, applied to the parameters in place under
``torch.no_grad()`` (the counterpart of the JAX step's
``donate_argnums``: no second copy of the parameters or the optimizer
state is made). ``stochastic_round=True`` is the bf16-master path
(``train/low_precision.py``): the gradients go to the optimizer in fp32
and the updates are applied with stochastic rounding. The sharded init
and optimizer-state shardings of the JAX version are not ported: the
step runs on one controller. The sp ``mesh`` goes to the loss, whose ring
attention uses it; an ep mesh places MoE-GPT's expert stacks on their
shards (``build_training(..., model=moe_gpt, ep_mesh=)``), and
`build_pipeline_training` places GPT's layer stacks on the stages of a
pp mesh. The optimizer sees each placed shard as a leaf of its own.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Callable

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.train.optim import GradientTransformation, apply_updates


class Fp32Leaves(Mapping):
    """The gradients as fp32, upcast one leaf at a time when read; each
    leaf's own gradient is dropped once read, so every leaf is read
    once. The JAX step upcasts the whole tree, which XLA fuses into the
    update; eagerly, a whole fp32 tree would be 4 bytes per parameter."""

    def __init__(self, grads: dict[str, torch.Tensor]):
        self._grads = grads

    def __getitem__(self, k):
        return self._grads.pop(k).float()

    def __contains__(self, k):
        return k in self._grads

    def __iter__(self):
        return iter(list(self._grads))

    def __len__(self):
        return len(self._grads)


def make_train_step(loss_fn: Callable[..., torch.Tensor],
                    optimizer: GradientTransformation, *,
                    stochastic_round: bool = False):
    """step(params, opt_state, batch) → (params, opt_state, loss).

    loss_fn(params, *batch) → scalar. ``params`` is a dict of leaf
    tensors that require grad; it and ``opt_state`` are updated in place
    and returned. ``loss`` is detached.

    stochastic_round=True is the bf16-master path: the state is
    ``(inner, count)`` (`build_training` makes it), the gradients reach
    the optimizer as fp32 leaf by leaf, and the updates are applied by
    ``low_precision.sr_apply_updates`` with ``count`` driving the noise;
    the count is then advanced."""

    def grads_of(params, batch):
        names = list(params)
        loss = loss_fn(params, *batch)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        return loss, dict(zip(names, grads))

    if stochastic_round:
        from ray_tpu_torch.train.low_precision import sr_apply_updates

        def step(params, opt_state, batch):
            inner, count = opt_state
            loss, grads = grads_of(params, batch)
            updates, inner = optimizer.update(Fp32Leaves(grads), inner,
                                              params)
            sr_apply_updates(params, updates, count)
            return params, (inner, count + 1), loss.detach()
    else:
        def step(params, opt_state, batch):
            loss, grads = grads_of(params, batch)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            del grads
            apply_updates(params, updates)
            return params, opt_state, loss.detach()

    return step


def _trainable(params: dict) -> dict:
    for p in params.values():
        p.requires_grad_(True)
    return params


def build_training(cfg, optimizer: GradientTransformation,
                   generator: torch.Generator | None = None, device=None,
                   model=None, *, mesh=None, ep_mesh=None,
                   stochastic_round: bool = False):
    """Parameters, optimizer state and the train step on one controller.

    ``model`` exposes init_params/loss_fn (defaults to
    ``ray_tpu_torch.models.gpt``; ``models.llama`` works alike);
    ``generator`` seeds the parameters (a generator seeded 0 on
    ``device`` when None); ``device`` defaults to CUDA and raises without
    a GPU; ``mesh`` is the sp mesh of ``attn_impl="ring"``
    (``parallel/ring.py::make_sp_mesh``); ``ep_mesh`` the expert-parallel
    mesh of ``models.moe_gpt`` (``parallel/mesh.py::device_mesh(n,
    axis="ep")``): the expert stacks are placed on their shards
    (``models/partition.py::place_on_axis``, ``moe_w_up@s``...) and the
    mesh goes to the loss. ``stochastic_round=True`` is
    the bf16-master path (set ``cfg.param_dtype=torch.bfloat16`` with
    it): the optimizer state is initialised from the bf16 parameters
    (never an fp32 view; its moments follow the parameters' dtype) and
    paired with a step count. Returns (params, opt_state, step_fn) where
    step_fn(params, opt_state, (tokens, targets)) → (params, opt_state,
    loss)."""
    if model is None:
        from ray_tpu_torch.models import gpt as model

    dev = resolve_device(device)
    params = model.init_params(cfg, generator, dev)
    extra = {}
    if ep_mesh is not None:
        from ray_tpu_torch.models.partition import place_on_axis

        params = place_on_axis(params, model.logical_axes(cfg), ep_mesh, "ep")
        extra["ep_mesh"] = ep_mesh
    params = _trainable(params)
    opt_state = optimizer.init(params)
    if stochastic_round:
        opt_state = (opt_state, 0)

    def loss(params, tokens, targets):
        return model.loss_fn(params, tokens, targets, cfg, mesh, **extra)

    return params, opt_state, make_train_step(
        loss, optimizer, stochastic_round=stochastic_round)


def build_pipeline_training(cfg, optimizer: GradientTransformation,
                            generator: torch.Generator | None = None,
                            device=None, *, mesh, n_micro: int | None = None):
    """Pipeline-parallel `build_training` for GPT: the layer stacks are
    placed on the stages of the pp ``mesh`` (`PIPELINE_LOGICAL_RULES`:
    ``wq@r``... on ``mesh[r]``, the other leaves on ``mesh[0]``) and the
    step differentiates straight through the GPipe schedule
    (``models/gpt.py::pipeline_loss_fn``), with ``n_micro`` microbatches
    (``split_microbatch_count(B, pp)`` when None). ``device`` holds the
    initial parameters (CUDA by default; raises without a GPU). Returns
    (params, opt_state, step_fn) as `build_training` does."""
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.models.partition import place_on_axis
    from ray_tpu_torch.parallel.mesh import PIPELINE_LOGICAL_RULES
    from ray_tpu_torch.parallel.pipeline import split_microbatch_count

    pp = len(mesh)
    if cfg.n_layers % max(pp, 1) != 0:
        raise ValueError(
            f"n_layers={cfg.n_layers} not divisible by pp={pp}")
    params = gpt.init_params(cfg, generator, resolve_device(device))
    params = _trainable(place_on_axis(params, gpt.logical_axes(cfg), mesh,
                                      "pp", PIPELINE_LOGICAL_RULES))
    opt_state = optimizer.init(params)

    def loss(params, tokens, targets):
        m = n_micro or split_microbatch_count(tokens.shape[0], pp)
        return gpt.pipeline_loss_fn(params, tokens, targets, cfg, mesh, m)

    return params, opt_state, make_train_step(loss, optimizer)


__all__ = ["Fp32Leaves", "make_train_step", "build_training",
           "build_pipeline_training"]
