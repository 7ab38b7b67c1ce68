"""The single-device train step (PyTorch).

Counterpart of ``ray_tpu/train/spmd.py``'s ``make_train_step`` and
``build_training`` for one device: the loss's gradients by autograd,
then the optimizer's update, applied to the parameters in place under
``torch.no_grad()`` (the counterpart of the JAX step's
``donate_argnums``: no second copy of the parameters or the optimizer
state is made). The mesh, sharded init and optimizer-state shardings of
the JAX version are not ported: this step runs on one device and does
not shard.
"""

from __future__ import annotations

from typing import Callable

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.train.optim import GradientTransformation, apply_updates


def make_train_step(loss_fn: Callable[..., torch.Tensor],
                    optimizer: GradientTransformation):
    """step(params, opt_state, batch) → (params, opt_state, loss).

    loss_fn(params, *batch) → scalar. ``params`` is a dict of leaf
    tensors that require grad; it and ``opt_state`` are updated in place
    and returned. ``loss`` is detached."""

    def step(params, opt_state, batch):
        names = list(params)
        loss = loss_fn(params, *batch)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        updates, opt_state = optimizer.update(dict(zip(names, grads)),
                                              opt_state, params)
        del grads
        apply_updates(params, updates)
        return params, opt_state, loss.detach()

    return step


def build_training(cfg, optimizer: GradientTransformation,
                   generator: torch.Generator | None = None, device=None,
                   model=None):
    """Parameters, optimizer state and the train step on one device.

    ``model`` exposes init_params/loss_fn (defaults to
    ``ray_tpu_torch.models.gpt``); ``generator`` seeds the parameters (a
    generator seeded 0 on ``device`` when None); ``device`` defaults to
    CUDA and raises without a GPU. Returns (params, opt_state, step_fn)
    where step_fn(params, opt_state, (tokens, targets)) → (params,
    opt_state, loss)."""
    if model is None:
        from ray_tpu_torch.models import gpt as model

    dev = resolve_device(device)
    params = model.init_params(cfg, generator, dev)
    for p in params.values():
        p.requires_grad_(True)
    opt_state = optimizer.init(params)

    def loss(params, tokens, targets):
        return model.loss_fn(params, tokens, targets, cfg)

    return params, opt_state, make_train_step(loss, optimizer)


__all__ = ["make_train_step", "build_training"]
