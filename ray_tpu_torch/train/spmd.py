"""The train step (PyTorch): on one controller, and across processes.

Counterpart of ``ray_tpu/train/spmd.py``'s ``param_shardings``,
``sharded_init``, ``opt_state_shardings``, ``make_train_step`` and
``build_training``: the loss's gradients by autograd, then the
optimizer's update, applied to the parameters in place under
``torch.no_grad()`` (the counterpart of the JAX step's
``donate_argnums``: no second copy of the parameters or the optimizer
state is made). ``stochastic_round=True`` is the bf16-master path
(``train/low_precision.py``): the gradients go to the optimizer in fp32
and the updates are applied with stochastic rounding.

Inside a rank, the sp ``mesh`` goes to the loss, whose ring attention
uses it; an ep mesh places MoE-GPT's expert stacks on their shards
(``build_training(..., model=moe_gpt, ep_mesh=)``), and
`build_pipeline_training` places GPT's layer stacks on the stages of a
pp mesh. The optimizer sees each placed shard as a leaf of its own.

Across processes, ``build_training(..., process_mesh=)`` takes a
``parallel/mesh.py::ProcessMesh`` (dp, fsdp and tp over the ranks of a
``torch.distributed`` group). `sharded_init` draws the parameters leaf by
leaf and keeps the rank's piece of each (``DEFAULT_LOGICAL_RULES``: the
embed dimension over fsdp, the heads, MLP width and vocabulary over tp;
a leaf may be split on two dimensions), so no rank holds the whole tree
at rest; the optimizer's moments then have the pieces' shapes. The step
runs on the rank's own batch (its rows of the global batch,
`batch_sharding`; tp ranks share their rows). A model with a
``rank_plan`` (GPT, ``models/gpt.py``) gets the plan of the rank's
pieces built from their shardings, and its loss runs it: each layer's
fsdp slices gathered inside the layer's checkpointed call, their
gradients reduce-scattered per layer (sum ÷ the fsdp size), megatron's
block under tp. Any other model's loss gets its fsdp slices gathered
whole first (`gather_params`), and no tp. Every
gradient is then all-reduced (sum ÷ the size) over the data axes, dp
and fsdp, that do not split its leaf (`sync_grads`), and the returned
loss is the mean over the data axes: the JAX step's global mean.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Callable

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.parallel.mesh import (DATA_AXES, DEFAULT_LOGICAL_RULES,
                                         gather_leaf, replicated)
from ray_tpu_torch.parallel.sharding import tree_to_shardings
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


# --------------------------------------------------- across processes


def param_shardings(logical_tree, mesh, rules=DEFAULT_LOGICAL_RULES):
    return tree_to_shardings(logical_tree, mesh, rules)


def sharded_init(model, cfg, mesh, generator: torch.Generator | None = None,
                 rules=DEFAULT_LOGICAL_RULES):
    """``model``'s parameters for ``cfg`` on the process mesh ``mesh``:
    drawn leaf by leaf from ``generator`` (on the mesh's device; a fresh
    one seeded 0 when None) in ``model.init_params``' order, each leaf
    cut to this rank's slice as soon as it is drawn, so no rank holds
    the whole tree while it initialises. The slices are those of
    ``init_params`` with the same generator. → (params, shardings)."""
    from ray_tpu_torch._params import init_from_specs

    specs = model.param_specs(cfg)
    shardings = param_shardings({k: v["axes"] for k, v in specs.items()},
                                mesh, rules)

    def take(name, leaf):
        s = shardings[name]
        return s.shard(leaf) if s.splits else leaf

    return init_from_specs(specs, cfg.param_dtype, generator, mesh.device,
                           take), shardings


def _map_state(fn, state, key=None):
    """``state`` with every leaf replaced by ``fn(key, leaf)``, ``key``
    the name of the innermost dict entry above the leaf."""
    if dataclasses.is_dataclass(state) and not isinstance(state, type):
        return type(state)(**{f.name: _map_state(fn, getattr(state, f.name))
                              for f in dataclasses.fields(state)})
    if isinstance(state, dict):
        return {k: _map_state(fn, v, k) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_map_state(fn, v, key) for v in state)
    return fn(key, state)


def opt_state_shardings(optimizer: GradientTransformation, params,
                        params_shardings, mesh):
    """The sharding of each leaf of ``optimizer``'s state for the rank's
    ``params`` (ZeRO: a moment kept under a parameter's name with the
    parameter's shape shards like it; counts and placeholders
    replicate). The state is built on the meta device: nothing is
    allocated."""
    meta = {k: torch.empty_like(p, device="meta") for k, p in params.items()}
    repl = replicated(mesh)

    def pick(key, leaf):
        if (isinstance(leaf, torch.Tensor) and key in params
                and leaf.shape == params[key].shape):
            return params_shardings.get(key, repl)
        return repl

    return _map_state(pick, optimizer.init(meta))


def gather_params(params: dict, shardings: dict, mesh) -> dict:
    """The leaves whole over fsdp for a model without a ``rank_plan``:
    each fsdp slice through ``parallel/mesh.py::gather_leaf`` (its
    gradient reduce-scattered back in the backward), every other leaf,
    and the tp pieces, as they are."""
    out = {}
    for k, p in params.items():
        s = shardings.get(k)
        dim = None if s is None else s.split_dim("fsdp")
        out[k] = p if dim is None else gather_leaf(p, mesh, "fsdp", dim)
    return out


def sync_grads(grads: dict, shardings: dict, mesh) -> None:
    """Each gradient's mean over the data axes (dp, fsdp) that do not
    split its leaf, in place of the rank's own: a leaf's fsdp slice had
    its gradient reduce-scattered over fsdp by its gather already, and
    tp is no data axis. A leaf that tp does not split (the layer norms,
    ``b_down``) needs no reduce over tp: every tp rank computes its
    gradient from the same activations (the inputs of the column-parallel
    products sum their gradients over tp, the row-parallel outputs are
    summed in the forward)."""
    for k, g in grads.items():
        s = shardings.get(k)
        split = () if s is None else s.axes
        grads[k] = mesh.all_reduce_mean(
            g, tuple(a for a in DATA_AXES if a not in split))


def make_train_step(loss_fn: Callable[..., torch.Tensor],
                    optimizer: GradientTransformation, *,
                    stochastic_round: bool = False, process_mesh=None,
                    shardings: dict | None = None):
    """step(params, opt_state, batch) → (params, opt_state, loss).

    loss_fn(params, *batch) → scalar. ``params`` is a dict of leaf
    tensors that require grad; it and ``opt_state`` are updated in place
    and returned. ``loss`` is detached.

    stochastic_round=True is the bf16-master path: the state is
    ``(inner, count)`` (`build_training` makes it), the gradients reach
    the optimizer as fp32 leaf by leaf, and the updates are applied by
    ``low_precision.sr_apply_updates`` with ``count`` driving the noise;
    the count is then advanced (every rank seeds its noise alike, so dp
    replicas stay identical).

    With ``process_mesh`` (and the parameters' ``shardings``, keyed by
    name; a name without one is whole), ``params`` are this rank's
    pieces and ``batch`` its rows (the loss reads the pieces itself:
    `build_training` gives it a plan or the gathered leaves), the
    gradients are reduced over the data axes (see the module docstring),
    and the loss returned is the mean over the data axes.

    ``step.grads_of(params, batch)`` → (loss, gradients) is the step's
    own gradient computation without the update (the gradients of a
    sliced leaf are the rank's slice)."""

    def grads_of(params, batch):
        names = list(params)
        loss = loss_fn(params, *batch)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [params[k] for k in names])))
        if process_mesh is None:
            return loss, grads
        sync_grads(grads, shardings, process_mesh)
        return process_mesh.all_reduce_mean(loss.detach(),
                                            DATA_AXES), grads

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

    step.grads_of = grads_of
    return step


def _trainable(params: dict) -> dict:
    for p in params.values():
        p.requires_grad_(True)
    return params


def build_training(cfg, optimizer: GradientTransformation,
                   generator: torch.Generator | None = None, device=None,
                   model=None, *, mesh=None, ep_mesh=None,
                   process_mesh=None, stochastic_round: bool = False):
    """Parameters, optimizer state and the train step.

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
    paired with a step count. ``process_mesh``: a
    ``parallel/mesh.py::ProcessMesh`` of this rank (`sharded_init` on
    it, the step of `make_train_step` over it; ``device`` is then the
    mesh's). A model with ``rank_plan(cfg, process_mesh, shardings)``
    (GPT) reads its pieces itself through the plan (``loss_fn(...,
    plan=)``): fsdp slices gathered layer by layer inside the step,
    megatron under tp; any other model gets its fsdp slices gathered
    whole before the loss and raises under tp (ROADMAP queue 1). An optimizer with ``on_mesh`` (Adafactor: its factored means
    and block RMS span the whole leaf) gets the pieces' layout.
    Returns (params, opt_state, step_fn) where step_fn(params,
    opt_state, (tokens, targets)) → (params, opt_state, loss)."""
    if model is None:
        from ray_tpu_torch.models import gpt as model

    shardings = None
    whole = False          # the fsdp slices gathered whole for the loss
    extra = {}
    if process_mesh is None:
        params = model.init_params(cfg, generator, resolve_device(device))
    else:
        if device is not None and (resolve_device(device)
                                   != process_mesh.device):
            raise ValueError(f"device {device} is not the process mesh's "
                             f"{process_mesh.device}")
        planned = hasattr(model, "rank_plan")
        if process_mesh.live("tp") and not planned:
            raise NotImplementedError(
                f"{model.__name__} under tp across processes (ROADMAP "
                "queue 1, the process-spanning axes)")
        params, shardings = sharded_init(model, cfg, process_mesh, generator)
        if planned:
            extra["plan"] = model.rank_plan(cfg, process_mesh, shardings)
        else:
            whole = True
        if ep_mesh is not None and any(s.splits for s in shardings.values()):
            raise NotImplementedError("an ep mesh under fsdp (ROADMAP queue "
                                      "1, the process-spanning axes)")
        if optimizer.on_mesh is not None:
            optimizer = optimizer.on_mesh(shardings, process_mesh)
    if ep_mesh is not None:
        from ray_tpu_torch.models.partition import place_on_axis

        params = place_on_axis(params, model.logical_axes(cfg), ep_mesh, "ep")
        extra["ep_mesh"] = ep_mesh
    params = _trainable(params)
    opt_state = optimizer.init(params)
    if stochastic_round:
        opt_state = (opt_state, 0)

    def loss(params, tokens, targets):
        if whole:
            params = gather_params(params, shardings, process_mesh)
        return model.loss_fn(params, tokens, targets, cfg, mesh, **extra)

    return params, opt_state, make_train_step(
        loss, optimizer, stochastic_round=stochastic_round,
        process_mesh=process_mesh, shardings=shardings)


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
           "build_pipeline_training", "param_shardings", "sharded_init",
           "opt_state_shardings", "gather_params", "sync_grads"]
