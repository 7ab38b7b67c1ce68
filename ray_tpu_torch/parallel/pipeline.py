"""Pipeline parallelism: the GPipe microbatch schedule over a pp mesh
(PyTorch).

Counterpart of ``ray_tpu/parallel/pipeline.py`` (`pipeline_apply`,
`split_microbatch_count`). The port is single-controller, as its tp, sp
and ep are: the pp mesh is a list of devices that may repeat
(``parallel/mesh.py::device_mesh(pp, axis="pp")``), stage r's layers
live on ``mesh[r]``, and one process runs every stage. At step t stage r
applies its layers to microbatch t - r; its activation moves to stage
r + 1's device with ``.to()`` (the reference's ``ppermute``), and the
last stage's outputs are the result. Autograd through the schedule is
the pipelined backward, as ``jax.grad`` through the reference's scan is.

The reference runs ``stage_fn`` on every stage at every one of the
n_micro + pp - 1 steps and discards the bubble's outputs with
``jnp.where``; the port runs only the n_micro x pp real stage
applications, with the same values. The reference's fp32 round trip of
the broadcast ``psum`` leaves values unchanged: the port moves the last
stage's outputs to the input's device and joins them.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stacked_params: Sequence[Any],
    x: torch.Tensor,
    *,
    mesh: Sequence[torch.device],
    n_micro: int,
) -> torch.Tensor:
    """Run ``x`` [B, ...] through a layer stack pipelined over ``mesh``.

    - ``stacked_params``: one local stack per stage (``len(mesh)`` of
      them), stage r's on ``mesh[r]`` (``parallel/mesh.py::axis_shards``
      of the layer leaves gives them).
    - ``stage_fn(local_stack, activation) -> activation`` applies one
      stage's layers.
    - ``n_micro``: the microbatch count; ``B % n_micro`` must be 0. More
      microbatches shrink the bubble ((pp-1)/(pp-1+n_micro) of the
      schedule on pp devices).

    The result lies on x's device. With one stage this is
    ``stage_fn(stacked_params[0], x)``."""
    pp = len(mesh)
    if len(stacked_params) != pp:
        raise ValueError(f"{len(stacked_params)} stage stacks for pp={pp}")
    if pp == 1:
        return stage_fn(stacked_params[0], x)
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by n_micro={n_micro}")
    micro = x.chunk(n_micro)
    waiting: list = [None] * pp            # the activation stage r takes next
    outs: list = [None] * n_micro
    for t in range(n_micro + pp - 1):
        # Later stages first: stage r takes what stage r - 1 handed over
        # at step t - 1 before stage r - 1 hands over step t's.
        for r in reversed(range(pp)):
            m = t - r
            if not 0 <= m < n_micro:
                continue                   # the bubble: nothing to run
            act = micro[m].to(mesh[0]) if r == 0 else waiting[r]
            y = stage_fn(stacked_params[r], act)
            if r == pp - 1:
                outs[m] = y.to(x.device)
            else:
                waiting[r + 1] = y.to(mesh[r + 1])
    return torch.cat(outs)


def split_microbatch_count(batch: int, pp: int,
                           target: int | None = None) -> int:
    """Pick a microbatch count: >= 2·pp when possible (keeps the bubble
    under ~33%), dividing the batch."""
    want = target or max(2 * pp, 1)
    for m in range(min(want, batch), 0, -1):
        if batch % m == 0:
            return m
    return 1


__all__ = ["pipeline_apply", "split_microbatch_count"]
