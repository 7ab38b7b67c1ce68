"""Mixture-of-Experts layer with expert parallelism (PyTorch).

Counterpart of ``ray_tpu/ops/moe.py`` (`MoEConfig`, `moe_param_specs`,
`moe_logical_axes`, `init_moe_params`, `_top2_dispatch`, `moe_mlp`):
GShard/Switch top-2 token-choice routing with capacity, in the
reference's dense form:

    gates = softmax(x @ wg)                 [G, E] fp32
    top-2 experts per token, renormalized; a token past an expert's
    capacity C is dropped (combine weight 0: the residual passes it).
    dispatch [G, E, C] one-hot → expert inputs [E, C, D]  (gec,gd->ecd)
    expert MLP, stacked weights [E, D, F] / [E, F, D], tanh GELU
    combine [G, E, C] weighted → outputs [G, D]           (gec,ecd->gd)

The dispatch and combine products are plain large matmuls, as XLA
compiles them on the TPU; the reference has no Pallas kernel here, and
the port none either.

Expert parallelism is single-controller, as the port's tp and sp are:
``moe_mlp(..., mesh=)`` takes the ep mesh, a list of devices that may
repeat (``parallel/mesh.py::device_mesh(n, axis="ep")``). The router
``wg``, the routing and the aux loss run once, on x's device (shard 0's,
the controller's). Shard s holds experts ``s·E/n .. (s+1)·E/n - 1`` on
``mesh[s]`` (placed by ``models/partition.py::place_on_axis`` as
``w_up@s``..., or split from whole leaves at each call) and computes
``dispatch[:, E_s]``, its experts' MLP and ``combine[:, E_s]``; the
shards' partial outputs are summed in shard order on x's device, as
tp's cross-shard sums are (``parallel/mesh.py::reduce_shards``). XLA
derives an all-to-all from the shardings and may reassociate the sum:
with more than one shard the port's result can differ from a single
shard's by reassociation (in bf16, by the rounding of each partial).

`_top2_dispatch` is the reference's bit for bit on the same gates. The
slot of a token in its expert is a float in the reference; here it is
cast to int64, and a slot past the capacity is clamped before the
one-hot (``F.one_hot`` raises where ``jax.nn.one_hot`` gives a zero
row); its ``keep`` factor is 0, so the row is zero in both.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch._params import init_from_specs
from ray_tpu_torch.parallel.mesh import axis_shards, reduce_shards


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int
    n_experts: int
    capacity_factor: float = 1.5
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32

    def capacity(self, n_tokens: int) -> int:
        # top-2 routing: each token lands in up to 2 experts.
        return max(1, math.ceil(
            2 * n_tokens / self.n_experts * self.capacity_factor))


def moe_param_specs(cfg: MoEConfig) -> dict[str, dict[str, Any]]:
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "wg": {"shape": (D, E), "axes": ("embed", None),
               "init": "normal", "scale": 0.02},
        "w_up": {"shape": (E, D, F_), "axes": ("expert", "embed", "mlp"),
                 "init": "normal", "scale": 0.02},
        "b_up": {"shape": (E, F_), "axes": ("expert", "mlp"),
                 "init": "zeros"},
        "w_down": {"shape": (E, F_, D), "axes": ("expert", "mlp", "embed"),
                   "init": "normal", "scale": 0.02},
        "b_down": {"shape": (E, D), "axes": ("expert", "embed"),
                   "init": "zeros"},
    }


def init_moe_params(cfg: MoEConfig, generator: torch.Generator | None = None,
                    device=None) -> dict[str, torch.Tensor]:
    """Random parameters from ``generator`` on ``device`` (CUDA unless
    the caller asks for the CPU): the reference's shapes, scales and
    dtypes; the numbers differ (another RNG)."""
    return init_from_specs(moe_param_specs(cfg), cfg.param_dtype, generator,
                           resolve_device(device))


def moe_logical_axes(cfg: MoEConfig) -> dict[str, tuple]:
    return {k: v["axes"] for k, v in moe_param_specs(cfg).items()}


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    return F.one_hot(idx, n).to(dtype)


def _top2_dispatch(gates: torch.Tensor, capacity: int):
    """gates [G, E] fp32 → (dispatch [G, E, C] 0/1, combine [G, E, C]).

    GShard's construction: the arrival order within each expert by a
    cumsum of the one-hot assignment, top-1 routes ahead of top-2
    routes; a token whose slot is >= capacity is dropped. Every sum here
    is of small integers or of one nonzero term, so the result is the
    reference's bit for bit on the same gates, on any device."""
    E = gates.shape[1]
    idx1 = torch.argmax(gates, dim=-1)                      # first maximum
    mask1 = _one_hot(idx1, E, gates.dtype)                  # [G, E]
    gates2 = gates * (1.0 - mask1)
    idx2 = torch.argmax(gates2, dim=-1)
    mask2 = _one_hot(idx2, E, gates.dtype)

    w1 = torch.sum(gates * mask1, dim=-1)
    w2 = torch.sum(gates * mask2, dim=-1)
    denom = torch.clamp(w1 + w2, min=1e-9)
    w1, w2 = w1 / denom, w2 / denom

    pos1 = torch.cumsum(mask1, dim=0) - mask1               # [G, E]
    pos2 = torch.cumsum(mask2, dim=0) - mask2 + torch.sum(mask1, dim=0)
    slot1 = torch.sum(pos1 * mask1, dim=-1)                 # [G], integral
    slot2 = torch.sum(pos2 * mask2, dim=-1)
    keep1 = (slot1 < capacity).to(gates.dtype)
    keep2 = (slot2 < capacity).to(gates.dtype)

    # A dropped token's slot is clamped into range; keep zeroes its row.
    oh_slot1 = _one_hot(slot1.long().clamp(max=capacity - 1), capacity,
                        gates.dtype)
    oh_slot2 = _one_hot(slot2.long().clamp(max=capacity - 1), capacity,
                        gates.dtype)
    d1 = mask1[:, :, None] * oh_slot1[:, None, :] * keep1[:, None, None]
    d2 = mask2[:, :, None] * oh_slot2[:, None, :] * keep2[:, None, None]
    dispatch = d1 + d2                                      # [G, E, C]
    combine = d1 * w1[:, None, None] + d2 * w2[:, None, None]
    return dispatch, combine


def _expert_mlp(xd, disp, comb, w_up, b_up, w_down, b_down, dtype):
    """One shard's experts: expert inputs from ``disp`` [G, E_s, C], the
    MLP, and their outputs weighted by ``comb`` → [G, D] in ``dtype``."""
    expert_in = torch.einsum("gec,gd->ecd", disp, xd)
    up = torch.einsum("ecd,edf->ecf", expert_in, w_up.to(dtype))
    up = F.gelu(up + b_up.to(dtype)[:, None, :], approximate="tanh")
    down = torch.einsum("ecf,efd->ecd", up, w_down.to(dtype))
    down = down + b_down.to(dtype)[:, None, :]
    return torch.einsum("gec,ecd->gd", comb, down)


def moe_mlp(x: torch.Tensor, params: dict[str, torch.Tensor],
            cfg: MoEConfig, mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] → (y [B, S, D], aux_loss scalar fp32).

    aux_loss is the load-balancing loss (Switch Transformer eq. 4: E ×
    Σ_e fraction routed to e × mean gate of e); add ``aux * coef`` to the
    model loss. ``mesh`` is the ep mesh (see the module docstring); the
    expert leaves (``w_up``, ``b_up``, ``w_down``, ``b_down``) are whole
    [E, ...] tensors or placed shards ``name@s``."""
    B, S, D = x.shape
    G = B * S
    xf = x.reshape(G, D)
    gates = torch.softmax(xf.float() @ params["wg"].float(), dim=-1)
    C = cfg.capacity(G)
    dispatch, combine = _top2_dispatch(gates, C)
    mesh = mesh or [x.device]
    n = len(mesh)
    if cfg.n_experts % n:
        raise ValueError(f"n_experts={cfg.n_experts} not divisible by "
                         f"ep={n}")
    dt = cfg.dtype
    disp, comb, xd = dispatch.to(dt), combine.to(dt), xf.to(dt)
    shards = zip(*(axis_shards(params, k, mesh)
                   for k in ("w_up", "b_up", "w_down", "b_down")))
    e = cfg.n_experts // n
    parts = []
    for s, (dev, weights) in enumerate(zip(mesh, shards)):
        sl = slice(s * e, (s + 1) * e)
        parts.append(_expert_mlp(xd.to(dev), disp[:, sl].to(dev),
                                 comb[:, sl].to(dev), *weights, dt))
    y = reduce_shards(parts, x.device)
    # Load-balance aux loss: only mean_gate carries a gradient.
    frac_routed = torch.mean(
        _one_hot(torch.argmax(gates, dim=-1), cfg.n_experts, torch.float32),
        dim=0)
    mean_gate = torch.mean(gates, dim=0)
    aux = cfg.n_experts * torch.sum(frac_routed * mean_gate)
    return y.reshape(B, S, D), aux


__all__ = ["MoEConfig", "moe_param_specs", "moe_logical_axes",
           "init_moe_params", "moe_mlp"]
