"""Per-device memory audit of a training configuration (PyTorch port).

Counterpart of ``ray_tpu/train/memory_audit.py`` (`HBM_BYTES`,
`_OPT_COPIES`, `AuditReport`, `_shard_elems`, `_FakeMesh`,
`audit_training`), with the same arithmetic: given a model config, a
mesh shape and the logical sharding rules, the bytes of parameters,
optimizer state and gradients on the busiest device (from the model's
``param_specs`` table and ``models/partition.py::logical_to_spec``) plus
the reference's activation estimate, against a device's memory. The
audit is arithmetic only: it answers for any mesh shape, though the
port trains on one device.

``HBM_BYTES`` keeps the reference's TPU entries, so that the port's
audit answers as the reference's does, and adds ``"h100"``: the total
memory ``torch.cuda.get_device_properties(0).total_memory`` reports on
an NVIDIA H100 80GB HBM3 (``chip_smoke.py`` train_llama reads it on
the card and fails if the two differ).
"""

from __future__ import annotations

import dataclasses
import math

from ray_tpu_torch.models.partition import logical_to_spec
from ray_tpu_torch.parallel.mesh import DEFAULT_LOGICAL_RULES

# Memory per device: the reference's public TPU HBM capacities, and the
# H100's as the card reports it.
HBM_BYTES = {
    "v4": 32 << 30,
    "v5e": 16 << 30,
    "v5p": 95 << 30,
    "v6e": 32 << 30,
    "h100": 85_017_493_504,
}

# adamw: m + v moments, same shape/dtype as the (fp32) param. adafactor:
# factored second moments (row+col vectors) — charged at 1% as a safe
# over-estimate of the O(sum-of-dims) state.
_OPT_COPIES = {"adamw": 2, "adam": 2, "sgd": 0, "sgd_momentum": 1,
               "adafactor": 0.01}


@dataclasses.dataclass(frozen=True)
class AuditReport:
    per_device: dict[str, int]      # component → bytes on the busiest device
    total_bytes: int                # sum of components
    hbm_bytes: int
    mesh_shape: dict[str, int]
    fits: bool

    def __str__(self):
        gib = 1 << 30
        rows = "\n".join(
            f"  {k:>12}: {v / gib:7.2f} GiB" for k, v in self.per_device.items())
        return (
            f"mesh={self.mesh_shape}\n{rows}\n"
            f"  {'total':>12}: {self.total_bytes / gib:7.2f} GiB "
            f"/ {self.hbm_bytes / gib:.0f} GiB HBM → "
            f"{'FITS' if self.fits else 'DOES NOT FIT'}"
        )


def _shard_elems(shape, spec, mesh_shape: dict[str, int]) -> int:
    """Elements of the largest shard of `shape` under `spec` on `mesh_shape`
    (ceil-division per sharded dim, matching XLA's padded sharding)."""
    dims = list(shape)
    parts = list(spec) + [None] * (len(dims) - len(spec))
    n = 1
    for d, p in zip(dims, parts):
        if p is None:
            n *= d
            continue
        axes = (p,) if isinstance(p, str) else tuple(p)
        k = math.prod(mesh_shape.get(a, 1) for a in axes)
        n *= math.ceil(d / k)
    return n


class _FakeMesh:
    """Duck-typed stand-in so logical_to_spec can consult axis sizes for
    mesh shapes larger than the locally available device count."""

    def __init__(self, shape: dict[str, int]):
        self.shape = dict(shape)


def audit_training(
    cfg,
    mesh_shape: dict[str, int],
    *,
    model=None,
    optimizer: str = "adamw",
    rules=DEFAULT_LOGICAL_RULES,
    batch_per_device: int = 1,
    hbm: str | int = "v5e",
    param_bytes: int = 4,          # fp32 masters (build_training default)
    grad_bytes: int = 4,
) -> AuditReport:
    """Audit params + optimizer state + grads + an activation estimate for
    one train step of `cfg` sharded over `mesh_shape`.

    The activation estimate assumes remat (a checkpoint per block): live
    activations ≈ the per-layer block inputs saved for the backward sweep
    (n_layers × [B_local, S, D] bf16) plus one layer's recompute working
    set (~6 block-sized tensors) plus the chunked-CE logits block — the
    configuration big models actually train with here (cfg.remat=True,
    cfg.loss_chunk set).
    """
    if model is None:
        from ray_tpu_torch.models import gpt as model

    specs = model.param_specs(cfg)
    mesh = _FakeMesh(mesh_shape)
    param_elems = 0
    for name, spec in specs.items():
        pspec = logical_to_spec(spec["axes"], rules, mesh=mesh)
        param_elems += _shard_elems(spec["shape"], pspec, mesh_shape)

    opt_copies = _OPT_COPIES[optimizer]
    params_b = param_elems * param_bytes
    opt_b = int(param_elems * 4 * opt_copies)     # moments are fp32
    grads_b = param_elems * grad_bytes

    # Activations under remat + chunked CE (see docstring).
    S = cfg.max_seq
    D = cfg.d_model
    B = batch_per_device
    act_dtype = 2  # bf16
    saved_inputs = cfg.n_layers * B * S * D * act_dtype
    recompute_ws = 6 * B * S * max(D, cfg.d_ff) * act_dtype
    chunk = getattr(cfg, "loss_chunk", None) or S
    logits_b = B * chunk * cfg.vocab_size * 4 * 2   # fwd block + its grad
    act_b = saved_inputs + recompute_ws + logits_b

    hbm_b = HBM_BYTES[hbm] if isinstance(hbm, str) else int(hbm)
    per_device = {
        "params": params_b,
        "opt_state": opt_b,
        "grads": grads_b,
        "activations": act_b,
    }
    total = sum(per_device.values())
    return AuditReport(
        per_device=per_device,
        total_bytes=total,
        hbm_bytes=hbm_b,
        mesh_shape=dict(mesh_shape),
        fits=total <= hbm_b * 0.92,    # leave ~8% for temps/fragmentation
    )


__all__ = ["HBM_BYTES", "AuditReport", "audit_training"]
