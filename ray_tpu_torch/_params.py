"""Parameter initialisation from a spec table, shared by the models and
the ops that own parameters (``models/gpt.py``, ``models/moe_gpt.py``,
``ops/moe.py``)."""

from __future__ import annotations

import torch


def init_from_specs(specs: dict, dtype, generator: torch.Generator | None,
                    dev: torch.device, take=None) -> dict[str, torch.Tensor]:
    """Leaves of a spec table (``{name: {shape, init, scale}}``) on
    ``dev`` in ``dtype``, drawn in sorted name order from ``generator``
    (a fresh one seeded 0 when None). ``take(name, leaf)``, when given,
    keeps what it returns of each leaf as soon as the leaf is drawn (the
    sharded init keeps a rank's slice, so at most one whole leaf is
    alive at a time)."""
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    params = {}
    for name, spec in sorted(specs.items()):
        shape = spec["shape"]
        if spec["init"] == "normal":
            w = torch.randn(shape, generator=generator, device=dev,
                            dtype=dtype)
            params[name] = w.mul_(spec["scale"])
        elif spec["init"] == "ones":
            params[name] = torch.ones(shape, device=dev, dtype=dtype)
        else:
            params[name] = torch.zeros(shape, device=dev, dtype=dtype)
        if take is not None:
            params[name] = take(name, params[name])
    return params
