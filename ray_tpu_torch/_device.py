"""Device resolution shared by every entry point of the port.

The port runs on the GPU unless the caller asks for the CPU by name: a
missing card is an error, never a silent CPU run.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``. A CUDA device without a usable card raises
    RuntimeError; ``"cpu"`` (or a CPU torch.device) is honoured as asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch runs on CUDA by default but no GPU is available "
            "(torch.cuda.is_available() is False); pass device='cpu' to "
            "run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def check_device(device: torch.device, **tensors: torch.Tensor) -> None:
    """Raise if any named tensor lies on another device type than
    ``device`` (the index of a CUDA device is checked when given)."""
    for name, t in tensors.items():
        if t.device.type != device.type or (
                device.index is not None and t.device.index is not None
                and t.device.index != device.index):
            raise ValueError(
                f"{name} is on {t.device}, expected {device}")
