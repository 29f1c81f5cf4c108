"""Device resolution.

Every tensor the port creates lands on a device the caller named. A device
that is not there is an error: asking for ``cuda`` on a machine without
CUDA raises instead of quietly running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a concrete ``torch.device`` (a bare ``cuda`` gets the
    current device index, so it compares equal to tensors' devices)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cpu' or 'cuda'")
    return dev
