"""Where the port's state lives when the caller does not say.

Every entry point and every helper that builds device state takes
``device=None`` to mean the CUDA device, and raises where there is none:
nothing falls back to the CPU by itself. The CPU is the caller's to ask
for, with ``device="cpu"``."""

from __future__ import annotations

import torch


def resolve(device, who: str) -> torch.device:
    """``device`` as a torch.device; None is the CUDA device, and raises a
    RuntimeError naming `who` where there is no CUDA device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who}: no CUDA device, and the port does not fall back to "
                'the CPU by itself; pass device="cpu" to run there')
        device = "cuda"
    return torch.device(device)
