"""Device selection shared by the port's entry points.

Every entry point takes ``device=`` and defaults to the card. Asking for a
card that is not there raises; nothing falls back to the CPU on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names a missing
    card."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a CUDA card or the CPU: {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs a CUDA card, but "
            "torch.cuda.is_available() is False; pass device=\"cpu\" to run "
            "on the CPU")
    return dev
