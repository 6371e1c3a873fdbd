"""Device resolution for the port's entry points.

Entry points default to the card.  Without CUDA they raise unless the
caller asked for the CPU explicitly: nothing carries on quietly there.
"""
from __future__ import annotations

import torch


def resolve(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
