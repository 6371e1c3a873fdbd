"""Published dense peaks of the cards the benchmark knows (NVIDIA's data
sheets, no sparsity), at the card's full power limit.  The first key found
in `torch.cuda.get_device_name()` wins; a card not listed has no peak, and
the readers that need one report nothing."""
from __future__ import annotations

PEAKS = {
    "H100 PCIe": {"bf16": 756e12, "tf32": 378e12, "f32": 51e12, "hbm": 2.0e12},
    "H100": {"bf16": 989e12, "tf32": 495e12, "f32": 67e12, "hbm": 3.35e12},
}


def peaks(device_name: str) -> dict | None:
    return next((v for k, v in PEAKS.items() if k in device_name), None)
