"""Card ms of a GN iteration's normal equations and solve: the time
between the CUDA events of the program's `recon.normal` spans (the sums
JᵀJ, Jᵀr over each term's rows through the batched solve, inside each
`recon.gn`), summed per `recon.gn` span of the traced batches.  A port
without that span reports nothing."""
from __future__ import annotations

from dsp_slam_rgbd_tpu_torch.utils import timers

from benchmark.yardstick import spans


def read(ctx):
    normal = spans.of(timers, "recon.normal")
    gn = spans.of(timers, "recon.gn")
    if not normal or not gn or any(s.device_ms is None for s in normal):
        return None
    return sum(s.device_ms for s in normal) / len(gn)
