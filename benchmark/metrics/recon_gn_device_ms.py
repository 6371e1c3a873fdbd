"""Card ms of a GN iteration: the mean time between the CUDA events that
each of the program's `recon.gn` spans records at entry and exit, in the
traced batches: from when the card reached the iteration to when it
finished the iteration's work."""
from __future__ import annotations

from dsp_slam_rgbd_tpu_torch.utils import timers

from benchmark.yardstick import spans


def read(ctx):
    return spans.mean(spans.of(timers, "recon.gn"), "device_ms")
