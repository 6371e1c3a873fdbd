"""Card ms of the CG solves a global BA call: the time between the CUDA
events that each of the program's `ba.cg` spans records at entry and exit,
summed per `ba.global` span in the traced calls."""
from __future__ import annotations

from dsp_slam_rgbd_tpu_torch.utils import timers

from benchmark.yardstick import spans


def read(ctx):
    return spans.per_root(spans.of(timers, "ba.cg"), spans.of(timers, "ba.global"), "device_ms")
