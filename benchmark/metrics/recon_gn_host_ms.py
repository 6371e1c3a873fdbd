"""Host ms of a GN iteration: the mean length, on the host's clock, of the
program's `recon.gn` spans (`recon/optimizer.py`, one a `_gn_iteration`
call) in the traced batches."""
from __future__ import annotations

from dsp_slam_rgbd_tpu_torch.utils import timers

from benchmark.yardstick import spans


def read(ctx):
    return spans.mean(spans.of(timers, "recon.gn"), "host_ms")
