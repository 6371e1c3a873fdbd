"""Host ms of the CG solves a global BA call: the program's `ba.cg` spans
(`mapping/ba.py::_pcg_gn_step`, one a GN step, around the whole CG loop)
summed on the host's clock, per `ba.global` span
(`mapping/local_mapping.py::global_ba_step`) in the traced calls."""
from __future__ import annotations

from dsp_slam_rgbd_tpu_torch.utils import timers

from benchmark.yardstick import spans


def read(ctx):
    return spans.per_root(spans.of(timers, "ba.cg"), spans.of(timers, "ba.global"), "host_ms")
