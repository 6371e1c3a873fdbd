"""The render term's live Jacobian rows, in % of the rows the Jacobian
kernel runs over: 100 x the sum of the `recon.gn` spans' `jac_live` (the
live-row count the normal equations use) over the sum of their
`jac_slots` (objects x `max_grad_points`), in the traced batches."""
from __future__ import annotations

from dsp_slam_rgbd_tpu_torch.utils import timers

from benchmark.yardstick import spans


def read(ctx):
    gn = spans.of(timers, "recon.gn")
    slots = sum(s.attrs.get("jac_slots", 0) for s in gn)
    live = sum(s.attrs.get("jac_live", 0) for s in gn)
    return 100.0 * live / slots if slots else None
