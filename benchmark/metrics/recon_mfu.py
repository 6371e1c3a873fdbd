"""The whole fit step's share of the card's bf16 peak: the decoder FLOPs a
batch needs whose rows the shapes fix (`yardstick/flops.py`:
`model_flops_per_batch`, which leaves out the render term's Jacobian and
so undercounts) over the untraced window's seconds a batch, in %."""
from __future__ import annotations

from benchmark.yardstick import peaks


def read(ctx):
    pk = peaks.peaks(ctx["device_name"])
    f = ctx["work"].get("model_flops")
    if pk is None or not f or ctx["work"].get("compute_dtype") != "bfloat16":
        return None
    return 100.0 * f / ctx["unit_s"] / pk["bf16"]
