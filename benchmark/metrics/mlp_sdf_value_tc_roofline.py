"""The bf16 value kernel's share of its roofline: the least time the card
could take for the value pass of a batch (its FLOPs over the bf16 peak, or
its bytes over the HBM rate, whichever is larger; `yardstick/flops.py`)
over the kernel's device time a batch in the trace, in %."""
from __future__ import annotations

from benchmark.yardstick import peaks, trace


def read(ctx):
    pk = peaks.peaks(ctx["device_name"])
    work = ctx["work"].get("value_pass")
    t = trace.kernel_seconds(ctx["trace"], "mlp_sdf_value_tc") / ctx["units"]
    if pk is None or work is None or t <= 0.0:
        return None
    return 100.0 * max(work[0] / pk["bf16"], work[1] / pk["hbm"]) / t
