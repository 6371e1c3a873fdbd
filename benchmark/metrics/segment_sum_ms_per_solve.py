"""Device ms a global BA call of the segment-sum and segment-offsets
kernels (`csrc/segment_sum.cu`), from the trace."""
from __future__ import annotations

from benchmark.yardstick import trace


def read(ctx):
    s = trace.kernel_seconds(ctx["trace"], "segment_sum_kernel", "segment_offsets_kernel")
    return 1e3 * s / ctx["units"] if s > 0.0 else None
