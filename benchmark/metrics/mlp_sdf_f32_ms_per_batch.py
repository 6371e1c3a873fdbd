"""Device ms a fit batch of the f32 decoder kernels (value and Jacobian,
`csrc/mlp_sdf_f32.cu`), from the trace."""
from __future__ import annotations

from benchmark.yardstick import trace


def read(ctx):
    s = trace.kernel_seconds(ctx["trace"], "mlp_sdf_f32")
    return 1e3 * s / ctx["units"] if s > 0.0 else None
