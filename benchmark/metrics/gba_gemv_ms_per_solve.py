"""Device ms a global BA call of the kernels named `gemv*` (cuBLAS's
matrix-vector kernels behind the BA solver's einsums), from the trace."""
from __future__ import annotations

from benchmark.yardstick import trace


def read(ctx):
    s = trace.kernel_seconds(ctx["trace"], "gemv")
    return 1e3 * s / ctx["units"] if s > 0.0 else None
