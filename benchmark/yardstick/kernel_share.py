"""A decoder kernel's share of its roofline from a traced fit run: the
rows, launches and codes the program's `recon.fit` spans counted for it
(`ops/cuda/mlp_sdf.py`'s counters; `latent` and `B`, the codes of each
launch), the work `decoder_work.py` counts for them, and the kernels'
device time in the trace."""
from __future__ import annotations

from benchmark.yardstick import decoder_work, peaks, spans, trace


def roofline(ctx, timers, counter: str, kernel: str, latent: int, jacobian: bool):
    """100 x the least time (operations over the bf16 peak, or bytes over
    the HBM rate) over the device time of the kernels whose names contain
    `kernel`, for the `recon.fit` spans at `latent`; None where the trace
    or the spans hold nothing to read."""
    pk = peaks.peaks(ctx["device_name"])
    t = trace.kernel_seconds(ctx["trace"], kernel)
    fits = [f for f in spans.of(timers, "recon.fit") if f.attrs.get("latent") == latent]
    rows = sum(f.attrs.get("rows", {}).get(counter, 0) for f in fits)
    if pk is None or t <= 0.0 or not rows:
        return None
    launches = sum(f.attrs.get("launches", {}).get(counter, 0) for f in fits)
    codes = sum(f.attrs.get("launches", {}).get(counter, 0) * f.attrs["B"] for f in fits)
    ops, byts = decoder_work.work(latent, jacobian, rows, launches, codes)
    return 100.0 * max(ops / pk["bf16"], byts / pk["hbm"]) / t
