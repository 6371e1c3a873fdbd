"""The bf16 Jacobian kernel's share of its roofline, in %: the least time
the card could take for the rows the program launched it over (the
`recon.fit` spans' `rows` and `launches` of `mlp_sdf_jacobian`, from
`ops/cuda/mlp_sdf.py`'s counters), over the kernel's device time in the
same traced batches.  The least time is the larger of the FLOPs over the
bf16 peak (2 forward passes a row, `yardstick/flops.py`'s convention) and
the bytes over the HBM rate: each row reads its xyz (3 float32) and writes
its SDF and 67 gradients (float32); each launch reads the forward and the
backward weight stream (bf16), the biases (float32) and the objects'
codes (64 float32 an object) once."""
from __future__ import annotations

from dsp_slam_rgbd_tpu_torch.utils import timers

from benchmark.yardstick import flops, peaks, spans, trace

# the one layout the tensor-core kernels run (`mlp_sdf.compatible`)
KERNEL_DECODER = {"latent_size": 64, "dims": [512] * 8, "latent_in": [4]}
ROW_BYTES = 4 * (3 + 1 + 67)


def read(ctx):
    pk = peaks.peaks(ctx["device_name"])
    t = trace.kernel_seconds(ctx["trace"], "mlp_sdf_jacobian_tc")
    fits = spans.of(timers, "recon.fit")
    rows = sum(f.attrs.get("rows", {}).get("mlp_sdf_jacobian", 0) for f in fits)
    if pk is None or t <= 0.0 or not rows:
        return None
    calls = sum(f.attrs.get("launches", {}).get("mlp_sdf_jacobian", 0) for f in fits)
    codes = sum(f.attrs.get("launches", {}).get("mlp_sdf_jacobian", 0) * f.attrs["B"]
                for f in fits) * KERNEL_DECODER["latent_size"] * 4
    w, b = flops.weight_count(KERNEL_DECODER)
    work = rows * 2.0 * flops.forward_flops_per_row(KERNEL_DECODER)
    byts = rows * ROW_BYTES + calls * (2 * w * 2 + b * 4) + codes
    return 100.0 * max(work / pk["bf16"], byts / pk["hbm"]) / t
