"""The bf16 Jacobian kernel's share of its roofline at latent 256, in %:
the least time the card could take for the rows and codes the program
launched it over (`yardstick/kernel_share.py`: counted in the traced
batches' `recon.fit` spans, the work from `yardstick/decoder_work.py`: the
folded forward pass, the whole reverse sweep and the code's folded
products), over the device time of the kernel and of its fold kernel
(`mlp_sdf256_jacobian_tc*`) in the same batches."""
from __future__ import annotations

from dsp_slam_rgbd_tpu_torch.utils import timers

from benchmark.yardstick import kernel_share


def read(ctx):
    return kernel_share.roofline(ctx, timers, "mlp_sdf_jacobian", "mlp_sdf256_jacobian_tc", 256,
                                 True)
