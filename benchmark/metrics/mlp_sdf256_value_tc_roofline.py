"""The bf16 value kernel's share of its roofline at latent 256, in %: the
least time the card could take for the rows and codes the program launched
it over (`yardstick/kernel_share.py`: counted in the traced batches'
`recon.fit` spans, the work from `yardstick/decoder_work.py`, the code's
folded products included), over the device time of the kernel and of its
fold kernel (`mlp_sdf256_value_tc*`) in the same batches."""
from __future__ import annotations

from dsp_slam_rgbd_tpu_torch.utils import timers

from benchmark.yardstick import kernel_share


def read(ctx):
    return kernel_share.roofline(ctx, timers, "mlp_sdf_value", "mlp_sdf256_value_tc", 256, False)
