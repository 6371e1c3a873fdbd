"""Carry decoder weights across from the JAX package's layout.

The JAX package keeps a decoder as `params["layers"] = [(W_i, b_i), ...]`
with W_i (in, out).  `decoder_from_numpy` takes those pairs as numpy
arrays (callers apply `np.asarray` on their side) and builds the port's
module with the same layout, so both packages compute the same function.
"""
from __future__ import annotations

import numpy as np

from dsp_slam_rgbd_tpu_torch import device as device_mod
from dsp_slam_rgbd_tpu_torch.models.deepsdf import DecoderSpec, DeepSDFDecoder


def decoder_from_numpy(layers, spec: DecoderSpec,
                       device="cuda") -> DeepSDFDecoder:
    """[(W (in, out), b (out,)) numpy pairs] -> DeepSDFDecoder on `device`."""
    dev = device_mod.resolve(device)
    pairs = [(np.array(W, np.float32), np.array(b, np.float32))
             for W, b in layers]
    return DeepSDFDecoder(DecoderSpec(*spec), pairs).to(dev)
