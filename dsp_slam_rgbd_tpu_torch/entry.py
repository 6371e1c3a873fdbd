"""The flagship reconstruction step with example inputs.

Counterpart of `__graft_entry__.entry()`: one joint Sim(3)+code GN fit of
an object with the full cars_64 DeepSDF decoder (random weights from seed
0), 2 iterations, 512 render-term gradient points.
"""
from __future__ import annotations

import numpy as np
import torch

from dsp_slam_rgbd_tpu_torch import device as device_mod
from dsp_slam_rgbd_tpu_torch.models import deepsdf
from dsp_slam_rgbd_tpu_torch.recon.optimizer import ReconConfig, reconstruct_object


def example_inputs(n_pts: int = 64, n_rays: int = 64, device="cuda"):
    """(t_cam_obj, pts, pts_mask, rays, ray_mask, depth_obs, fg_mask): an
    object 3 m ahead, made with numpy from seed 0."""
    dev = device_mod.resolve(device)
    rng = np.random.default_rng(0)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.0, 0.0, 3.0]
    pts = (rng.standard_normal((n_pts, 3)) * 0.3 + [0, 0, 3.0]).astype(np.float32)
    rays = (rng.standard_normal((n_rays, 3)) * 0.05 + [0, 0, 1.0]).astype(np.float32)
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    return (
        torch.from_numpy(T).to(dev),
        torch.from_numpy(pts).to(dev),
        torch.ones(n_pts, dtype=torch.bool, device=dev),
        torch.from_numpy(rays).to(dev),
        torch.ones(n_rays, dtype=torch.bool, device=dev),
        torch.full((n_rays,), 3.0, device=dev),
        torch.ones(n_rays, dtype=torch.bool, device=dev),
    )


def entry(device="cuda"):
    """-> (fn, example_args); fn(*example_args) returns (t_cam_obj, code,
    loss) of the fit."""
    dev = device_mod.resolve(device)
    decoder = deepsdf.init_decoder(deepsdf.DecoderSpec(), seed=0, device=dev)
    cfg = ReconConfig(num_iterations=2, max_grad_points=512)

    def fn(t_cam_obj, pts, pts_mask, rays, ray_mask, depth_obs, fg_mask):
        res = reconstruct_object(decoder, cfg, t_cam_obj, pts, pts_mask, rays,
                                 ray_mask, depth_obs, fg_mask)
        return res.t_cam_obj, res.code, res.loss

    return fn, example_inputs(device=dev)
