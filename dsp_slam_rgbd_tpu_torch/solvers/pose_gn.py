"""Motion-only pose optimization (batched robust reprojection GN).

Counterpart of `dsp_slam_rgbd_tpu/solvers/pose_gn.py` (reference
`Optimizer::PoseOptimization`, `src/Optimizer.cc:239-451`): 4 rounds of 10
Gauss-Newton iterations with Huber IRLS, χ² re-gating at 5.991 (mono) /
7.815 (stereo) between rounds (outliers re-admitted when their χ²
recovers).  No host sync: the solve is `linalg.solve_ex` and a non-finite
step keeps the previous pose by `torch.where`.

Conventions: T_cw maps world -> camera; tangent [v, w] left-perturbation
(T_cw' = exp(dx) · T_cw).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from dsp_slam_rgbd_tpu_torch.ops import camera as cam_ops
from dsp_slam_rgbd_tpu_torch.ops import lie

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class PoseOptResult(NamedTuple):
    t_cw: torch.Tensor      # (4, 4) optimized pose
    inliers: torch.Tensor   # (N,) bool
    n_inliers: torch.Tensor # scalar int32


def _residuals_and_jac(cam, t_cw, pts_w, obs, stereo: bool):
    """Per-point residuals (N, D) and Jacobians (N, D, 6); D=2 mono, 3 stereo."""
    pc = lie.transform_points(t_cw, pts_w)  # (N, 3)
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zi = 1.0 / torch.clamp_min(z, 1e-6)
    zi2 = zi * zi

    pred = cam_ops.project_stereo(cam, pc) if stereo else cam_ops.project(cam, pc)
    res = pred - obs  # (N, D)

    zero = torch.zeros_like(z)
    du = torch.stack([cam.fx * zi, zero, -cam.fx * x * zi2], -1)
    dv = torch.stack([zero, cam.fy * zi, -cam.fy * y * zi2], -1)
    rows = [du, dv]
    if stereo:
        # uR = u − bf/z -> d uR/d pc = du + [0, 0, bf/z²]; observations
        # without a right match (uR = −1) act as mono edges
        dur = du + torch.stack([zero, zero, cam.bf * zi2], -1)
        has_ur = (obs[..., 2] >= 0.0).to(res.dtype)
        res = torch.cat([res[..., :2], (res[..., 2] * has_ur)[..., None]], -1)
        rows.append(dur * has_ur[..., None])
    dpred_dpc = torch.stack(rows, dim=-2)  # (N, D, 3)
    dpc_dxi = lie.points_to_pose_jacobian_se3(pc)  # (N, 3, 6)
    return res, dpred_dpc @ dpc_dxi  # (N, D, 6)


def optimize_pose(cam, t_cw0, pts_w, obs, inv_sigma2, valid,
                  stereo: bool = False, n_rounds: int = 4,
                  n_iters: int = 10) -> PoseOptResult:
    """Robust GN pose fit.

    obs: (N, 2) pixels or (N, 3) (u, v, uR); inv_sigma2: (N,) per-point
    information (1/σ² of the detection octave); valid: (N,) live slots.
    """
    chi2_th = CHI2_STEREO if stereo else CHI2_MONO
    delta = math.sqrt(chi2_th)
    eye6 = 1e-7 * torch.eye(6, dtype=torch.float32, device=pts_w.device)

    t_cw = torch.as_tensor(t_cw0, dtype=torch.float32, device=pts_w.device)
    inliers = valid.float()
    for _ in range(n_rounds):
        for _ in range(n_iters):
            res, J = _residuals_and_jac(cam, t_cw, pts_w, obs, stereo)
            # Huber IRLS weight on the whitened residual norm
            e2 = torch.sum(res * res, dim=-1) * inv_sigma2  # (N,) chi2
            en = torch.sqrt(torch.clamp_min(e2, 1e-12))
            w_huber = torch.where(en <= delta, 1.0, cam_ops.rdiv(delta, en))
            w = inv_sigma2 * w_huber * inliers
            Jw = J * w[:, None, None]
            H = torch.einsum("ndi,ndj->ij", Jw, J)
            b = -torch.einsum("ndi,nd->i", Jw, res)
            dx = torch.linalg.solve_ex(H + eye6, b)[0]
            t_new = lie.exp_se3(dx) @ t_cw
            t_cw = torch.where(torch.all(torch.isfinite(dx)), t_new, t_cw)
        # re-gate: χ² against threshold (outliers may re-enter, :399-417)
        res, _ = _residuals_and_jac(cam, t_cw, pts_w, obs, stereo)
        chi2 = torch.sum(res * res, dim=-1) * inv_sigma2
        inliers = (valid & (chi2 <= chi2_th)).float()
    inl = inliers > 0.5
    # every returned pose is re-projected onto SO(3) (lie.orthonormalize_so3)
    t_cw = lie.orthonormalize_se3(t_cw)
    return PoseOptResult(t_cw, inl, torch.sum(inl).to(torch.int32))
