"""Sim(3) / SE(3) alignment: Horn closed form + batched RANSAC.

Counterpart of `dsp_slam_rgbd_tpu/solvers/sim3.py` (reference `Sim3Solver`,
`src/Sim3Solver.cc`): Horn's quaternion method on 3-point sets inside
RANSAC with mutual reprojection inlier checks (:226 ComputeSim3, :340
CheckInliers), scale fixed to 1 for stereo; all trials are one batched
eigendecomposition.  Also used for the loop's relative pose and for
trajectory alignment (ATE).

`solve_sim3_ransac` is a draw of the (n_trials, 3) sample indices
(`initializer.draw_indices`, from a CPU `torch.Generator`) and a
deterministic evaluation of a given index array
(`solve_sim3_from_indices`).  The Gauss-Newton refinement's Jacobian is
`torch.func.jacfwd` of the residuals, and its solve `linalg.solve_ex`:
no host sync.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from dsp_slam_rgbd_tpu_torch.ops import camera as cam_ops
from dsp_slam_rgbd_tpu_torch.ops import lie
from dsp_slam_rgbd_tpu_torch.solvers.initializer import draw_indices


def horn_align(p1: torch.Tensor, p2: torch.Tensor, weights=None,
               fix_scale: bool = False):
    """Closed-form s, R, t minimizing ‖p2 − (s·R·p1 + t)‖².

    p1, p2: (…, N, 3) correspondences (N ≥ 3).  Returns (…, 4, 4) Sim(3)
    T_21 (maps frame-1 points into frame 2).  Horn's quaternion method: the
    largest eigenvector of the 4x4 N-matrix (reference
    `Sim3Solver.cc:226-338`); its sign is free and q, −q give one R.
    """
    w = torch.ones_like(p1[..., 0]) if weights is None else weights
    wsum = torch.clamp_min(torch.sum(w, dim=-1), 1e-9)
    c1 = torch.einsum("...n,...ni->...i", w, p1) / wsum[..., None]
    c2 = torch.einsum("...n,...ni->...i", w, p2) / wsum[..., None]
    q1 = p1 - c1[..., None, :]
    q2 = p2 - c2[..., None, :]

    M = torch.einsum("...n,...ni,...nj->...ij", w, q1, q2)  # (3, 3) covariance
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], -2)
    _, vecs = torch.linalg.eigh(N)
    R = lie.quat_to_rot(vecs[..., :, -1])  # largest eigenvalue -> (w, x, y, z)

    if fix_scale:
        s = torch.ones_like(wsum)
    else:
        # symmetric scale: sqrt(Σ‖q2‖² / Σ‖q1‖²) (Horn's closed form)
        s = torch.sqrt(torch.einsum("...n,...ni,...ni->...", w, q2, q2)
                       / torch.clamp_min(torch.einsum("...n,...ni,...ni->...", w, q1, q1), 1e-12))
    t = c2 - s[..., None] * (R @ c1[..., None])[..., 0]
    return lie.rt_to_mat(s[..., None, None] * R, t)


class Sim3Result(NamedTuple):
    t_21: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    ok: torch.Tensor


def solve_sim3_from_indices(cam1, cam2, pts1_c, pts2_c, uv1, uv2, inv_sigma2_1,
                            inv_sigma2_2, valid, idx, fix_scale: bool = True,
                            chi2_th1: float = 9.210, chi2_th2: float = 9.210,
                            min_inliers: int = 6) -> Sim3Result:
    """RANSAC Sim(3) between two keyframes from 3D-3D matched map points,
    with the samples given: idx (n_trials, 3).

    pts1_c/pts2_c: (N, 3) matched points in each camera frame; uv1/uv2 their
    pixel observations; inlier check = mutual reprojection (reference
    `CheckInliers` :340: project p2 via T12 into image 1 and vice versa).
    """
    Ts = horn_align(pts1_c[idx], pts2_c[idx], fix_scale=fix_scale)  # (T, 4, 4)
    T12 = lie.inv_sim3(Ts)
    e2 = cam_ops.project(cam2, lie.transform_points(Ts, pts1_c[None])) - uv2
    e1 = cam_ops.project(cam1, lie.transform_points(T12, pts2_c[None])) - uv1
    chi1 = torch.sum(e1 * e1, -1) * inv_sigma2_1
    chi2 = torch.sum(e2 * e2, -1) * inv_sigma2_2
    inls = valid & (chi1 <= chi2_th1) & (chi2 <= chi2_th2)
    finite = torch.isfinite(Ts).flatten(1).all(1)
    scores = torch.where(finite, inls.sum(1), -1)
    best = torch.argmax(scores, 0, keepdim=True)   # (1,): a 0-d index reads the host
    inl, score = inls[best][0], scores[best][0]
    # refine on the best trial's inliers
    T_ref = horn_align(pts1_c, pts2_c, weights=inl.float(), fix_scale=fix_scale)
    T_ref = torch.where(torch.all(torch.isfinite(T_ref)), T_ref, Ts[best][0])
    return Sim3Result(T_ref, inl, score, score >= min_inliers)


def solve_sim3_ransac(cam1, cam2, pts1_c, pts2_c, uv1, uv2, inv_sigma2_1,
                      inv_sigma2_2, valid, generator: torch.Generator,
                      n_trials: int = 64, fix_scale: bool = True,
                      chi2_th1: float = 9.210, chi2_th2: float = 9.210,
                      min_inliers: int = 6) -> Sim3Result:
    """`draw_indices` (n_trials, 3) from the CPU `generator`, then
    `solve_sim3_from_indices`."""
    idx = draw_indices(valid, n_trials, 3, generator)
    return solve_sim3_from_indices(cam1, cam2, pts1_c, pts2_c, uv1, uv2, inv_sigma2_1,
                                   inv_sigma2_2, valid, idx, fix_scale=fix_scale,
                                   chi2_th1=chi2_th1, chi2_th2=chi2_th2,
                                   min_inliers=min_inliers)


def refine_sim3_gn(cam1, cam2, t_21, pts1_c, pts2_c, uv1, uv2, valid,
                   fix_scale: bool = True, n_iters: int = 10,
                   chi2_th: float = 10.0, huber: float = 3.1623,
                   damping: float = 1e-4):
    """Gauss–Newton refinement of a Sim(3) on 3D-3D pairs with mutual
    reprojection residuals (the reference's `OptimizeSim3`,
    `Optimizer.cc:1045`: one Sim3 vertex, paired forward/inverse projection
    edges, Huber δ=√10, 5 iterations → χ²>10 edge removal → 10 more).

    t_21 maps frame-1 coords into frame 2.  The reference's two-stage
    outlier handling becomes per-iteration re-gating after a warmup
    (iterations ≥ 3 drop pairs with either directional χ² > chi2_th).

    Returns (t_21_refined, inliers, n_inliers).
    """
    T = t_21.float()
    n = pts1_c.shape[0]
    zero7 = torch.zeros(7, device=T.device)
    eye7 = torch.eye(7, device=T.device)
    keep7 = (torch.arange(7, device=T.device) != 6).float()

    def residuals(delta, T):
        # (1, ·) batches: under forward AD, 0-d intermediates mixed with
        # Python scalars give f64 tangents
        Tn = (lie.exp_sim3(delta[None]) @ T)[0]
        e2 = cam_ops.project(cam2, lie.transform_points(Tn, pts1_c)) - uv2
        e1 = cam_ops.project(cam1, lie.transform_points(lie.inv_sim3(Tn[None])[0], pts2_c)) - uv1
        return torch.cat([e1, e2], dim=0)  # (2N, 2)

    def chi2_of(e):
        return torch.sum(e[:n] ** 2, -1), torch.sum(e[n:] ** 2, -1)

    gate = valid
    for i in range(n_iters):
        e = residuals(zero7, T)                     # (2N, 2)
        # re-gate after warmup (reference removes χ²>10 edges mid-way)
        if i >= 3:
            c1, c2 = chi2_of(e)
            gate = valid & (c1 <= chi2_th) & (c2 <= chi2_th)
        J = jacfwd(residuals)(zero7, T)             # (2N, 2, 7)
        m = torch.cat([gate, gate]).float()
        # Huber reweighting on the residual norm
        en = torch.sqrt(torch.clamp_min(torch.sum(e * e, -1), 1e-12))
        w = m * torch.clamp_max(huber / en, 1.0)
        H = torch.einsum("nri,n,nrj->ij", J, w, J)
        b = -torch.einsum("nri,n,nr->i", J, w, e)
        if fix_scale:
            # zero out the scale DOF (last tangent coordinate)
            H = H * keep7[:, None] * keep7[None, :] + (1.0 - keep7).diag()
            b = b * keep7
        H = H + damping * eye7 + 1e-8 * eye7
        delta = torch.linalg.solve_ex(H, b)[0]
        T_new = lie.exp_sim3(delta) @ T
        good = torch.all(torch.isfinite(T_new)) & (torch.sum(gate) >= 3)
        T = torch.where(good, T_new, T)
    c1, c2 = chi2_of(residuals(zero7, T))
    inl = valid & (c1 <= chi2_th) & (c2 <= chi2_th)
    return T, inl, torch.sum(inl)


def align_trajectories(est: torch.Tensor, gt: torch.Tensor, fix_scale: bool = False):
    """Align estimated camera centers (N, 3) to ground truth; returns
    (T_align, ate_rmse)."""
    T = horn_align(est, gt, fix_scale=fix_scale)
    err = torch.linalg.vector_norm(lie.transform_points(T, est) - gt, dim=-1)
    return T, torch.sqrt(torch.mean(err * err))
