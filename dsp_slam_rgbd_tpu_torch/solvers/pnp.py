"""Robust 3D→2D pose solving (relocalization), batched RANSAC.

Counterpart of `dsp_slam_rgbd_tpu/solvers/pnp.py` (reference `PnPsolver`,
EPnP + RANSAC, `src/PnPsolver.cc`): T minimal hypotheses solved as one
batch, inliers counted densely, the best polished by the robust GN of
`pose_gn`.  Each trial fits both the 6-point DLT and the planar homography
model and keeps whichever scores more inliers.  The minimal solvers take a
leading batch axis: `eigh` and `svd` run once over all trials.  Trial
samples come from an explicit `torch.Generator`, so their stream differs
from JAX's and parity is statistical.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from dsp_slam_rgbd_tpu_torch.ops import camera as cam_ops
from dsp_slam_rgbd_tpu_torch.ops import lie
from dsp_slam_rgbd_tpu_torch.solvers import pose_gn


def _dlt_pnp(pts_w: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """Minimal linear PnP: (…, K, 3) world pts + (…, K, 2) normalized image
    pts -> (…, 4, 4) T_cw.  K ≥ 6."""
    hom = torch.cat([pts_w, torch.ones_like(pts_w[..., :1])], dim=-1)  # (…, K, 4)
    zero = torch.zeros_like(hom)
    r1 = torch.cat([hom, zero, -xn[..., :1] * hom], dim=-1)  # (…, K, 12)
    r2 = torch.cat([zero, hom, -xn[..., 1:2] * hom], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # (…, 2K, 12)
    AtA = A.transpose(-1, -2) @ A
    _, vecs = torch.linalg.eigh(AtA)
    p = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 4))
    # P ≃ s·[R | t]; s = cbrt(det) recovers sign AND scale (the ±p nullspace
    # ambiguity cancels: −p gives −s and the same R, t)
    s = lie.cbrt(torch.linalg.det(p[..., :3]))
    s = torch.where(torch.abs(s) < 1e-12, 1e-12, s)
    R_raw = p[..., :3] / s[..., None, None]
    t = p[..., 3] / s[..., None]
    # project onto SO(3)
    U, _, Vt = torch.linalg.svd(R_raw)
    d = torch.linalg.det(U @ Vt)
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    return lie.rt_to_mat(U @ D @ Vt, t)


def _planar_pnp(pts_w: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """Planar minimal PnP by homography decomposition (IPPE/EPnP-planar
    role, reference `PnPsolver.cc:667-858`): fit the sample's plane, solve
    the 2D→2D homography H ≃ [R·e1 | R·e2 | R·c + t] and re-orthonormalize
    its first two columns.  (…, K, 3), (…, K, 2) -> (…, 4, 4)."""
    c = torch.mean(pts_w, dim=-2)
    Q = pts_w - c[..., None, :]
    _, _, Vt = torch.linalg.svd(Q, full_matrices=False)
    e1, e2 = Vt[..., 0, :], Vt[..., 1, :]
    w = torch.stack([(Q * e1[..., None, :]).sum(-1),
                     (Q * e2[..., None, :]).sum(-1)], dim=-1)  # (…, K, 2)
    hw = torch.cat([w, torch.ones_like(w[..., :1])], dim=-1)   # (…, K, 3)
    zero = torch.zeros_like(hw)
    r1 = torch.cat([hw, zero, -xn[..., :1] * hw], dim=-1)
    r2 = torch.cat([zero, hw, -xn[..., 1:2] * hw], dim=-1)
    A = torch.cat([r1, r2], dim=-2)                           # (…, 2K, 9)
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    H = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 3))
    # sign: plane origin must sit in front of the camera (depth = H[2,2])
    H = H * torch.where(H[..., 2, 2] < 0, -1.0, 1.0)[..., None, None]
    s = torch.sqrt(torch.clamp_min(
        torch.linalg.vector_norm(H[..., :, 0], dim=-1)
        * torch.linalg.vector_norm(H[..., :, 1], dim=-1), 1e-12))
    h12 = H[..., :, :2] / s[..., None, None]
    # closest orthonormal 3x2 column pair
    U, _, Vt2 = torch.linalg.svd(h12, full_matrices=False)
    r12 = U @ Vt2
    r3 = torch.linalg.cross(r12[..., :, 0], r12[..., :, 1], dim=-1)
    Rp = torch.stack([r12[..., :, 0], r12[..., :, 1], r3], dim=-1)  # camera←plane
    B = torch.stack([e1, e2, torch.linalg.cross(e1, e2, dim=-1)], dim=-1)  # world←plane
    R = Rp @ B.transpose(-1, -2)
    t = H[..., :, 2] / s[..., None] - (R @ c[..., None])[..., 0]
    return lie.rt_to_mat(R, t)


class PnPResult(NamedTuple):
    t_cw: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    ok: torch.Tensor


def solve_pnp_ransac(cam, pts_w, uv, inv_sigma2, valid, generator: torch.Generator,
                     n_trials: int = 128, sample_size: int = 6,
                     chi2_th: float = 5.991,
                     min_inliers: int = 10) -> PnPResult:
    """Fixed-trial batched RANSAC + GN polish.

    pts_w (N, 3), uv (N, 2) pixel observations, valid (N,) live matches;
    `generator` (on the tensors' device) draws the trial samples.
    """
    xn = cam_ops.pixel_rays(cam, uv)[:, :2]

    # trial index sets biased to valid slots (with replacement, as
    # `jax.random.choice(replace=True, p=)`)
    p = valid.float()
    p = p / torch.clamp_min(p.sum(), 1.0)
    p = torch.where(p.sum() > 0, p, torch.ones_like(p))
    idx = torch.multinomial(p, n_trials * sample_size, replacement=True,
                            generator=generator).reshape(n_trials, sample_size)

    def score(T):  # (T, 4, 4) -> (T,) inlier counts, −1 for a non-finite pose
        pc = lie.transform_points(T, pts_w[None])             # (T, N, 3)
        err = cam_ops.project(cam, pc) - uv[None]
        chi2 = torch.sum(err * err, dim=-1) * inv_sigma2[None]
        inl = valid[None] & (chi2 <= chi2_th) & (pc[..., 2] > 0)
        finite = torch.isfinite(T).flatten(1).all(1)
        return torch.where(finite, inl.sum(1), -1)

    T_g = _dlt_pnp(pts_w[idx], xn[idx])
    T_p = _planar_pnp(pts_w[idx], xn[idx])
    s_g, s_p = score(T_g), score(T_p)
    scores = torch.maximum(s_g, s_p)
    Ts = torch.where((s_g >= s_p)[:, None, None], T_g, T_p)
    best = torch.argmax(scores)
    T0 = Ts[best]

    # polish with robust GN over all tentative inliers
    res = pose_gn.optimize_pose(cam, T0, pts_w, uv, inv_sigma2, valid, stereo=False)
    ok = (res.n_inliers >= min_inliers) & (scores[best] > 0)
    return PnPResult(res.t_cw, res.inliers, res.n_inliers, ok)
