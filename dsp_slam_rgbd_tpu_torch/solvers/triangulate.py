"""Two-view DLT triangulation + epipolar checks, batched.

Counterpart of `dsp_slam_rgbd_tpu/solvers/triangulate.py`: reference
`Initializer::Triangulate` (`src/Initializer.cc:734`) and the acceptance
tests of `LocalMapping::CreateNewMapPoints` (`src/LocalMapping.cc:259`):
parallax, positive depth and reprojection error come back as masks for the
caller to combine.
"""
from __future__ import annotations

import torch

from dsp_slam_rgbd_tpu_torch.ops import camera as cam_ops
from dsp_slam_rgbd_tpu_torch.ops import lie


def _dlt_rows(P1, P2, x1, x2):
    """(N, 4, 4) rows x·P₃ − P₁, y·P₃ − P₂ of both views."""
    return torch.stack([
        x1[..., 0, None] * P1[2] - P1[0],
        x1[..., 1, None] * P1[2] - P1[1],
        x2[..., 0, None] * P2[2] - P2[0],
        x2[..., 1, None] * P2[2] - P2[1],
    ], dim=-2)


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, x1: torch.Tensor,
                    x2: torch.Tensor) -> torch.Tensor:
    """DLT: projection matrices (3, 4) + normalized image points (N, 2) ->
    world points (N, 3), from the eigenvector of AᵀA with the smallest
    eigenvalue (its sign cancels in the divide by w)."""
    rows = _dlt_rows(P1, P2, x1, x2)
    AtA = torch.einsum("nij,nik->njk", rows, rows)
    _, vecs = torch.linalg.eigh(AtA)  # ascending eigenvalues
    X = vecs[..., 0]
    w = X[..., 3]
    w = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    return X[..., :3] / w[..., None]


def triangulate_two_views(cam1, cam2, t1_cw, t2_cw, uv1, uv2):
    """Pixel observations in two frames -> world points (N, 3), in
    normalized coordinates (K⁻¹ applied) for a well-conditioned DLT."""
    x1 = cam_ops.pixel_rays(cam1, uv1)[..., :2]
    x2 = cam_ops.pixel_rays(cam2, uv2)[..., :2]
    return triangulate_dlt(t1_cw[:3, :], t2_cw[:3, :], x1, x2)


def _solve3x3_sym(A, b, damping: float = 1e-8):
    """Batched closed-form solve of symmetric 3x3 systems via the adjugate
    (elementwise, no factorization)."""
    a00 = A[..., 0, 0] + damping
    a01 = A[..., 0, 1]
    a02 = A[..., 0, 2]
    a11 = A[..., 1, 1] + damping
    a12 = A[..., 1, 2]
    a22 = A[..., 2, 2] + damping
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = torch.where(torch.abs(det) > 1e-20, cam_ops.rdiv(1.0, det), 0.0)
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x = torch.stack([
        c00 * b0 + c01 * b1 + c02 * b2,
        c01 * b0 + c11 * b1 + c12 * b2,
        c02 * b0 + c12 * b1 + c22 * b2,
    ], dim=-1)
    return x * inv_det[..., None]


def triangulate_two_views_fast(cam1, cam2, t1_cw, t2_cw, uv1, uv2):
    """Inhomogeneous DLT: the residual of `triangulate_two_views` with the
    point's homogeneous coordinate pinned to 1, solved per point as a
    closed-form symmetric 3x3 normal equation.  The world origin is shifted
    to the two camera centers' midpoint first, so that the translation
    columns are ~the baseline rather than ~the absolute position (f32
    conditioning on long trajectories).  Low-parallax solutions are
    garbage-but-finite and die at the caller's parallax/reprojection gates."""
    t1_wc = lie.inv_se3(t1_cw)
    t2_wc = lie.inv_se3(t2_cw)
    m = 0.5 * (t1_wc[:3, 3] + t2_wc[:3, 3])      # origin shift
    # T_cw' for world' = world − m: R unchanged, t' = t + R·m
    P1 = torch.cat([t1_cw[:3, :3], (t1_cw[:3, 3] + t1_cw[:3, :3] @ m)[:, None]], dim=1)
    P2 = torch.cat([t2_cw[:3, :3], (t2_cw[:3, 3] + t2_cw[:3, :3] @ m)[:, None]], dim=1)
    x1 = cam_ops.pixel_rays(cam1, uv1)[..., :2]
    x2 = cam_ops.pixel_rays(cam2, uv2)[..., :2]
    rows = _dlt_rows(P1, P2, x1, x2)    # A·[p; 1] ≈ 0  →  A[:, :3]·p = −A[:, 3]
    A = rows[..., :3]
    b = -rows[..., 3]
    AtA = torch.einsum("nij,nik->njk", A, A)
    Atb = torch.einsum("nij,ni->nj", A, b)
    return _solve3x3_sym(AtA, Atb) + m[None, :]


def acceptance_masks(cam1, cam2, t1_cw, t2_cw, pts_w, uv1, uv2,
                     reproj_chi2: float = 5.991, inv_sigma2_1=1.0,
                     inv_sigma2_2=1.0, min_parallax_cos: float = 0.9998):
    """Reference `CreateNewMapPoints` gates as masks: dict of (N,) bools
    "parallax", "depth", "reproj"."""
    c1 = lie.inv_se3(t1_cw)[:3, 3]
    c2 = lie.inv_se3(t2_cw)[:3, 3]
    r1 = pts_w - c1
    r2 = pts_w - c2
    cosp = torch.sum(r1 * r2, dim=-1) / torch.clamp_min(
        torch.linalg.vector_norm(r1, dim=-1) * torch.linalg.vector_norm(r2, dim=-1), 1e-9)
    parallax_ok = cosp < min_parallax_cos

    p1 = lie.transform_points(t1_cw, pts_w)
    p2 = lie.transform_points(t2_cw, pts_w)
    depth_ok = (p1[..., 2] > 0) & (p2[..., 2] > 0)

    e1 = cam_ops.project(cam1, p1) - uv1
    e2 = cam_ops.project(cam2, p2) - uv2
    chi1 = torch.sum(e1 * e1, dim=-1) * inv_sigma2_1
    chi2_ = torch.sum(e2 * e2, dim=-1) * inv_sigma2_2
    reproj_ok = (chi1 <= reproj_chi2) & (chi2_ <= reproj_chi2)
    return {"parallax": parallax_ok, "depth": depth_ok, "reproj": reproj_ok}
