"""Pinhole camera model: projection, backprojection, rays, undistortion.

Counterpart of `dsp_slam_rgbd_tpu/ops/camera.py`, same semantics, on
tensors.  `Intrinsics` stays a hashable NamedTuple of Python numbers, so a
config that holds one stays hashable; `K`/`K_inv` build CPU tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Intrinsics(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    # radial/tangential distortion (k1, k2, p1, p2, k3); zeros if rectified
    dist: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)
    # stereo baseline * fx (reference's `bf`); 0 for mono
    bf: float = 0.0

    @property
    def K(self):
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32,
        )

    @property
    def K_inv(self):
        return torch.tensor(
            [
                [1.0 / self.fx, 0.0, -self.cx / self.fx],
                [0.0, 1.0 / self.fy, -self.cy / self.fy],
                [0.0, 0.0, 1.0],
            ],
            dtype=torch.float32,
        )


def rdiv(a: float, t: torch.Tensor) -> torch.Tensor:
    """a / t as a true division (`float / tensor` in torch multiplies by
    the reciprocal: one rounding more than the JAX package's division)."""
    return torch.full_like(t, a) / t


def project(cam: Intrinsics, pts_cam: torch.Tensor) -> torch.Tensor:
    """(…, 3) camera-frame points -> (…, 2) pixels. No distortion."""
    z = pts_cam[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * pts_cam[..., 0] * inv_z + cam.cx
    v = cam.fy * pts_cam[..., 1] * inv_z + cam.cy
    return torch.stack([u, v], dim=-1)


def project_stereo(cam: Intrinsics, pts_cam: torch.Tensor) -> torch.Tensor:
    """(…, 3) -> (…, 3) pixels (u, v, uR) with uR = u − bf/z."""
    uv = project(cam, pts_cam)
    z = torch.clamp_min(pts_cam[..., 2], 1e-9)
    ur = uv[..., 0] - rdiv(cam.bf, z)
    return torch.cat([uv, ur[..., None]], dim=-1)


def backproject(cam: Intrinsics, uv: torch.Tensor,
                depth: torch.Tensor) -> torch.Tensor:
    """Pixels (…, 2) + depth (…,) -> camera-frame 3D points (…, 3)."""
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    return torch.stack([x * depth, y * depth, depth], dim=-1)


def pixel_rays(cam: Intrinsics, uv: torch.Tensor) -> torch.Tensor:
    """Pixels (…, 2) -> unnormalized ray directions (…, 3) with z = 1
    (reference `get_rays`, `loss_utils.py:23-37`: K⁻¹ [u, v, 1]ᵀ)."""
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def distort(cam: Intrinsics, xy: torch.Tensor) -> torch.Tensor:
    """Apply radtan distortion to normalized coords (…, 2)."""
    k1, k2, p1, p2, k3 = cam.dist
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_pixels(cam: Intrinsics, uv: torch.Tensor,
                     iters: int = 5) -> torch.Tensor:
    """Iteratively undistort pixel coords (…, 2) (cv::undistortPoints role):
    `iters` fixed-point steps xu ← (xd − tangential(xu)) / radial(xu)."""
    if all(d == 0.0 for d in cam.dist):
        return uv
    xd = torch.stack(
        [(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy], dim=-1
    )
    k1, k2, p1, p2, k3 = cam.dist
    xy = xd
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xy = torch.stack(
            [(xd[..., 0] - dx) / radial, (xd[..., 1] - dy) / radial], dim=-1
        )
    return torch.stack(
        [xy[..., 0] * cam.fx + cam.cx, xy[..., 1] * cam.fy + cam.cy], dim=-1
    )
