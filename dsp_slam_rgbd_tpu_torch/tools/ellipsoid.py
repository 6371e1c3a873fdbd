"""Seeded ellipsoid fitting problems for the committed fixture decoder.

`tests/fixtures/ellipsoid_decoder_64.npz` is a cars_64-layout DeepSDF
decoder trained on an ellipsoid family whose semi-axes are
`code_to_axes(code)`.  `make_problem` builds one object observation of that
family in numpy (the same construction as the JAX package's
tests/test_trained_decoder_recon.py): a true Sim(3) pose, surface points,
foreground rays with their first-hit depths, background rays past the
silhouette, and a perturbed initial pose.  Camera y is down and the
object's up is −y_cam, as on KITTI.
"""
from __future__ import annotations

import os

import numpy as np

FIXTURE = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                                        "tests", "fixtures", "ellipsoid_decoder_64.npz"))


def code_to_axes(code: np.ndarray) -> np.ndarray:
    """The latent→semi-axes map the fixture was trained on."""
    return 0.30 + 0.12 * np.tanh(code[..., :3])


def _exp_sim3(x: np.ndarray) -> np.ndarray:
    """Sim(3) exponential of a tangent [v, w, s] (closed form, θ > 0)."""
    v, w, s = x[:3], x[3:6], x[6]
    th = np.linalg.norm(w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    R = np.eye(3) + np.sin(th) / th * W + (1 - np.cos(th)) / th ** 2 * (W @ W)
    es = np.exp(s)
    a, b = es * np.sin(th), es * np.cos(th)
    c = (es - 1.0) / s
    k1 = (a * s + (1.0 - b) * th) / (s * s + th * th)
    k2 = c - ((b - 1.0) * s + a * th) / (s * s + th * th)
    J = c * np.eye(3) + k1 / th * W + k2 / th ** 2 * (W @ W)
    T = np.eye(4)
    T[:3, :3] = es * R
    T[:3, 3] = J @ v
    return T


def make_problem(seed: int, n_pts: int = 128, n_rays: int = 128) -> dict:
    """One observed ellipsoid 8 m ahead at scale 2; 3/4 of the rays are
    foreground.  Arrays are float32 numpy."""
    rng = np.random.default_rng(seed)
    code_gt = rng.standard_normal(64).astype(np.float32)
    axes = code_to_axes(code_gt)
    s_gt, yaw = 2.0, 0.35
    Ry = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                   [-np.sin(yaw), 0, np.cos(yaw)]])
    R = Ry @ np.diag([1.0, -1.0, -1.0])
    t_gt = np.array([0.5, -0.2, 8.0])
    T_co_gt = np.eye(4)
    T_co_gt[:3, :3] = s_gt * R
    T_co_gt[:3, 3] = t_gt

    obs = observe(rng, axes, T_co_gt, n_pts, n_rays)
    return dict(T_co_gt=T_co_gt.astype(np.float32), t_gt=t_gt.astype(np.float32), s_gt=s_gt,
                R=R.astype(np.float32), code_gt=code_gt, **obs)


def observe(rng, axes: np.ndarray, T_co_gt: np.ndarray, n_pts: int, n_rays: int,
            sigma=(0.15, 0.03), at_object: bool = False) -> dict:
    """One observation of the ellipsoid of semi-axes `axes` at the true
    Sim(3) pose T_co_gt (camera at the origin): surface points, rays (3/4
    foreground, with their first-hit depths along the ray, then background
    rays past the silhouette) and a perturbed initial pose `T_init`, drawn
    from `rng` in that order.  The perturbation is a Sim(3) tangent of
    translation and rotation noise `sigma` (σ per axis) and log-scale
    +0.05, applied in the camera frame, or with `at_object` about the
    object's center (the rotation and scale then move the object's center
    by nothing).  Arrays are float32 numpy."""
    s_gt = np.cbrt(np.linalg.det(T_co_gt[:3, :3]))
    R = T_co_gt[:3, :3] / s_gt
    t_gt = T_co_gt[:3, 3]

    def on_surface(n, inflate=1.0):
        d = rng.standard_normal((n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return (T_co_gt[:3, :3] @ (d * axes * inflate).T).T + t_gt

    pts = on_surface(n_pts)
    n_fg = (3 * n_rays) // 4
    p2 = on_surface(n_fg)
    rays_fg = p2 / np.linalg.norm(p2, axis=1, keepdims=True)
    # first ray-ellipsoid hit (camera at the origin)
    u = (R.T @ rays_fg.T).T / s_gt / axes
    v = (R.T @ (-t_gt)) / s_gt / axes
    a, b, c = np.sum(u * u, axis=1), 2.0 * u @ v, v @ v - 1.0
    depth_fg = (-b - np.sqrt(np.maximum(b * b - 4 * a * c, 0.0))) / (2.0 * a)
    p3 = on_surface(n_rays - n_fg, inflate=1.35)
    rays_bg = p3 / np.linalg.norm(p3, axis=1, keepdims=True)

    dx = np.concatenate([rng.standard_normal(3) * sigma[0], rng.standard_normal(3) * sigma[1],
                         [0.05]])
    if at_object:
        E = _exp_sim3(np.concatenate([np.zeros(3), dx[3:]]))
        T_init = T_co_gt.copy()
        T_init[:3, :3] = E[:3, :3] @ T_co_gt[:3, :3]
        T_init[:3, 3] += dx[:3]
    else:
        T_init = _exp_sim3(dx) @ T_co_gt
    f32 = np.float32
    return dict(
        T_init=T_init.astype(f32), pts=pts.astype(f32),
        rays=np.concatenate([rays_fg, rays_bg]).astype(f32),
        depth=np.concatenate([depth_fg, np.zeros(n_rays - n_fg)]).astype(f32),
        fg_mask=np.arange(n_rays) < n_fg)


def pose_errors(T: np.ndarray, problem: dict) -> tuple[float, float, float]:
    """(translation error m, scale error, rotation error deg) of a fitted
    (4, 4) t_cam_obj against the problem's truth."""
    s = np.cbrt(np.linalg.det(T[:3, :3]))
    cosang = (np.trace((T[:3, :3] / s).T @ problem["R"]) - 1) / 2
    return (float(np.linalg.norm(T[:3, 3] - problem["t_gt"])), float(abs(s - problem["s_gt"])),
            float(np.degrees(np.arccos(np.clip(cosang, -1, 1)))))
