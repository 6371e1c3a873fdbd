"""Seeded object observations of the fixture decoder's ellipsoid family.

A frozen, batched copy of the port's `tools/ellipsoid.py::make_problem`
(itself the construction of the JAX package's
`tests/test_trained_decoder_recon.py`): each object is an ellipsoid of
semi-axes `0.30 + 0.12 tanh(code[:3])` for a random 64-d code, seen from a
camera at the origin at scale `scale` and yaw `yaw_rad`, `distance` metres
ahead; the observation is its surface points, rays (a `fg_fraction` of them
foreground, with their first-hit depths, the rest background rays past the
silhouette) and a perturbed initial Sim(3) pose.  Camera y is down and the
object's up is -y_cam, as on KITTI.

`make_pool(params, seed)` draws `pool_batches` batches of
`objects_per_batch` objects from one `numpy.random.default_rng(seed)`, all
objects of a draw at once: the same seed gives the same pool.
"""
from __future__ import annotations

import numpy as np

CODE_LEN = 64


def code_to_axes(code: np.ndarray) -> np.ndarray:
    """The latent -> semi-axes map the fixture decoder was trained on."""
    return 0.30 + 0.12 * np.tanh(code[..., :3])


def _hat(w: np.ndarray) -> np.ndarray:
    z = np.zeros(w.shape[:-1])
    return np.stack([np.stack([z, -w[..., 2], w[..., 1]], -1),
                     np.stack([w[..., 2], z, -w[..., 0]], -1),
                     np.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def exp_sim3(x: np.ndarray) -> np.ndarray:
    """Sim(3) exponential of tangents [v, w, s] (..., 7) with theta > 0 and
    s != 0 (closed form), -> (..., 4, 4)."""
    v, w, s = x[..., :3], x[..., 3:6], x[..., 6]
    th = np.linalg.norm(w, axis=-1)
    W = _hat(w)
    WW = W @ W
    eye = np.eye(3)
    a1, a2 = (np.sin(th) / th)[..., None, None], ((1 - np.cos(th)) / th ** 2)[..., None, None]
    R = eye + a1 * W + a2 * WW
    es = np.exp(s)
    a, b = es * np.sin(th), es * np.cos(th)
    c = (es - 1.0) / s
    k1 = (a * s + (1.0 - b) * th) / (s * s + th * th)
    k2 = c - ((b - 1.0) * s + a * th) / (s * s + th * th)
    J = c[..., None, None] * eye + (k1 / th)[..., None, None] * W \
        + (k2 / th ** 2)[..., None, None] * WW
    T = np.zeros(x.shape[:-1] + (4, 4))
    T[..., :3, :3] = es[..., None, None] * R
    T[..., :3, 3] = (J @ v[..., None])[..., 0]
    T[..., 3, 3] = 1.0
    return T


def make_objects(rng, n: int, params: dict) -> dict:
    """n objects of the family -> float32 arrays: T_init (n, 4, 4), pts
    (n, N, 3), rays (n, R, 3), depth (n, R), fg_mask (n, R) bool, and the
    truth T_gt (n, 4, 4), code_gt (n, 64)."""
    n_pts, n_rays = int(params["points"]), int(params["rays"])
    s_gt, yaw = float(params["scale"]), float(params["yaw_rad"])
    t_gt = np.asarray(params["center_m"], np.float64)
    code_gt = rng.standard_normal((n, CODE_LEN))
    axes = code_to_axes(code_gt)[:, None, :]                       # (n, 1, 3)
    Ry = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]])
    R = Ry @ np.diag([1.0, -1.0, -1.0])
    sR = s_gt * R

    def on_surface(m, inflate=1.0):
        d = rng.standard_normal((n, m, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return (d * axes * inflate) @ sR.T + t_gt

    pts = on_surface(n_pts)
    n_fg = int(round(float(params["fg_fraction"]) * n_rays))
    p2 = on_surface(n_fg)
    rays_fg = p2 / np.linalg.norm(p2, axis=-1, keepdims=True)
    # first ray-ellipsoid hit (camera at the origin)
    u = (rays_fg @ R) / s_gt / axes
    v = ((-t_gt) @ R) / s_gt / axes
    a = np.sum(u * u, -1)
    b = 2.0 * np.sum(u * v, -1)
    c = np.sum(v * v, -1) - 1.0
    depth_fg = (-b - np.sqrt(np.maximum(b * b - 4 * a * c, 0.0))) / (2.0 * a)
    p3 = on_surface(n_rays - n_fg, float(params["bg_inflate"]))
    rays_bg = p3 / np.linalg.norm(p3, axis=-1, keepdims=True)

    sig_t, sig_r = float(params["sigma_t_m"]), float(params["sigma_r_rad"])
    dx = np.concatenate([rng.standard_normal((n, 3)) * sig_t, rng.standard_normal((n, 3)) * sig_r,
                         np.full((n, 1), float(params["log_scale_offset"]))], -1)
    T_gt = np.eye(4)
    T_gt[:3, :3] = sR
    T_gt[:3, 3] = t_gt
    T_init = exp_sim3(dx) @ T_gt
    f32 = np.float32
    return dict(T_init=T_init.astype(f32), pts=pts.astype(f32),
                rays=np.concatenate([rays_fg, rays_bg], 1).astype(f32),
                depth=np.concatenate([depth_fg, np.zeros((n, n_rays - n_fg))], 1).astype(f32),
                fg_mask=np.broadcast_to(np.arange(n_rays) < n_fg, (n, n_rays)).copy(),
                T_gt=np.broadcast_to(T_gt, (n, 4, 4)).astype(f32), code_gt=code_gt.astype(f32))


def make_pool(params: dict, seed: int) -> list[dict]:
    """`pool_batches` batches of `objects_per_batch` objects from the seed."""
    rng = np.random.default_rng(seed)
    B = int(params["objects_per_batch"])
    allobj = make_objects(rng, B * int(params["pool_batches"]), params)
    return [{k: v[i * B:(i + 1) * B] for k, v in allobj.items()}
            for i in range(int(params["pool_batches"]))]
