"""The closed-circuit world of the long-run loop-closure test.

The port's copy of `tests/test_long_run.py`'s world (:33-160), so that the
port's tests and `chip_smoke.py` can drive a revisit through the system
loop: a textured tilted plane with a smooth undulation, about 3 m away,
seen by a 224x160 stereo camera driving an ellipse circuit in the plane's
(x, y) directions.  The outbound and return legs lie 5 m apart, more than
the field of view's footprint, so closing the circuit needs place
recognition and a Sim(3), as a KITTI 00 loop does; the path runs
`LAP2_EXTRA` frames into a second lap.  `train_vocab` is that test's
vocabulary helper (branching 8, depth 3, on every sixth frame's left
descriptors).  numpy and scipy (the vocabulary: the port's ORB and
k-medians).
"""
from __future__ import annotations

import math

import numpy as np

H, W = 160, 224
FX = 200.0
BASE = 0.5
PLANE_Z = 3.0
TILT = 0.12
CX, CY = W / 2, H / 2
# smooth undulation on the plane: a single plane leaves a gauge freedom
# (in-plane rotation + translation) that tracking drifts through
BUMP_A = 0.09
BUMP_WX = 2 * math.pi / 1.9
BUMP_WY = 2 * math.pi / 1.3
N_LAP = 100       # frames per lap
LAP2_EXTRA = 16   # frames driven into a second lap past the closure point


def make_texture(rng, size: int = 2048) -> np.ndarray:
    """Multi-octave noise (low octaves make patches distinctive for BoW)."""
    from scipy.ndimage import gaussian_filter

    t = np.zeros((size, size))
    for sigma, w in ((1.2, 1.0), (6.0, 2.2), (24.0, 5.0), (80.0, 9.0)):
        t += w * gaussian_filter(rng.uniform(-1, 1, (size, size)), sigma)
    t -= t.min()
    return (t * (255.0 / t.max())).astype(np.float32)


def _surface_z(X, Y):
    return PLANE_Z + TILT * X + BUMP_A * np.sin(BUMP_WX * X) * np.cos(BUMP_WY * Y)


def render(texture, cam_x, cam_y=0.0, tex_scale=450.0) -> np.ndarray:
    """(H, W) f32 image of a camera at (cam_x, cam_y, 0) looking along z."""
    from scipy.ndimage import map_coordinates

    u, v = np.meshgrid(np.arange(W), np.arange(H))
    dx = (u - CX) / FX
    dy = (v - CY) / FX
    # ray ∩ surface by Newton from the planar solution
    t = (PLANE_Z + TILT * cam_x) / (1.0 - TILT * dx)
    for _ in range(4):
        X = cam_x + dx * t
        Y = cam_y + dy * t
        f = t - _surface_z(X, Y)
        df = 1.0 - TILT * dx - BUMP_A * (
            BUMP_WX * np.cos(BUMP_WX * X) * np.cos(BUMP_WY * Y) * dx
            - BUMP_WY * np.sin(BUMP_WX * X) * np.sin(BUMP_WY * Y) * dy)
        t = t - f / df
    X = cam_x + dx * t
    Y = cam_y + dy * t
    tx = X * tex_scale / 10.0 + texture.shape[1] / 2
    ty = Y * tex_scale / 10.0 + texture.shape[0] / 2
    return map_coordinates(texture, [ty, tx], order=1, mode="wrap").astype(np.float32)


def loop_path(n_total: int = N_LAP, extra: int = LAP2_EXTRA, a: float = 4.0,
              b: float = 2.5) -> list:
    """(x, y) = (a(1 − cos θ), b sin θ), θ = 2πi/n, for n + 1 + extra frames."""
    return [(a * (1.0 - math.cos(2.0 * math.pi * i / n_total)),
             b * math.sin(2.0 * math.pi * i / n_total))
            for i in range(n_total + 1 + extra)]


def make_cfg(max_kf: int = 72):
    """The test's configuration, in the port's types."""
    from dsp_slam_rgbd_tpu_torch.config import MapConfig, SystemConfig, TrackingConfig
    from dsp_slam_rgbd_tpu_torch.frontend.orb import OrbConfig
    from dsp_slam_rgbd_tpu_torch.ops.camera import Intrinsics

    return SystemConfig(
        sensor="stereo", cam=Intrinsics(fx=FX, fy=FX, cx=CX, cy=CY, bf=FX * BASE),
        orb=OrbConfig(n_features=400, n_levels=3),
        tracking=TrackingConfig(fps=10.0, th_depth=30.0, min_frames_between_kf=2,
                                max_frames_between_kf=4, min_tracked_for_ok=25,
                                close_tracked_th=20, close_free_th=14),
        map=MapConfig(max_kf=max_kf, max_feat=512, max_pts=16384, max_obj=4, max_oobs=64,
                      local_window=6))


def frames(seed: int = 0):
    """-> (path, [(left, right)]) of the whole circuit."""
    texture = make_texture(np.random.default_rng(seed))
    xys = loop_path()
    return xys, [(render(texture, x, y), render(texture, x + BASE, y)) for x, y in xys]


def train_vocab(frames_lr, cfg, device="cuda"):
    """The test's vocabulary: branching 8, depth 3, on every sixth frame's
    left-image descriptors."""
    from dsp_slam_rgbd_tpu_torch.frontend import orb
    from dsp_slam_rgbd_tpu_torch.loop import vocabulary

    descs = []
    for i in range(0, len(frames_lr), 6):
        f = orb.extract(frames_lr[i][0], cfg.orb, device=device)
        descs.append(f.desc[f.valid].cpu().numpy())
    return vocabulary.train(np.concatenate(descs), branching=8, depth=3, device=device)


def lap_metrics(xys, ts, poses, ok, fps: float = 10.0):
    """The long-run test's bars from a system's `_frame_poses()`: (ATE after
    a Sim(3) alignment, the gap between the corrected poses at frames 0 and
    N_LAP, the largest gap between a lap-2 frame and its lap-1 twin).  The
    camera centers come from the poses' inverses."""
    import torch

    from dsp_slam_rgbd_tpu_torch.solvers.sim3 import align_trajectories

    cen = np.linalg.inv(poses[ok])[:, :3, 3]
    fi = np.asarray([int(round(t * fps)) for t in ts[ok]])
    gt = np.asarray([[xys[f][0], xys[f][1], 0.0] for f in fi])
    _, ate = align_trajectories(torch.tensor(cen, dtype=torch.float32),
                                torch.tensor(gt, dtype=torch.float32), fix_scale=True)
    row = {f: r for r, f in enumerate(fi)}
    gap = float(np.linalg.norm(cen[row[N_LAP]] - cen[row[0]])) \
        if N_LAP in row and 0 in row else float("inf")
    lap2 = [(f, f - N_LAP) for f in fi if f >= N_LAP + 6 and (f - N_LAP) in row]
    d2 = max((float(np.linalg.norm(cen[row[a]] - cen[row[b]])) for a, b in lap2),
             default=float("inf"))
    return float(ate), gap, d2
