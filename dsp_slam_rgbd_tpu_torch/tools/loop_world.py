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
descriptors).

`KITTI` is the same kind of circuit at KITTI size (`Circuit`): the KITTI
00-02 stereo camera (1241x376, fx 718.856, baseline 0.537 m, the principal
point of `sequence_dirs.KITTI_CALIB`), the surface 12 to 9 m away at about
one texel an image pixel, an ellipse of 90 frames a lap whose legs lie
farther apart than a frame's footprint, 14 frames into a second lap, and
six static objects of the fixture decoder's ellipsoid family
(`kitti_objects`): two near the start, seen on lap 1 and again on the
return, three along the legs, one past the far end.  `SMALL` is the
224x160 circuit above, whose frames `frames()` renders.  numpy and scipy
(the vocabulary: the port's ORB and k-medians).
"""
from __future__ import annotations

import math
from typing import NamedTuple

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


class Circuit(NamedTuple):
    """A circuit world: a stereo camera (R = I) at (x, y, 0) on the ellipse
    `loop_path(n_lap, extra, a, b)`, looking along z at the undulating
    tilted surface z = plane_z + tilt·X + bump_a·sin(bump_wx·X)·cos(bump_wy·Y),
    textured at tex_scale / 10 texels a metre by `make_texture(rng,
    shape=tex_shape)` (rows, cols)."""
    h: int
    w: int
    fx: float
    cx: float
    cy: float
    baseline: float
    plane_z: float
    tilt: float
    bump_a: float
    bump_wx: float
    bump_wy: float
    n_lap: int
    extra: int
    a: float
    b: float
    tex_scale: float
    tex_shape: tuple

    def path(self) -> list:
        return loop_path(self.n_lap, self.extra, self.a, self.b)

    def center(self, frame: int) -> np.ndarray:
        """The true camera center of `frame`."""
        return np.array([*self.path()[frame], 0.0])


# the 224x160 circuit of tests/test_long_run.py
SMALL = Circuit(h=H, w=W, fx=FX, cx=CX, cy=CY, baseline=BASE, plane_z=PLANE_Z, tilt=TILT,
                bump_a=BUMP_A, bump_wx=BUMP_WX, bump_wy=BUMP_WY, n_lap=N_LAP,
                extra=LAP2_EXTRA, a=4.0, b=2.5, tex_scale=450.0, tex_shape=(2048, 2048))
# the KITTI-size circuit: the small one's shape on the KITTI 00-02 camera,
# 4x farther, the surface tilted towards the camera along x (12 m deep at
# the start, 9 m at the far end).  At 12 m a pixel spans 1.7 cm, so 60
# texels a metre give about one texel a pixel (0.7-1.15 over the
# circuit; the small world's 45 texels a metre at fx 718 and 3 m would be
# magnified ~5x and starve FAST of corners); the texture spans x from -40
# to 40 m and y from -10 to 10 m, past what any frame sees, so nothing
# repeats.  The legs lie 2b = 8 m apart, more than a frame's ~6 m
# footprint in y there, and the far end (x = 2a) sees none of what frame
# 0 sees.  The camera moves 0.28 to 0.84 m a frame, the fastest along x in
# the middle of the legs (~57 px of flow at 10.6 m), the slowest along y
# at the start: frame 1's 17 px, which both packages' trackers follow
# before their motion model has a velocity (at 24 px they lose frame 1);
# a frame departs from the constant-velocity prediction by
# (2π/90)²·a·fx/z ≈ 4 px.
KITTI = Circuit(h=376, w=1241, fx=718.856, cx=607.1928, cy=185.2157, baseline=0.537,
                plane_z=12.0, tilt=-0.12, bump_a=0.36, bump_wx=2 * math.pi / 7.6,
                bump_wy=2 * math.pi / 5.2, n_lap=90, extra=14, a=12.0, b=4.0,
                tex_scale=600.0, tex_shape=(1200, 4800))


def make_texture(rng, shape=(2048, 2048)) -> np.ndarray:
    """Multi-octave noise (low octaves make patches distinctive for BoW)
    of `shape` (rows, cols)."""
    from scipy.ndimage import gaussian_filter

    t = np.zeros(shape)
    for sigma, w in ((1.2, 1.0), (6.0, 2.2), (24.0, 5.0), (80.0, 9.0)):
        t += w * gaussian_filter(rng.uniform(-1, 1, shape), sigma)
    t -= t.min()
    return (t * (255.0 / t.max())).astype(np.float32)


def render(texture, cam_x, cam_y=0.0, tex_scale=450.0) -> np.ndarray:
    """(H, W) f32 image of a camera at (cam_x, cam_y, 0) of the 224x160
    circuit looking along z."""
    return render_view(SMALL._replace(tex_scale=tex_scale), texture, cam_x, cam_y)


def render_view(c: Circuit, texture, cam_x, cam_y=0.0) -> np.ndarray:
    """(c.h, c.w) f32 image of a camera at (cam_x, cam_y, 0) of circuit `c`
    looking along z."""
    from scipy.ndimage import map_coordinates

    X, Y, _ = surface_points(c, cam_x, cam_y)
    tx = X * c.tex_scale / 10.0 + texture.shape[1] / 2
    ty = Y * c.tex_scale / 10.0 + texture.shape[0] / 2
    return map_coordinates(texture, [ty, tx], order=1, mode="wrap").astype(np.float32)


def surface_points(c: Circuit, cam_x, cam_y=0.0):
    """(X, Y, t): the world (x, y) where each pixel's ray meets the surface,
    and its depth t along z."""
    u, v = np.meshgrid(np.arange(c.w), np.arange(c.h))
    dx = (u - c.cx) / c.fx
    dy = (v - c.cy) / c.fx
    # ray ∩ surface by Newton from the planar solution
    t = (c.plane_z + c.tilt * cam_x) / (1.0 - c.tilt * dx)
    for _ in range(4):
        X = cam_x + dx * t
        Y = cam_y + dy * t
        f = t - (c.plane_z + c.tilt * X
                 + c.bump_a * np.sin(c.bump_wx * X) * np.cos(c.bump_wy * Y))
        df = 1.0 - c.tilt * dx - c.bump_a * (
            c.bump_wx * np.cos(c.bump_wx * X) * np.cos(c.bump_wy * Y) * dx
            - c.bump_wy * np.sin(c.bump_wx * X) * np.sin(c.bump_wy * Y) * dy)
        t = t - f / df
    return cam_x + dx * t, cam_y + dy * t, t


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
    """-> (path, [(left, right)]) of the whole 224x160 circuit."""
    texture = make_texture(np.random.default_rng(seed))
    xys = loop_path()
    return xys, [(render(texture, x, y), render(texture, x + BASE, y)) for x, y in xys]


def circuit_texture(c: Circuit, seed: int = 0) -> np.ndarray:
    return make_texture(np.random.default_rng(seed), shape=c.tex_shape)


def stereo_pair(c: Circuit, texture, frame: int):
    """(left, right) f32 images of `frame` of circuit `c`."""
    x, y = c.path()[frame]
    return render_view(c, texture, x, y), render_view(c, texture, x + c.baseline, y)


def kitti_objects(seed: int = 0) -> list:
    """The KITTI-size circuit's six static objects (`object_world.Truth`,
    the fixture decoder's family), 6-8 m from the camera's plane.  The
    object stage associates a detection with the nearest object on the
    camera's ground plane (x, z) within 4 m (`associate_detections`), and
    this camera also moves along y, so the objects stand at least 6 m
    apart in (x, z): truths 0 and 1 near the start, seen in lap 1's first
    6-8 frames and again from frame 80-85 on; 2 and 4 along the outbound
    leg (frames 19 and 35), 3 along the return (frame 64), 5 beyond the
    far end (frames 37-53)."""
    from dsp_slam_rgbd_tpu_torch.tools import object_world as ow

    return ow.make_objects([[-3.0, 0.3, 6.5], [3.0, -0.5, 8.0], [9.0, 3.9, 7.0],
                            [15.0, -3.9, 7.5], [21.0, 2.6, 6.5], [27.0, 0.0, 6.0]], seed=seed)


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


def lap_metrics(xys, ts, poses, ok, fps: float = 10.0, n_lap: int = N_LAP):
    """The long-run test's bars from a system's `_frame_poses()`: (ATE after
    a rigid alignment, the gap between the corrected poses at frames 0 and
    n_lap, the largest gap between a lap-2 frame and its lap-1 twin).  The
    camera centers come from the poses' inverses."""
    cen = np.linalg.inv(poses[ok])[:, :3, 3]
    fi = np.asarray([int(round(t * fps)) for t in ts[ok]])
    return center_metrics(xys, fi, cen, n_lap)


def center_metrics(xys, fi, cen, n_lap: int = N_LAP):
    """`lap_metrics` from the camera centers `cen` (n, 3) of frames `fi`
    (a trajectory file's rows)."""
    import torch

    from dsp_slam_rgbd_tpu_torch.solvers.sim3 import align_trajectories

    gt = np.asarray([[xys[f][0], xys[f][1], 0.0] for f in fi])
    _, ate = align_trajectories(torch.tensor(cen, dtype=torch.float32),
                                torch.tensor(gt, dtype=torch.float32), fix_scale=True)
    row = {int(f): r for r, f in enumerate(fi)}
    gap = float(np.linalg.norm(cen[row[n_lap]] - cen[row[0]])) \
        if n_lap in row and 0 in row else float("inf")
    lap2 = [(f, f - n_lap) for f in row if f >= n_lap + 6 and (f - n_lap) in row]
    d2 = max((float(np.linalg.norm(cen[row[a]] - cen[row[b]])) for a, b in lap2),
             default=float("inf"))
    return float(ate), gap, d2
