"""The synthetic tilted-plane world of the tracking tests and benchmarks.

A textured plane z = plane_z + tilt·X seen by a stereo (or RGB-D) camera
that translates along x; every image is an exact plane-homography sample
of one seeded texture, so the true poses and depths are known.  Three
presets: `SMALL`, the 224×160 world of `tests/test_system_e2e.py`;
`KITTI`, the KITTI-size world of `tools/bench_pipeline.py:25-31` (1241×376,
fx 718.856, baseline 0.537 m, plane 18 m away at tilt 0.3, 0.35 m a frame);
and `KITTI_FLOOR`, the same wall standing on a textured floor 1.65 m below
the camera (KITTI's camera height), moving 0.54 m a frame (the parallax of
`tests/test_mono_e2e.py`'s 0.3 m at 10 m): a scene with depth from 6 to 18
m that a monocular camera can initialize on by its fundamental matrix,
where a single plane leaves the homography's two motions to choose from.
numpy and scipy only.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class World(NamedTuple):
    h: int
    w: int
    fx: float
    baseline: float
    plane_z: float
    tilt: float
    step: float        # camera motion along x per frame (m)
    tex_scale: float
    tex_size: int
    floor: float = 0.0  # floor plane Y = floor below the camera (m); 0: none

    @property
    def cx(self):
        return self.w / 2

    @property
    def cy(self):
        return self.h / 2

    def center(self, frame: int) -> np.ndarray:
        """The true camera center of `frame`, (gt_x, 0, 0)."""
        return np.array([gt_x(self, frame), 0.0, 0.0])


SMALL = World(h=160, w=224, fx=200.0, baseline=0.5, plane_z=10.0, tilt=0.35,
              step=0.12, tex_scale=80.0, tex_size=2048)
KITTI = World(h=376, w=1241, fx=718.856, baseline=0.537, plane_z=18.0, tilt=0.3,
              step=0.35, tex_scale=40.0, tex_size=4096)
KITTI_FLOOR = KITTI._replace(step=0.54, floor=1.65)


def make_texture(world: World, seed: int = 0) -> np.ndarray:
    """The seeded Gaussian-filtered uniform texture (f32)."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    t = rng.uniform(0, 255, (world.tex_size, world.tex_size))
    return gaussian_filter(t, 1.2).astype(np.float32)


def _ray_depth(world: World, cam_x: float):
    """(dx, dy, t, on_floor): normalized ray offsets, the depth along z of
    the nearest surface for every pixel of a camera at world x = cam_x, and
    whether that surface is the floor."""
    u, v = np.meshgrid(np.arange(world.w), np.arange(world.h))
    dx = (u - world.cx) / world.fx
    dy = (v - world.cy) / world.fx
    t = (world.plane_z + world.tilt * cam_x) / (1.0 - world.tilt * dx)
    on_floor = np.zeros(t.shape, bool)
    if world.floor > 0:
        t_floor = world.floor / np.maximum(dy, 1e-9)
        on_floor = (dy > 0) & (t_floor < t)
        t = np.where(on_floor, t_floor, t)
    return dx, dy, t, on_floor


def render(world: World, texture: np.ndarray, cam_x: float) -> np.ndarray:
    """(h, w) f32 image of a camera at world (cam_x, 0, 0) looking along z:
    X = cam_x + dx·t, Y = dy·t, sampled bilinearly with wrap; the floor is
    textured by (X, Z), a quarter as finely along Z, whose pixels it
    foreshortens, from another part of the texture."""
    from scipy.ndimage import map_coordinates

    dx, dy, t, on_floor = _ray_depth(world, cam_x)
    X = cam_x + dx * t
    Y = np.where(on_floor, t / 4.0 + world.tex_size / 2 * 10.0 / world.tex_scale, dy * t)
    tx = X * world.tex_scale / 10.0 + texture.shape[1] / 2
    ty = Y * world.tex_scale / 10.0 + texture.shape[0] / 2
    return map_coordinates(texture, [ty, tx], order=1, mode="wrap").astype(np.float32)


def render_u8(world: World, texture: np.ndarray, cam_x: float) -> np.ndarray:
    """`render` as a camera gives it: uint8."""
    return np.clip(render(world, texture, cam_x), 0, 255).astype(np.uint8)


def depth_map(world: World, cam_x: float) -> np.ndarray:
    """Analytic depth of the scene for every pixel (f32)."""
    return _ray_depth(world, cam_x)[2].astype(np.float32)


def gt_x(world: World, frame: int) -> float:
    """True camera x of frame `frame`."""
    return frame * world.step
