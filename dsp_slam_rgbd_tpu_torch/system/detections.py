"""Object detection container.

The port's own copy of `ObjectDetection` and `make_detection` from
`dsp_slam_rgbd_tpu/system/detections.py` (reference
`src/ObjectDetection.cc`: a Sim(3)/SE(3) pose measurement with the scale
factored out, surface points, rays and depths), in fixed-capacity form.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

MAX_SURFACE = 256   # reference caps LiDAR points at 250 (config num_lidar_max)
MAX_RAYS = 512      # fg rays + ≤200 background rays


class ObjectDetection(NamedTuple):
    """One detection, camera frame.  Fixed-size arrays + masks."""
    t_co: np.ndarray      # (4, 4) SE(3) object→camera pose measurement
    scale: float          # object scale (factored out of t_co)
    pts: np.ndarray       # (MAX_SURFACE, 3) surface points (camera frame)
    pts_mask: np.ndarray  # (MAX_SURFACE,)
    rays: np.ndarray      # (MAX_RAYS, 3) ray directions
    ray_mask: np.ndarray  # (MAX_RAYS,)
    depth: np.ndarray     # (MAX_RAYS,) observed depth (fg slots)
    fg_mask: np.ndarray   # (MAX_RAYS,) foreground flags


def make_detection(t_co_sim3: np.ndarray, pts=None, rays=None, depth=None,
                   n_fg: int | None = None) -> ObjectDetection:
    """Build a padded detection from ragged inputs.

    t_co_sim3 may be Sim(3): scale = det(R)^(1/3) is factored out
    (reference `ObjectDetection.cc:24-46` SetPoseMeasurementSim3).
    """
    t = np.asarray(t_co_sim3, np.float32).copy()
    scale = float(np.cbrt(np.linalg.det(t[:3, :3])))
    t[:3, :3] /= scale

    P = np.zeros((MAX_SURFACE, 3), np.float32)
    pm = np.zeros(MAX_SURFACE, bool)
    if pts is not None and len(pts):
        n = min(len(pts), MAX_SURFACE)
        P[:n] = pts[:n]
        pm[:n] = True

    R = np.zeros((MAX_RAYS, 3), np.float32)
    rm = np.zeros(MAX_RAYS, bool)
    D = np.zeros(MAX_RAYS, np.float32)
    fg = np.zeros(MAX_RAYS, bool)
    if rays is not None and len(rays):
        n = min(len(rays), MAX_RAYS)
        R[:n] = rays[:n]
        rm[:n] = True
        if depth is not None:
            nf = min(len(depth), n) if n_fg is None else min(n_fg, n)
            D[:nf] = np.asarray(depth)[:nf]
            fg[:nf] = True
    return ObjectDetection(t, scale, P, pm, R, rm, D, fg)
