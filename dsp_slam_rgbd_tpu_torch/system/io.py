"""Trajectory and map writers in the reference's text formats.

Counterpart of `dsp_slam_rgbd_tpu/system/io.py`, byte for byte: the same
rows as the reference's `SaveEntireMap` (`src/System_util.cc:109-149`:
MapPoints.txt, MapObjects.txt, Cameras.txt) and
`SaveTrajectoryTUM`/`SaveTrajectoryKITTI` (`src/System.cc:380-525`).
The writers run on the host in numpy f32; the camera-to-world inverse
(Rᵀ, −Rᵀt) and the rotation's quaternion repeat `ops/lie.py`'s
`inv_se3` and `rot_to_quat` in that arithmetic.
"""
from __future__ import annotations

import os

import numpy as np


def to_host(a) -> np.ndarray:
    """A tensor (any device) or array as a numpy array."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def fma32(a, b, c) -> np.ndarray:
    """a·b + c rounded once to f32 (a fused multiply-add), for f32 inputs:
    the product is exact in f64, the f64 sum's error is kept (TwoSum), and
    a sum that lands on an f32 rounding midpoint goes to the error's side."""
    a, b, c = (np.asarray(x, np.float32).astype(np.float64) for x in (a, b, c))
    p = a * b
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    r = s.astype(np.float32)
    other = np.nextafter(r, np.where(s > r, np.float32(np.inf), np.float32(-np.inf)))
    at_mid = (s == (r.astype(np.float64) + other.astype(np.float64)) / 2) & (err != 0)
    up = (err > 0) == (other > r)
    return np.where(at_mid & up, other, r)


def inv_se3(T: np.ndarray) -> np.ndarray:
    """(4, 4) f32 inverse of an SE(3) matrix: [Rᵀ | −Rᵀt], the product's
    terms accumulated in order with fused multiply-adds, as XLA's CPU dot
    does for the JAX package's `lie.inv_se3`."""
    T = np.asarray(T, np.float32)
    Rt = T[:3, :3].T
    t = T[:3, 3]
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = Rt
    out[:3, 3] = -fma32(Rt[:, 2], t[2], fma32(Rt[:, 1], t[1], Rt[:, 0] * t[0]))
    return out


def rot_to_quat(R: np.ndarray) -> np.ndarray:
    """(w, x, y, z) f32 unit quaternion of a rotation matrix: the
    best-conditioned of the four candidates, w >= 0."""
    R = np.asarray(R, np.float32)
    m00, m01, m02 = R[0]
    m10, m11, m12 = R[1]
    m20, m21, m22 = R[2]
    one, four = np.float32(1.0), np.float32(4.0)
    tr = m00 + m11 + m22
    qw = np.array([one + tr, one + m00 - m11 - m22, one - m00 + m11 - m22,
                   one - m00 - m11 + m22], np.float32)
    qw = np.sqrt(np.maximum(qw, np.float32(1e-12))) * np.float32(0.5)
    d = four * qw
    cand = np.array([
        [qw[0], (m21 - m12) / d[0], (m02 - m20) / d[0], (m10 - m01) / d[0]],
        [(m21 - m12) / d[1], qw[1], (m01 + m10) / d[1], (m02 + m20) / d[1]],
        [(m02 - m20) / d[2], (m01 + m10) / d[2], qw[2], (m12 + m21) / d[2]],
        [(m10 - m01) / d[3], (m02 + m20) / d[3], (m12 + m21) / d[3], qw[3]],
    ], np.float32)
    q = cand[int(np.argmax(qw))]
    return -q if q[0] < 0 else q


def save_trajectory_kitti(path: str, poses_cw, valid=None):
    """KITTI format: one row per frame, 12 floats of T_wc (3x4)."""
    poses_cw = to_host(poses_cw)
    with open(path, "w") as f:
        for i, T in enumerate(poses_cw):
            if valid is not None and not valid[i]:
                continue
            row = inv_se3(T)[:3, :].reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in row) + "\n")


def save_trajectory_tum(path: str, poses_cw, timestamps, valid=None):
    """TUM format: `timestamp tx ty tz qx qy qz qw` (camera-to-world)."""
    poses_cw = to_host(poses_cw)
    with open(path, "w") as f:
        for i, T in enumerate(poses_cw):
            if valid is not None and not valid[i]:
                continue
            Twc = inv_se3(T)
            q = rot_to_quat(Twc[:3, :3])
            t = Twc[:3, 3]
            f.write(f"{timestamps[i]:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                    f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")


def save_entire_map(dirname: str, state, frame_poses_cw=None, frame_valid=None):
    """MapPoints.txt (xyz rows), MapObjects.txt (id / 12-float Two(Sim3) /
    code rows), Cameras.txt (KITTI rows of keyframe poses), from one read of
    the state's fields."""
    os.makedirs(dirname, exist_ok=True)
    s = {k: to_host(getattr(state, k)) for k in (
        "pt_pos", "pt_valid", "obj_valid", "obj_dynamic", "obj_pose", "obj_scale", "obj_code",
        "kf_pose", "kf_valid")}
    with open(os.path.join(dirname, "MapPoints.txt"), "w") as f:
        for p in s["pt_pos"][s["pt_valid"]]:
            f.write(f"{p[0]:.9f} {p[1]:.9f} {p[2]:.9f}\n")

    obj_ok = s["obj_valid"] & ~s["obj_dynamic"]
    with open(os.path.join(dirname, "MapObjects.txt"), "w") as f:
        for oid in np.nonzero(obj_ok)[0]:
            Two = s["obj_pose"][oid].copy()
            Two[:3, :3] *= s["obj_scale"][oid]  # Sim(3) pose as in GetPoseSim3
            f.write(f"{oid}\n")
            f.write(" ".join(f"{v:.9f}" for v in Two[:3, :].reshape(-1)) + "\n")
            f.write(" ".join(f"{v:.9f}" for v in s["obj_code"][oid]) + "\n")

    save_trajectory_kitti(os.path.join(dirname, "Cameras.txt"), s["kf_pose"], s["kf_valid"])
    if frame_poses_cw is not None:
        save_trajectory_kitti(os.path.join(dirname, "FrameTrajectory.txt"), frame_poses_cw,
                              frame_valid)


def load_map_objects(path: str):
    """Parse MapObjects.txt back into (ids, Two(Sim3) (N, 4, 4), codes)."""
    ids, poses, codes = [], [], []
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    i = 0
    while i + 2 < len(lines):  # an id, a pose row and a code row
        ids.append(int(lines[i]))
        T = np.eye(4, dtype=np.float32)
        T[:3, :] = np.array(lines[i + 1].split(), np.float64).reshape(3, 4)
        poses.append(T)
        codes.append(np.array(lines[i + 2].split(), np.float64).astype(np.float32))
        i += 3
    return (np.asarray(ids), np.stack(poses) if poses else np.zeros((0, 4, 4)),
            np.stack(codes) if codes else np.zeros((0, 0)))
