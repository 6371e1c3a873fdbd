"""A KITTI-00-scale synthetic map for bundle adjustment at scale.

The long-corridor map of `tests/test_ba_scale.py::build_corridor_map`
(same construction, same seed, so the same map), built with numpy: 1,000
keyframes a metre apart along +z, 200,000 points scattered around the
path and sorted by z, each keyframe observing 200 points 2-10 m ahead
(stereo observations with 0.3 px noise), and poses and points perturbed
so that BA has work to do.  `build_corridor_map` returns the `MapState`
fields as numpy arrays (`weights.map_state_from_numpy` puts them on a
device) with the ground-truth points and camera centers.
"""
from __future__ import annotations

import numpy as np

from dsp_slam_rgbd_tpu_torch.mapping import map_state as ms
from dsp_slam_rgbd_tpu_torch.ops.camera import Intrinsics
from dsp_slam_rgbd_tpu_torch.weights import map_state_to_numpy

CAM = Intrinsics(fx=700.0, fy=700.0, cx=600.0, cy=180.0, bf=380.0)


def _project(T_cw, pw):
    pc = pw @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = np.maximum(pc[:, 2], 1e-6)
    u = CAM.fx * pc[:, 0] / z + CAM.cx
    v = CAM.fy * pc[:, 1] / z + CAM.cy
    ur = u - CAM.bf / z
    return np.stack([u, v, ur], -1), pc[:, 2]


def build_corridor_map(n_kf=1000, n_pts=200_000, feat_per_kf=200,
                       noise=0.3, seed=0, max_kf=1024, max_pts=262_144):
    """-> ({MapState field: numpy array}, ground-truth points (n_pts, 3),
    ground-truth camera centers (n_kf, 3))."""
    rng = np.random.default_rng(seed)
    fields = map_state_to_numpy(ms.empty(max_kf=max_kf, max_feat=256, max_pts=max_pts,
                                         max_obj=4, code_len=4, max_oobs=16, device="cpu"))

    # ground-truth camera centers along +z
    centers = np.stack([0.05 * rng.standard_normal(n_kf), 0.05 * rng.standard_normal(n_kf),
                        np.arange(n_kf, dtype=np.float64)], -1).astype(np.float32)
    # points ahead of the path, sorted by z so a depth window is an index range
    pt_gt = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                      np.sort(rng.uniform(2, n_kf + 12.0, n_pts))], -1).astype(np.float32)

    kf_pose = np.tile(np.eye(4, dtype=np.float32), (max_kf, 1, 1))
    kf_pose[:n_kf, :3, 3] = -centers  # T_cw = [I | -c]
    kf_xy = np.zeros((max_kf, 256, 2), np.float32)
    kf_ur = np.full((max_kf, 256), -1.0, np.float32)
    kf_pt = np.full((max_kf, 256), -1, np.int32)
    kf_fv = np.zeros((max_kf, 256), bool)

    # each KF observes points 2-10 m ahead; ids are stride-aligned so
    # consecutive KFs co-observe most of their points (covisibility ~8 deep)
    pts_per_meter = n_pts / (n_kf + 10.0)
    window = int(8 * pts_per_meter)
    stride = max(window // feat_per_kf, 1)
    for k in range(n_kf):
        lo = int((k + 2) * pts_per_meter)
        lo = (lo + stride - 1) // stride * stride  # align to the stride grid
        ids = (lo + np.arange(feat_per_kf) * stride) % n_pts
        uv, z = _project(kf_pose[k], pt_gt[ids])
        ok = (z > 1.5) & (z < 12.0) & (np.abs(uv[:, 0] - CAM.cx) < 600) \
            & (np.abs(uv[:, 1] - CAM.cy) < 200)
        kf_xy[k, :feat_per_kf] = uv[:, :2] + 0.3 * rng.standard_normal((feat_per_kf, 2))
        kf_ur[k, :feat_per_kf] = uv[:, 2]
        kf_pt[k, :feat_per_kf] = np.where(ok, ids, -1)
        kf_fv[k, :feat_per_kf] = ok

    pt_pos = np.concatenate([
        pt_gt + noise * rng.standard_normal((n_pts, 3)).astype(np.float32),
        np.zeros((max_pts - n_pts, 3), np.float32)])
    # perturb the poses too (except KF 0, the gauge anchor)
    dp = (0.05 * rng.standard_normal((max_kf, 3))).astype(np.float32)
    dp[0] = 0
    kf_pose[:, :3, 3] += dp
    fields.update(
        kf_pose=kf_pose,
        kf_valid=np.arange(max_kf) < n_kf,
        kf_frame_id=np.where(np.arange(max_kf) < n_kf, np.arange(max_kf), -1).astype(np.int32),
        kf_xy=kf_xy, kf_ur=kf_ur, kf_feat_pt=kf_pt, kf_feat_valid=kf_fv,
        pt_pos=pt_pos,
        pt_valid=np.arange(max_pts) < n_pts,
        pt_ref_kf=np.zeros(max_pts, np.int32))
    return fields, pt_gt, centers
