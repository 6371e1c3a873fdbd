"""A KITTI-00-scale corridor map, remade from a seed.

After the port's `tools/corridor_map.py::build_corridor_map` (the
construction of `tests/test_ba_scale.py`): keyframes a metre apart along
+z, points scattered around the path and sorted by z, each keyframe
observing `features_per_keyframe` points from 4 m ahead (stereo
observations with pixel noise), then the points and every keyframe but the
first perturbed so that bundle adjustment has work to do.  Unlike the
original, which takes every `stride`-th point id and so leaves all but one
point in `stride` unseen, a keyframe observes consecutive points, found by
their depth, so the map's points are the points the BA solves (all but the
few at the corridor's ends that no keyframe sees, which the map does not
hold); each point is seen by about `features_per_keyframe` x `keyframes`
/ `points` keyframes.

`build(map_params, traffic, seed)` returns every field of the port's
`MapState` as a numpy array (the fields the construction leaves alone at
the values an empty map holds), so that the harness can hand them to the
program and the reference alike.
"""
from __future__ import annotations

import numpy as np


def _project(cam, T_cw, pw):
    pc = pw @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = np.maximum(pc[:, 2], 1e-6)
    u = cam["fx"] * pc[:, 0] / z + cam["cx"]
    v = cam["fy"] * pc[:, 1] / z + cam["cy"]
    ur = u - cam["bf"] / z
    return np.stack([u, v, ur], -1), pc[:, 2]


def empty_fields(K: int, F: int, P: int, O: int, L: int, Q: int) -> dict:
    """The fields of an empty map of capacities (K keyframes, F features a
    keyframe, P points, O objects, code length L, Q object observations)."""
    f32, i32 = np.float32, np.int32
    eyes = lambda n: np.tile(np.eye(4, dtype=f32), (n, 1, 1))  # noqa: E731
    return dict(
        kf_pose=eyes(K), kf_valid=np.zeros(K, bool), kf_frame_id=np.full(K, -1, i32),
        kf_xy=np.zeros((K, F, 2), f32), kf_level=np.zeros((K, F), i32),
        kf_desc=np.zeros((K, F, 8), np.uint32), kf_ur=np.full((K, F), -1.0, f32),
        kf_feat_valid=np.zeros((K, F), bool), kf_feat_pt=np.full((K, F), -1, i32),
        pt_pos=np.zeros((P, 3), f32), pt_valid=np.zeros(P, bool),
        pt_desc=np.zeros((P, 8), np.uint32), pt_normal=np.zeros((P, 3), f32),
        pt_min_d=np.zeros(P, f32), pt_max_d=np.full(P, np.inf, f32),
        pt_ref_kf=np.full(P, -1, i32), pt_visible=np.ones(P, i32), pt_found=np.ones(P, i32),
        pt_first_kf=np.full(P, -1, i32), pt_object=np.full(P, -1, i32),
        pt_outlier=np.zeros(P, bool),
        obj_pose=eyes(O), obj_scale=np.ones(O, f32), obj_code=np.zeros((O, L), f32),
        obj_valid=np.zeros(O, bool), obj_dynamic=np.zeros(O, bool),
        obj_velocity=np.zeros((O, 3), f32), obj_n_obs=np.zeros(O, i32),
        obj_last_kf=np.full(O, -1, i32), obj_ref_kfseq=np.full(O, -1, i32),
        obj_recon=np.zeros(O, bool), obj_bbox_min=np.full((O, 3), -1.0, f32),
        obj_bbox_max=np.ones((O, 3), f32),
        oobs_kf=np.full(Q, -1, i32), oobs_obj=np.full(Q, -1, i32), oobs_t_co=eyes(Q),
        oobs_valid=np.zeros(Q, bool))


def build(m: dict, traffic: dict, seed: int) -> dict:
    """m: the configuration's map (keyframes, points, features_per_keyframe,
    capacities, camera); traffic: the perturbation (pixel_noise,
    point_noise_m, pose_noise_m).  -> {MapState field: numpy array}."""
    n_kf, n_pts, feat = int(m["keyframes"]), int(m["points"]), int(m["features_per_keyframe"])
    K, F, P = int(m["max_kf"]), int(m["max_feat"]), int(m["max_pts"])
    cam = m["camera"]
    rng = np.random.default_rng(seed)
    fields = empty_fields(K, F, P, int(m["max_obj"]), int(m["obj_code_len"]), int(m["max_oobs"]))

    centers = np.stack([0.05 * rng.standard_normal(n_kf), 0.05 * rng.standard_normal(n_kf),
                        np.arange(n_kf, dtype=np.float64)], -1).astype(np.float32)
    pt_gt = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                      np.sort(rng.uniform(2, n_kf + 12.0, n_pts))], -1).astype(np.float32)

    kf_pose = fields["kf_pose"]
    kf_pose[:n_kf, :3, 3] = -centers  # T_cw = [I | -c]
    kf_xy, kf_ur = fields["kf_xy"], fields["kf_ur"]
    kf_pt, kf_fv = fields["kf_feat_pt"], fields["kf_feat_valid"]
    # each keyframe observes the `feat` points that follow the first one
    # 4 m ahead of it in depth, so consecutive keyframes co-observe most of
    # their points and every point but a few at the corridor's ends is seen
    first = np.searchsorted(pt_gt[:, 2], centers[:, 2] + 4.0)
    px = float(traffic["pixel_noise"])
    for k in range(n_kf):
        ids = (first[k] + np.arange(feat)) % n_pts
        uv, z = _project(cam, kf_pose[k], pt_gt[ids])
        ok = (z > 1.5) & (z < 12.0) & (np.abs(uv[:, 0] - cam["cx"]) < 600) \
            & (np.abs(uv[:, 1] - cam["cy"]) < 200)
        kf_xy[k, :feat] = uv[:, :2] + px * rng.standard_normal((feat, 2))
        kf_ur[k, :feat] = uv[:, 2]
        kf_pt[k, :feat] = np.where(ok, ids, -1)
        kf_fv[k, :feat] = ok

    fields["pt_pos"][:n_pts] = pt_gt + float(traffic["point_noise_m"]) * \
        rng.standard_normal((n_pts, 3)).astype(np.float32)
    dp = (float(traffic["pose_noise_m"]) * rng.standard_normal((K, 3))).astype(np.float32)
    dp[0] = 0   # keyframe 0 is the gauge anchor
    kf_pose[:, :3, 3] += dp
    fields["kf_valid"][:n_kf] = True
    fields["kf_frame_id"][:n_kf] = np.arange(n_kf)
    fields["pt_valid"][np.unique(kf_pt[kf_fv])] = True   # the map holds the points seen
    fields["pt_ref_kf"][:] = 0
    return fields
