"""Hand-built maps for the loop-closing path, in numpy.

  * `build_revisit_state`: tests/test_loop_integration.py's revisit map
    (8 keyframes on a loop: 0..4 move away, 5..7 return near KF0's view
    and re-observe its scene through drifted duplicate points, with
    descriptors that resemble KF0's), at any capacity and point count.
    With its defaults (80 points, 96 feature slots, 512 point slots, the
    224x160 camera) and the same generator it draws what that test's
    builder draws, in the same order.
  * `random_retrieval_map`: tests/test_loop_scale.py's random covisible
    map and BoW database (KITTI-00 capacity there: 2,048 keyframe slots,
    300,000 point slots).

Both return {field: numpy array} of a `MapState` (descriptor words as
uint32, as `weights.map_state_from_numpy` takes them).
"""
from __future__ import annotations

import numpy as np

from dsp_slam_rgbd_tpu_torch.mapping import map_state as ms
from dsp_slam_rgbd_tpu_torch.weights import map_state_to_numpy

SMALL_CAM = (200.0, 200.0, 112.0, 80.0)   # fx, fy, cx, cy of the 224x160 world


def exp_se3(x) -> np.ndarray:
    """se(3) exponential of [v, w] (numpy, f64) -> (4, 4) f32."""
    x = np.asarray(x, np.float64)
    v, w = x[:3], x[3:]
    th = np.linalg.norm(w)
    W = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    a, b, c = np.sin(th) / th, (1 - np.cos(th)) / th ** 2, (th - np.sin(th)) / th ** 3
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + a * W + b * W @ W
    T[:3, 3] = (np.eye(3) + b * W + c * W @ W) @ v
    return T.astype(np.float32)


def _project(cam, pc: np.ndarray) -> np.ndarray:
    fx, fy, cx, cy = cam
    inv_z = (1.0 / pc[:, 2]).astype(np.float32)
    return np.stack([fx * pc[:, 0] * inv_z + cx, fy * pc[:, 1] * inv_z + cy], -1).astype(np.float32)


def _empty(max_kf, max_feat, max_pts, max_obj, **kw) -> dict:
    return map_state_to_numpy(ms.empty(max_kf=max_kf, max_feat=max_feat, max_pts=max_pts,
                                       max_obj=max_obj, device="cpu", **kw))


def build_revisit_state(rng, n_pts: int = 80, max_kf: int = 8, max_feat: int = 96,
                        max_pts: int = 512, max_obj: int = 4, cam=SMALL_CAM):
    """-> ({field: numpy} of the revisit map, the (4, 4) drift).  The 8
    keyframes take slots 0..7 (frame ids 0, 4, .., 28); KF0-4 observe the
    n_pts original points, KF5-7 their drifted duplicates (slots n_pts..)."""
    P, F = n_pts, max_feat
    assert P <= F and 2 * P <= max_pts and max_kf >= 8
    pts0 = np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P), rng.uniform(6, 10, P)],
                    -1).astype(np.float32)
    drift = exp_se3([0.25, 0.1, -0.1, 0.015, 0.02, -0.01])
    st = _empty(max_kf, F, max_pts, max_obj)
    desc0 = rng.integers(0, 2 ** 32, (F, 8), dtype=np.uint32)
    kf_poses, kf_descs = [], []
    for k in range(8):
        if k < 5:
            T = np.eye(4, dtype=np.float32)
            T[0, 3] = 0.8 * k
            d = rng.integers(0, 2 ** 32, (F, 8), dtype=np.uint32) if k > 0 else desc0
        else:
            # returning: views resemble KF0's progressively, with drift
            T = drift @ np.eye(4, dtype=np.float32)
            T[0, 3] += 0.3 * (7 - k)
            d = desc0.copy()
            flips = rng.integers(0, 8, (F, 4))
            for i in range(F):
                for w in flips[i]:
                    d[i, w] ^= np.uint32(1) << np.uint32(rng.integers(0, 32))
        kf_poses.append(T)
        kf_descs.append(d)
    # originals (KF0-4 observe) and drifted duplicates (KF5-7 observe): a
    # camera whose pose estimate drifted by D triangulates points drifted
    # by D⁻¹
    R, t = drift[:3, :3], drift[:3, 3]
    inv_d = np.eye(4, dtype=np.float32)
    inv_d[:3, :3], inv_d[:3, 3] = R.T, -R.T @ t
    pts_dup = pts0 @ inv_d[:3, :3].T + inv_d[:3, 3]
    st["pt_pos"][:P] = pts0
    st["pt_pos"][P: 2 * P] = pts_dup
    st["pt_valid"][: 2 * P] = True
    for k in range(8):
        base, src = (0, pts0) if k < 5 else (P, pts_dup)
        pc = src @ kf_poses[k][:3, :3].T + kf_poses[k][:3, 3]
        st["kf_xy"][k, :P] = _project(cam, pc)
        st["kf_feat_pt"][k, :P] = np.arange(base, base + P)
    st["kf_pose"][:8] = np.stack(kf_poses)
    st["kf_valid"][:8] = True
    st["kf_frame_id"][:8] = np.arange(8) * 4
    st["kf_desc"][:8] = np.stack(kf_descs)
    st["kf_feat_valid"][:8] = True
    st["pt_ref_kf"][:P] = 0
    st["pt_ref_kf"][P: 2 * P] = 5
    # point descriptors mirror their observations
    st["pt_desc"][:P] = desc0[:P]
    st["pt_desc"][P: 2 * P] = kf_descs[5][:P]
    return st, drift


def random_retrieval_map(rng, K: int, F: int, P: int, n_live_kf: int, n_live_pts: int,
                         pts_per_kf: int, n_words: int):
    """tests/test_loop_scale.py's `_random_map` + `_random_db`: keyframe k
    observes points from a sliding window of the point range, so nearby
    keyframes co-observe -> ({field: numpy} of the map, {"bow", "kf_valid"}
    of its database)."""
    st = _empty(K, F, P, 2, code_len=8, max_oobs=8)
    st["kf_valid"][:n_live_kf] = True
    for k in range(n_live_kf):
        lo = int(k / n_live_kf * max(n_live_pts - 4 * pts_per_kf, 1))
        hi = min(lo + 4 * pts_per_kf, n_live_pts)
        pts = rng.choice(hi - lo, size=min(pts_per_kf, hi - lo), replace=False) + lo
        st["kf_feat_pt"][k, :len(pts)] = pts
    st["kf_feat_valid"][:] = True
    st["pt_valid"][:n_live_pts] = True
    st["kf_frame_id"][:] = np.arange(K)
    bow = rng.random((K, n_words)).astype(np.float32)
    bow /= bow.sum(1, keepdims=True)
    bow[~st["kf_valid"]] = 0.0
    return st, {"bow": bow, "kf_valid": st["kf_valid"].copy()}
