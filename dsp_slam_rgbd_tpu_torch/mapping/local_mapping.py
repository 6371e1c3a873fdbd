"""Local mapping: the keyframe bootstrap that tracking needs.

Counterpart of part of `dsp_slam_rgbd_tpu/mapping/local_mapping.py`:
`insert_keyframe` (ProcessNewKeyFrame, `src/LocalMapping.cc:180`), the
close-depth point spawning of `CreateNewKeyFrame` (`Tracking.cc:1185-1237`)
and `update_point_geometry` (`MapPoint::UpdateNormalAndDepth`,
`MapPoint.cc:336-421`).  Triangulation, fusion, culling and bundle
adjustment belong to the keyframe stage, which is not ported yet.
"""
from __future__ import annotations

import torch

from dsp_slam_rgbd_tpu_torch.frontend.fast import top_k_stable
from dsp_slam_rgbd_tpu_torch.mapping import map_state as ms
from dsp_slam_rgbd_tpu_torch.ops import camera as cam_ops
from dsp_slam_rgbd_tpu_torch.ops import lie


def _set_row(a: torch.Tensor, row: int, value) -> torch.Tensor:
    out = a.clone()
    out[row] = value
    return out


def insert_keyframe(state: ms.MapState, frame, kf_slot: int,
                    frame_id: int) -> ms.MapState:
    """Write a tracked frame into a KF slot (ProcessNewKeyFrame role)."""
    F = state.kf_xy.shape[1]
    n = min(frame.feats.xy.shape[0], F)

    def pad(a, fill):
        if a.shape[0] == F:
            return a
        rest = torch.full((F - n,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                          device=a.device)
        return torch.cat([a[:n], rest])

    return state._replace(
        kf_pose=_set_row(state.kf_pose, kf_slot, frame.t_cw),
        kf_valid=_set_row(state.kf_valid, kf_slot, True),
        kf_frame_id=_set_row(state.kf_frame_id, kf_slot, frame_id),
        kf_xy=_set_row(state.kf_xy, kf_slot, pad(frame.feats.xy, 0.0)),
        kf_level=_set_row(state.kf_level, kf_slot, pad(frame.feats.level, 0)),
        kf_desc=_set_row(state.kf_desc, kf_slot, pad(frame.feats.desc, 0)),
        kf_ur=_set_row(state.kf_ur, kf_slot, pad(frame.ur, -1.0)),
        kf_feat_valid=_set_row(state.kf_feat_valid, kf_slot,
                               pad(frame.feats.valid, False)),
        kf_feat_pt=_set_row(state.kf_feat_pt, kf_slot, pad(frame.pt_idx, -1)),
    )


def _scatter(a: torch.Tensor, idx: torch.Tensor, value) -> torch.Tensor:
    """a with `value` written at idx, where idx == len(a) is dropped."""
    n = a.shape[0]
    buf = torch.cat([a, a[:1]])
    if isinstance(value, torch.Tensor):
        buf[idx] = value.to(a.dtype)
    else:  # a scalar: see map_state.mark
        buf.index_fill_(0, idx, value)
    return buf[:n]


def spawn_depth_points(state: ms.MapState, cam, kf_slot: int, frame,
                       th_depth: float, max_new: int = 256,
                       first_id: int | None = None) -> ms.MapState:
    """Create map points from close stereo/RGB-D depth for features without
    an associated point (reference close-point spawning,
    `Tracking.cc:1185-1237`), closest first, capped at max_new; slot
    allocation and the scatters stay on the device.

    first_id: monotonic keyframe id stamped as the points' creation age
    (the reference's mnFirstKFid); slot indices are recycled."""
    if first_id is None:
        first_id = kf_slot
    P = state.pt_pos.shape[0]
    F = state.kf_feat_pt.shape[1]
    slots = ms.free_slots_device(state.pt_valid, max_new).long()
    has = (frame.depth > 0) & (frame.depth < th_depth) \
        & frame.feats.valid & (frame.pt_idx < 0)
    score = torch.where(has, -frame.depth, -torch.inf)
    k = min(max_new, score.shape[0])
    vals, ch = top_k_stable(score, k)
    live = torch.isfinite(vals)
    sl_raw = slots[:k]
    sl = torch.where(live & (sl_raw >= 0), torch.clamp_min(sl_raw, 0), P)
    feat_tgt = torch.where(sl < P, ch, F)

    uv = frame.feats.xy[ch]
    z = frame.depth[ch]
    p_cam = cam_ops.backproject(cam, uv, z)
    p_w = lie.transform_points(lie.inv_se3(frame.t_cw), p_cam)

    sl_val = torch.where(sl < P, sl, -1).to(torch.int32)
    kf_row = _scatter(state.kf_feat_pt[kf_slot], feat_tgt, sl_val)
    return state._replace(
        pt_pos=_scatter(state.pt_pos, sl, p_w),
        pt_valid=_scatter(state.pt_valid, sl, True),
        pt_desc=_scatter(state.pt_desc, sl, frame.feats.desc[ch]),
        pt_ref_kf=_scatter(state.pt_ref_kf, sl, kf_slot),
        pt_first_kf=_scatter(state.pt_first_kf, sl, first_id),
        # a recycled slot must not inherit the evicted point's counters
        pt_visible=_scatter(state.pt_visible, sl, 1),
        pt_found=_scatter(state.pt_found, sl, 1),
        kf_feat_pt=_set_row(state.kf_feat_pt, kf_slot, kf_row),
    )


def update_point_geometry(state: ms.MapState) -> ms.MapState:
    """Refresh per-point viewing normals and scale-invariance depth ranges:
    normal = mean direction from the observing camera centers; [min_d,
    max_d] from the reference-KF distance and the octave of its
    observation.  Edgewise over the (K, F) observation table, O(K·F).
    Normals sum with `index_add_`: on the card duplicate targets add in
    atomics order, so they match another implementation to a tolerance."""
    K, F = state.kf_feat_pt.shape
    P = state.pt_pos.shape[0]
    centers = lie.inv_se3(state.kf_pose)[:, :3, 3]       # (K, 3)

    ok = ms._obs_ok(state)                                # (K, F)
    pt = torch.clamp_min(state.kf_feat_pt, 0).long()      # (K, F)
    diff = state.pt_pos[pt] - centers[:, None, :]         # (K, F, 3)
    dirs = diff / torch.clamp_min(torch.linalg.vector_norm(diff, dim=-1, keepdim=True), 1e-9)
    tgt = torch.where(ok, pt, P).reshape(-1)
    nsum = torch.zeros(P + 1, 3, dtype=dirs.dtype, device=dirs.device)
    nsum.index_add_(0, tgt, torch.where(ok[..., None], dirs, 0.0).reshape(-1, 3))
    n_obs = torch.clamp_min(ms.point_obs_counts(state), 1).float()
    normal = nsum[:P] / n_obs[:, None]

    ref = torch.clamp_min(state.pt_ref_kf, 0).long()
    dist = torch.linalg.vector_norm(state.pt_pos - centers[ref], dim=-1)
    # octave of the point's observation in its reference KF
    kf_ids = torch.arange(K, device=pt.device)[:, None]
    is_ref = ok & (kf_ids == state.pt_ref_kf[pt])
    tgt_ref = torch.where(is_ref, pt, P).reshape(-1)
    lvl = torch.zeros(P + 1, dtype=torch.int32, device=pt.device)
    lvl = lvl.scatter_reduce(0, tgt_ref, torch.where(is_ref, state.kf_level, 0).reshape(-1),
                             reduce="amax")[:P].float()
    max_d = dist * (1.2 ** lvl)
    min_d = max_d / (1.2 ** 7)
    live = state.pt_valid
    return state._replace(
        pt_normal=torch.where(live[:, None], normal, state.pt_normal),
        pt_min_d=torch.where(live, min_d, state.pt_min_d),
        pt_max_d=torch.where(live, max_d, state.pt_max_d),
    )
