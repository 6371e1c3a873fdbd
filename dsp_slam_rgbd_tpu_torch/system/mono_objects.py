"""Monocular object pipeline: mask-only detections → map objects.

Counterpart of `dsp_slam_rgbd_tpu/system/mono_objects.py`, the reference's
mono flow on the map state:

  * `associate_by_projection` — vote by map-point object id over the
    detection's keypoints (`Tracking::AssociateObjectsByProjection_onlyformono`,
    `Tracking_util.cc:210-288`); newly matched unowned points join the
    object, points owned by a different object are killed;
  * `create_new_objects` — unassociated good detections spawn a poseless
    object that owns the detection's map points
    (`LocalMapping::CreateNewObjectsFromDetections_onlyformono`,
    `LocalMapping_util.cc:213-254`);
  * `process_detected_objects` — per associated object: PCA cuboid refit
    (pose seed while young), model-bbox outlier gating once reconstructed,
    and a full GN reconstruction every 5 KFs after a 15-KF warmup with
    orientation-flip disambiguation
    (`LocalMapping::ProcessDetectedObjects_onlyformono`,
    `LocalMapping_util.cc:256-445`, flip at :399-410).

Association and bookkeeping are host numpy over the map's tensors (the
loop runs at keyframe rate, as in the JAX package); the reconstruction is
the port's GN fit (`recon/optimizer.py::reconstruct_object`).
"""
from __future__ import annotations

import numpy as np
import torch

from dsp_slam_rgbd_tpu_torch.mapping import map_state as ms
from dsp_slam_rgbd_tpu_torch.mapping import objects as obj_mod
from dsp_slam_rgbd_tpu_torch.mapping.local_mapping import _set_row
from dsp_slam_rgbd_tpu_torch.models import mesh as mesh_mod
from dsp_slam_rgbd_tpu_torch.ops import lie
from dsp_slam_rgbd_tpu_torch.recon import optimizer as recon_opt
from dsp_slam_rgbd_tpu_torch.system import detections as det_mod

# reference gates (LocalMapping_util.cc:336-337, Tracking_util.cc:199)
MIN_SURFACE_POINTS = 50
MIN_RAYS = 21
WARMUP_KFS = 15
RECON_EVERY = 5
PCA_UNTIL = 50


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _like(a: np.ndarray, t: torch.Tensor) -> torch.Tensor:
    """Host array a as a tensor on t's device."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(t.device)


def _det_point_slots(state: ms.MapState, kf_slot: int, kp_idx):
    """Map a detection's keypoint indices to live point slots.

    Returns (kp (n,), slots (n,)) aligned arrays; slots is −1 where the
    keypoint has no live map point."""
    feat_pt = _np(state.kf_feat_pt[kf_slot])
    feat_ok = _np(state.kf_feat_valid[kf_slot])
    kp = np.asarray(kp_idx, np.int64)
    kp = kp[(kp >= 0) & (kp < feat_pt.shape[0])]
    slots = np.where(feat_ok[kp], feat_pt[kp], -1)
    pt_valid = _np(state.pt_valid)
    slots = np.where((slots >= 0) & pt_valid[np.maximum(slots, 0)], slots, -1)
    return kp, slots


def associate_by_projection(state: ms.MapState, kf_slot: int, dets):
    """Vote detections onto existing objects by their map points' object
    ids.  Returns (state, assoc) with assoc[d] = object slot or −1.

    Side effects (reference `Tracking_util.cc:255-283`): unowned points
    matched to an associated detection join the object; points owned by a
    DIFFERENT object are flagged bad (killed).
    """
    pt_object = _np(state.pt_object).copy()
    pt_outlier = _np(state.pt_outlier)
    kill = np.zeros(pt_object.shape[0], bool)
    assoc = np.full(len(dets), -1, np.int64)
    for d, det in enumerate(dets):
        _, slots = _det_point_slots(state, kf_slot, det.kp_idx)
        slots = slots[slots >= 0]
        if slots.size == 0:
            continue
        owners = pt_object[slots]
        voting = owners[(owners >= 0) & ~pt_outlier[slots]]
        if voting.size == 0:
            continue
        ids, counts = np.unique(voting, return_counts=True)
        o = int(ids[np.argmax(counts)])
        assoc[d] = o
        unowned = slots[pt_object[slots] < 0]
        pt_object[unowned] = o
        conflict = slots[(pt_object[slots] >= 0) & (pt_object[slots] != o)]
        kill[conflict] = True
    new_valid = _np(state.pt_valid) & ~kill
    state = state._replace(pt_object=_like(pt_object, state.pt_object),
                           pt_valid=_like(new_valid, state.pt_valid))
    return state, assoc


def create_new_objects(state: ms.MapState, kf_slot: int, dets, assoc,
                       kfseq: int, max_new: int = 1):
    """Spawn poseless objects from unassociated good detections; the new
    object owns the detection's current map points.  `max_new=1` mirrors
    the reference's single-centered-object focus (`LocalMapping_util.cc:253`
    returns after the first creation)."""
    created = 0
    pt_object = _np(state.pt_object).copy()
    for d, det in enumerate(dets):
        if assoc[d] >= 0 or not det.is_good or created >= max_new:
            continue
        slot = ms.alloc_slots(_np(state.obj_valid), 1)[0]
        if slot < 0:
            continue
        slot = int(slot)
        _, slots = _det_point_slots(state, kf_slot, det.kp_idx)
        slots = slots[slots >= 0]
        own = slots[pt_object[slots] < 0]
        pt_object[own] = slot
        state = state._replace(
            obj_valid=_set_row(state.obj_valid, slot, True),
            obj_pose=_set_row(state.obj_pose, slot,
                              torch.eye(4, device=state.obj_pose.device)),
            obj_scale=_set_row(state.obj_scale, slot, 1.0),
            obj_code=_set_row(state.obj_code, slot, 0.0),
            obj_recon=_set_row(state.obj_recon, slot, False),
            obj_ref_kfseq=_set_row(state.obj_ref_kfseq, slot, kfseq),
            obj_n_obs=_set_row(state.obj_n_obs, slot, 1),
            obj_last_kf=_set_row(state.obj_last_kf, slot, kf_slot),
        )
        assoc[d] = slot
        created += 1
    state = state._replace(pt_object=_like(pt_object, state.pt_object))
    return state, assoc


def process_detected_objects(state: ms.MapState, cam, recon_cfg, decoder,
                             kf_slot: int, kfseq: int, dets, assoc,
                             compute_dtype=torch.float32):
    """PCA refit / outlier gating / every-5-KF reconstruction for each
    associated object.  Returns (state, obs) where obs is a list of
    (obj_slot, t_co_se3 (4, 4) numpy) pose measurements for the joint BA."""
    obs = []
    t_cw = state.kf_pose[kf_slot]
    t_cw_np = _np(t_cw)
    for d, det in enumerate(dets):
        o = int(assoc[d])
        # det->isGood gate: <20 in-mask keypoints means the detection is
        # too weak to drive a refit (reference LocalMapping_util.cc:275)
        if o < 0 or not bool(state.obj_valid[o]) or not det.is_good:
            continue
        n_passed = kfseq - int(state.obj_ref_kfseq[o])

        owned = (_np(state.pt_object) == o) & _np(state.pt_valid)
        if n_passed < PCA_UNTIL:
            # RemoveOutliersSimple: points >1 m from the centroid leave the
            # object (reference erases them from the owned set)
            keep = _np(obj_mod.remove_outliers_simple(state.pt_pos,
                                                      _like(owned, state.pt_valid)))
            released = owned & ~keep
            if released.any():
                po = _np(state.pt_object).copy()
                po[released] = -1
                state = state._replace(pt_object=_like(po, state.pt_object))
                owned = keep
            if not owned.any():
                state = state._replace(obj_valid=_set_row(state.obj_valid, o, False))
                continue
            cub = obj_mod.cuboid_from_points_pca(state.pt_pos, _like(owned, state.pt_valid))
            pt_outlier = _np(state.pt_outlier) | _np(cub.outlier)
            state = state._replace(pt_outlier=_like(pt_outlier, state.pt_outlier))
            if n_passed < WARMUP_KFS:
                # pose seed only while young (reference updatePose arg)
                state = state._replace(
                    obj_pose=_set_row(state.obj_pose, o, cub.t_wo),
                    obj_scale=_set_row(state.obj_scale, o, torch.clamp_min(cub.scale, 1e-3)),
                )
        else:
            out = _np(obj_mod.model_outliers(
                state.pt_pos, _like(owned, state.pt_valid), state.obj_pose[o],
                state.obj_scale[o], state.obj_bbox_min[o], state.obj_bbox_max[o]))
            state = state._replace(
                pt_outlier=_like(_np(state.pt_outlier) | out, state.pt_outlier))

        if n_passed < WARMUP_KFS or (n_passed - WARMUP_KFS) % RECON_EVERY:
            continue

        # ---- gather the reconstruction problem ----
        pt_outlier = _np(state.pt_outlier)
        good_owned = owned & ~pt_outlier
        if good_owned.sum() < MIN_SURFACE_POINTS:
            continue
        kp_all, slots = _det_point_slots(state, kf_slot, det.kp_idx)
        keep = (slots >= 0)
        keep[keep] = ((_np(state.pt_object)[slots[keep]] == o)
                      & ~pt_outlier[slots[keep]])
        ray_sel, ray_kps = slots[keep], kp_all[keep]
        if ray_sel.size < MIN_RAYS:
            continue

        pts_w = state.pt_pos[_like(np.nonzero(good_owned)[0], t_cw)]
        pts_cam = _np(lie.transform_points(t_cw, pts_w))
        if len(pts_cam) > det_mod.MAX_SURFACE:
            pick = np.linspace(0, len(pts_cam) - 1, det_mod.MAX_SURFACE).astype(int)
            pts_cam = pts_cam[pick]

        # fg rays from the keypoints' pixel coords; depth = z of the owned
        # map point in the current camera (reference :359-380)
        xy = _np(state.kf_xy[kf_slot])[ray_kps]
        fg = np.stack([(xy[:, 0] - cam.cx) / cam.fx,
                       (xy[:, 1] - cam.cy) / cam.fy,
                       np.ones(len(xy))], -1).astype(np.float32)
        depth_obs = _np(lie.transform_points(
            t_cw, state.pt_pos[_like(ray_sel, t_cw)]))[:, 2]
        n_fg_cap = det_mod.MAX_RAYS - min(len(det.bg_rays), 200)
        if len(fg) > n_fg_cap:
            fg, depth_obs = fg[:n_fg_cap], depth_obs[:n_fg_cap]
        rays = np.concatenate([fg, det.bg_rays[:200]], 0)

        # ---- GN fit, with flip disambiguation before first success ----
        t_wo = _np(state.obj_pose[o])
        s = float(state.obj_scale[o])
        two_sim3 = t_wo.copy()
        two_sim3[:3, :3] *= s
        code0 = state.obj_code[o]
        packed = det_mod.make_detection(t_cw_np @ two_sim3, pts=pts_cam, rays=rays,
                                        depth=depth_obs, n_fg=len(fg))
        args = [_like(a, t_cw) for a in (packed.pts, packed.pts_mask, packed.rays,
                                          packed.ray_mask, packed.depth, packed.fg_mask)]

        def fit(t_init):
            return recon_opt.reconstruct_object(
                decoder, recon_cfg, _like(t_init.astype(np.float32), t_cw), *args,
                code_init=code0, compute_dtype=compute_dtype)

        res = fit(t_cw_np @ two_sim3)
        if not bool(state.obj_recon[o]):
            flipped = two_sim3.copy()
            flipped[:, 0] *= -1.0
            flipped[:, 2] *= -1.0  # 180° about object y (reference :402-405)
            res_f = fit(t_cw_np @ flipped)
            if float(res_f.loss) < float(res.loss):
                res = res_f
        if not bool(res.is_good):
            continue

        t_co_fit = _np(res.t_cam_obj)
        s_new = float(np.cbrt(np.linalg.det(t_co_fit[:3, :3])))
        t_co_se3 = t_co_fit.copy()
        t_co_se3[:3, :3] /= s_new
        t_wo_new = _np(lie.inv_se3(t_cw)) @ t_co_se3
        bb_min, bb_max = mesh_mod.sdf_bbox(decoder, res.code)
        n_obs = state.obj_n_obs.clone()
        n_obs[o] += 1
        state = state._replace(
            obj_pose=_set_row(state.obj_pose, o, _like(t_wo_new, t_cw)),
            obj_scale=_set_row(state.obj_scale, o, s_new),
            obj_code=_set_row(state.obj_code, o, res.code),
            obj_recon=_set_row(state.obj_recon, o, True),
            obj_n_obs=n_obs,
            obj_last_kf=_set_row(state.obj_last_kf, o, kf_slot),
            obj_bbox_min=_set_row(state.obj_bbox_min, o, bb_min),
            obj_bbox_max=_set_row(state.obj_bbox_max, o, bb_max),
        )
        obs.append((o, t_co_se3))
    return state, obs
