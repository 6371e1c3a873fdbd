"""Batched stereo object stage: association, pose refinement, reconstruction.

Counterpart of `dsp_slam_rgbd_tpu/system/object_stage.py`.  The reference
reconstructs detections one Python call at a time
(`src/LocalMapping_util.cc:86,158`); here a keyframe's object work is three
batched steps whatever the detection count:

  1. `associate_batch`     — data association (+ one small combined read);
  2. `refine_associated`   — pose-only GN over every associated object at
     once (one decoder Jacobian launch per GN iteration over all rows),
     plus the bookkeeping scatters (obs counters, dynamics, observation
     edges, point membership), all on the device;
  3. `recon_unmatched`     — joint Sim3+code GN over every unmatched
     detection at once, with the decoded-shape bbox (one value launch over
     U×24³ rows); one read of the is_good/obj_valid flags, then
     `insert_new_objects` scatters every accepted object at once.

The associated rows are padded to a power-of-two capacity bucket, as in
the JAX package; the unmatched batch is its count off the multi-device
path and is padded to the mesh's `obj` axis on it (`min_cap`), where the
fit runs sharded (`parallel/sharded_recon.py`).  A scatter that the JAX package writes with an out-of-range
"drop" target writes into a spare dump row (index O or Q) that is sliced
off.  Nothing here reads the device except `associate_read` and
`recon_unmatched_read`.
"""
from __future__ import annotations

import numpy as np
import torch

from dsp_slam_rgbd_tpu_torch.frontend.orb import upload
from dsp_slam_rgbd_tpu_torch.mapping import objects as obj_mod
from dsp_slam_rgbd_tpu_torch.mapping.local_mapping import _scatter
from dsp_slam_rgbd_tpu_torch.models import mesh as mesh_mod
from dsp_slam_rgbd_tpu_torch.ops import lie
from dsp_slam_rgbd_tpu_torch.parallel import sharded_recon
from dsp_slam_rgbd_tpu_torch.recon import optimizer as recon_opt


def bucket(n: int, minimum: int = 1, cap: int = 64) -> int:
    b = max(minimum, 1)
    while b < n:
        b *= 2
    return min(b, cap)


# ---------------------------------------------------------------------------
# 1. association
# ---------------------------------------------------------------------------
def _associate_device(state, det_t_co, det_valid, t_cw):
    assoc, unmatched = obj_mod.associate_detections(
        state.obj_pose[:, :3, 3], state.obj_valid, state.obj_dynamic,
        state.obj_velocity, det_t_co, det_valid, t_cw)
    # one combined read vector: [assoc (O,) | unmatched (D,)]
    return torch.cat([assoc, unmatched.to(torch.int32)])


def associate_dispatch(state, detections, t_cw):
    """Launch the association; returns the pending (device vector, D).
    `t_cw` is the keyframe pose passed directly (not read from the map),
    so this can run before the keyframe insert and its read
    (`associate_read`) comes after the point stage."""
    D = len(detections)
    det_t = np.stack([np.asarray(d.t_co, np.float32) for d in detections])
    det_valid = np.ones(D, bool)
    dev = t_cw.device
    return _associate_device(state, upload(det_t, dev), upload(det_valid, dev), t_cw), D


def associate_read(pending, n_obj: int):
    """Read + unpack an `associate_dispatch` result (one host read)."""
    vec, D = pending
    out = vec.cpu().numpy()
    assoc = out[:n_obj]
    unmatched = out[n_obj:].astype(bool)
    return assoc, [int(i) for i in np.nonzero(unmatched)[0] if i < D]


def associate_batch(state, detections, kf_slot):
    """Associate a keyframe's detections with existing objects (launch +
    immediate read).  Returns (assoc (O,) np, unmatched_det_indices)."""
    return associate_read(
        associate_dispatch(state, detections, state.kf_pose[kf_slot]),
        state.obj_valid.shape[0])


# ---------------------------------------------------------------------------
# shared: batched point-membership update
# ---------------------------------------------------------------------------
def _membership_update(state, obj_idx, valid):
    """Batched `_assign_point_membership`: tag map points inside each
    object's decoded-shape bbox (reference `object_id`/`in_any_object`,
    `MapPoint_util.cc:23-31`; inflation margins `MapObject.cc:301-303`).

    Sequential-claim semantics preserved: an owner that still sees its
    point keeps it; released or unowned points go to the lowest-row
    claiming object (first index of the claim matrix)."""
    st = state
    oi = torch.clamp_min(obj_idx, 0).long()
    T_ow = lie.inv_se3(st.obj_pose[oi])                                  # (A, 4, 4)
    local = st.pt_pos[None] @ T_ow[:, :3, :3].transpose(1, 2) + T_ow[:, None, :3, 3]
    local = local / torch.clamp_min(st.obj_scale[oi], 1e-6)[:, None, None]
    inside = torch.all(
        (local >= obj_mod.inflate_bbox(st.obj_bbox_min[oi])[:, None, :])
        & (local <= obj_mod.inflate_bbox(st.obj_bbox_max[oi])[:, None, :]), dim=-1
    ) & st.pt_valid[None, :] & valid[:, None]                            # (A, P)

    owner = st.pt_object
    owned_by = (owner[None, :] == oi[:, None]) & valid[:, None]
    release = torch.any(owned_by & ~inside, dim=0)
    owner = torch.where(release, -1, owner)
    any_claim = torch.any(inside, dim=0)
    winner = oi[torch.argmax(inside.to(torch.uint8), dim=0)]
    owner = torch.where((owner < 0) & any_claim, winner.to(owner.dtype), owner)
    return st._replace(pt_object=owner.to(torch.int32))


# ---------------------------------------------------------------------------
# 2. associated objects: batched pose-only GN + bookkeeping
# ---------------------------------------------------------------------------
@torch.no_grad()
def refine_associated(decoder, cfg, state, obj_idx, valid, det_t_co, det_pts,
                      det_pts_mask, kf_slot: int, oobs_q):
    """Pose-only refinement of every associated object in one batched GN
    (`estimate_pose_cam_obj` over all A rows).

    obj_idx (A,) object slots, valid (A,) live rows, det_* the matched
    detections' measurements, oobs_q (A,) pre-allocated observation-ring
    slots (host-owned cursors).  Updates obs counters, dynamics, the
    camera-object edge ring and point membership, all on the device."""
    O = state.obj_pose.shape[0]
    Q = state.oobs_kf.shape[0]
    oi = torch.clamp_min(obj_idx, 0).long()
    t_cw = state.kf_pose[kf_slot]

    t_co_ref, _loss = recon_opt.estimate_pose_cam_obj(
        decoder, cfg, det_t_co, state.obj_scale[oi], det_pts, det_pts_mask,
        state.obj_code[oi])

    t_wo_new = lie.inv_se3(t_cw) @ t_co_ref
    v, dyn, _ = obj_mod.update_dynamics(state.obj_pose[oi, :3, 3], t_wo_new[:, :3, 3], 1.0,
                                        state.obj_velocity[oi])

    tgt = torch.where(valid, oi, O)
    qt = torch.where(valid, torch.clamp_min(oobs_q, 0).long(), Q)
    n_obs = torch.cat([state.obj_n_obs, state.obj_n_obs[:1]]).index_add_(
        0, tgt, torch.ones_like(tgt, dtype=state.obj_n_obs.dtype))[:O]
    state = state._replace(
        obj_n_obs=n_obs,
        obj_last_kf=_scatter(state.obj_last_kf, tgt, kf_slot),
        obj_velocity=_scatter(state.obj_velocity, tgt, v),
        obj_dynamic=_scatter(state.obj_dynamic, tgt, dyn),
        oobs_kf=_scatter(state.oobs_kf, qt, kf_slot),
        oobs_obj=_scatter(state.oobs_obj, qt, oi),
        oobs_t_co=_scatter(state.oobs_t_co, qt, t_co_ref),
        oobs_valid=_scatter(state.oobs_valid, qt, True),
    )
    return _membership_update(state, obj_idx, valid)


# ---------------------------------------------------------------------------
# 3. unmatched detections: batched joint GN + bbox; scatter accepted objects
# ---------------------------------------------------------------------------
def _recon_unmatched_device(decoder, cfg, state, t_co, pts, pts_mask, rays,
                            ray_mask, depth, fg_mask, code0, valid, mesh=None):
    if mesh is None:
        res = recon_opt.reconstruct_objects_batched(
            decoder, cfg, t_co, pts, pts_mask, rays, ray_mask, depth, fg_mask, code0)
    else:
        res = sharded_recon.reconstruct_sharded(decoder, cfg, dict(
            t_cam_obj=t_co, pts=pts, pts_mask=pts_mask, rays=rays, ray_mask=ray_mask,
            depth_obs=depth, fg_mask=fg_mask, code_init=code0), mesh)
    bb_min, bb_max = mesh_mod.sdf_bbox(decoder, res.code)
    # one combined flags read: [is_good (U,) | obj_valid (O,)] — obj_valid
    # rides along so host slot allocation needs no second read
    flags = torch.cat([(res.is_good & valid).to(torch.int32),
                       state.obj_valid.to(torch.int32)])
    return res, bb_min, bb_max, flags


def recon_unmatched(decoder, cfg, state, detections, det_indices, mesh=None,
                    min_cap: int = 1):
    """Joint Sim3+code GN over every unmatched detection as one batch.

    Returns the pending (res, bb_min, bb_max, flags, Ucap, U); nothing is
    read.  With a `mesh` (`parallel/mesh.py`) the batch shards over its
    (obj, ray) axes (`parallel/sharded_recon.py`), and `min_cap`, the
    mesh's obj-axis size, pads the batch so that every mesh row has
    objects to fit."""
    U = len(det_indices)
    Ucap = bucket(U, minimum=min_cap, cap=max(U, min_cap))
    S = detections[det_indices[0]].pts.shape[0]
    R = detections[det_indices[0]].rays.shape[0]
    L = cfg.code_len
    t_co = np.zeros((Ucap, 4, 4), np.float32)
    t_co[:] = np.eye(4)
    b = {
        "pts": np.zeros((Ucap, S, 3), np.float32),
        "pts_mask": np.zeros((Ucap, S), bool),
        "rays": np.zeros((Ucap, R, 3), np.float32),
        "ray_mask": np.zeros((Ucap, R), bool),
        "depth": np.zeros((Ucap, R), np.float32),
        "fg_mask": np.zeros((Ucap, R), bool),
    }
    b["rays"][:, :, 2] = 1.0  # unit-norm padding rows (masked anyway)
    for j, di in enumerate(det_indices):
        d = detections[di]
        t = np.asarray(d.t_co, np.float32).copy()
        t[:3, :3] *= d.scale  # Sim(3) seed: scale folded into R
        t_co[j] = t
        b["pts"][j], b["pts_mask"][j] = d.pts, d.pts_mask
        b["rays"][j], b["ray_mask"][j] = d.rays, d.ray_mask
        b["depth"][j], b["fg_mask"][j] = d.depth, d.fg_mask
    valid = np.zeros(Ucap, bool)
    valid[:U] = True
    dev = decoder.device
    up = {k: upload(v, dev) for k, v in b.items()}
    res, bb_min, bb_max, flags = _recon_unmatched_device(
        decoder, cfg, state, upload(t_co, dev), up["pts"], up["pts_mask"], up["rays"],
        up["ray_mask"], up["depth"], up["fg_mask"],
        torch.zeros(Ucap, L, device=dev), upload(valid, dev), mesh)
    return res, bb_min, bb_max, flags, Ucap, U


def recon_unmatched_read(pending, flags=None):
    """Read + unpack a `recon_unmatched` result.  `flags`: the flags
    vector if the caller already read it (bundled with another read)."""
    res, bb_min, bb_max, flags_dev, Ucap, U = pending
    if flags is None:
        flags = flags_dev.cpu().numpy()   # the object stage's blocking read
    good = flags[:Ucap].astype(bool)
    obj_valid = flags[Ucap:].astype(bool)
    return res, bb_min, bb_max, good, obj_valid, U


def insert_new_objects(state, slots, ok, t_sim3, codes, bb_min, bb_max,
                       kf_slot: int, kfseq: int, oobs_q):
    """Scatter every accepted reconstruction into the map at once
    (pose/scale decomposition, world pose, bbox, obs edge, membership)."""
    O = state.obj_pose.shape[0]
    Q = state.oobs_kf.shape[0]
    t_cw = state.kf_pose[kf_slot]
    # cube root in f64, rounded once (torch has no f32 cbrt)
    s = lie.cbrt(torch.linalg.det(t_sim3[:, :3, :3]).double()).float()
    sR = t_sim3[:, :3, :3] / torch.clamp_min(s, 1e-9)[:, None, None]
    t_se3 = torch.cat([torch.cat([sR, t_sim3[:, :3, 3:]], dim=-1), t_sim3[:, 3:]], dim=-2)
    t_wo = lie.inv_se3(t_cw) @ t_se3

    sl = torch.clamp_min(slots, 0).long()
    tgt = torch.where(ok, sl, O)
    qt = torch.where(ok, torch.clamp_min(oobs_q, 0).long(), Q)
    state = state._replace(
        obj_pose=_scatter(state.obj_pose, tgt, t_wo),
        obj_scale=_scatter(state.obj_scale, tgt, s),
        obj_code=_scatter(state.obj_code, tgt, codes),
        obj_valid=_scatter(state.obj_valid, tgt, True),
        obj_n_obs=_scatter(state.obj_n_obs, tgt, 1),
        obj_last_kf=_scatter(state.obj_last_kf, tgt, kf_slot),
        obj_ref_kfseq=_scatter(state.obj_ref_kfseq, tgt, kfseq),
        obj_recon=_scatter(state.obj_recon, tgt, True),
        obj_bbox_min=_scatter(state.obj_bbox_min, tgt, bb_min),
        obj_bbox_max=_scatter(state.obj_bbox_max, tgt, bb_max),
        obj_velocity=_scatter(state.obj_velocity, tgt, 0.0),
        obj_dynamic=_scatter(state.obj_dynamic, tgt, False),
        oobs_kf=_scatter(state.oobs_kf, qt, kf_slot),
        oobs_obj=_scatter(state.oobs_obj, qt, sl),
        oobs_t_co=_scatter(state.oobs_t_co, qt, t_se3),
        oobs_valid=_scatter(state.oobs_valid, qt, True),
    )
    return _membership_update(state, slots, ok)
