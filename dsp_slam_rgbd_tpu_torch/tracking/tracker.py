"""Per-frame tracking front end: the reference `Tracking` state machine.

Counterpart of the synchronous path of
`dsp_slam_rgbd_tpu/tracking/tracker.py` (reference `src/Tracking.cc`:
`Track()` :306-549, stereo/RGB-D initialization :551-605, monocular
initialization via the H/F initializer + median-depth scaling :607-819,
`TrackWithMotionModel` :949, `TrackReferenceKeyFrame` :839,
`TrackLocalMap` :1012, `NeedNewKeyFrame` :1059, `Relocalization` :1445).

The host drives the state machine; each tracking stage (local-KF window,
local-point gather, projective match, robust pose GN) runs on the device
and hands the host one small stats vector.  A frame on the fast path pays
two fetches: the motion-model stage's stats (which decide the retry and
whether the local-map stage runs, so only the branch taken is launched)
and the local-map stage's.  The fallback branches (reference keyframe,
relocalization) read one count each, as the JAX package does.

Monocular initialization matches the two frames on the device, reads the
match count once, and runs `solvers/initializer.py`, whose RANSAC samples
come from a CPU `torch.Generator` (the JAX package's PRNGKey stream is
not reproduced); the result's verdict, mask and points are read once.

With `TrackingConfig.pipelined`, the steady OK state runs one frame deep
(`_track_pipelined`, the JAX package's `tracker.py:543-663`): frame N+1's
tracking stages are queued before frame N's stats are read, and the read
is a non-blocking copy into pinned memory with an event.  With no host
read inside the frame, the retry at twice the radius and the local-map
stage always run, and the motion-model stage's counts select their
results on the device (`_track_frame_device`, the JAX package's two
`lax.cond`s as selects).
"""
from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from dsp_slam_rgbd_tpu_torch import device as device_mod
from dsp_slam_rgbd_tpu_torch.config import SystemConfig
from dsp_slam_rgbd_tpu_torch.frontend import matcher, orb
from dsp_slam_rgbd_tpu_torch.frontend import stereo as stereo_mod
from dsp_slam_rgbd_tpu_torch.frontend.fast import top_k_stable
from dsp_slam_rgbd_tpu_torch.mapping import covisibility as covis
from dsp_slam_rgbd_tpu_torch.mapping import map_state as ms
from dsp_slam_rgbd_tpu_torch.ops import camera as cam_ops
from dsp_slam_rgbd_tpu_torch.ops import lie
from dsp_slam_rgbd_tpu_torch.solvers import initializer as init_mod
from dsp_slam_rgbd_tpu_torch.solvers import pnp, pose_gn

LOCAL_PTS = 4096  # fixed capacity of the tracked local-point set
N_STATS = 7       # length of one stage's stats vector


class Frame(NamedTuple):
    feats: orb.Features
    ur: torch.Tensor       # (F,) stereo right-x, −1 if none
    depth: torch.Tensor    # (F,) metric depth, −1 if none
    t_cw: torch.Tensor     # (4, 4)
    pt_idx: torch.Tensor   # (F,) int32 matched map-point slot or −1
    timestamp: float


def _point_set(P: int, pt_idx: torch.Tensor) -> torch.Tensor:
    """(P,) bool: the slots named in pt_idx (−1 entries ignored)."""
    return ms.mark(P + 1, torch.where(pt_idx >= 0, pt_idx.long(), P))[:P]


def _match_body(cam, t_cw, pt_pos, pt_valid, pt_desc, feat_xy,
                feat_desc, feat_level, feat_valid, radius,
                pt_normal=None, pt_min_d=None, pt_max_d=None,
                feat_angle=None, pt_angle=None,
                check_rotation: bool = False):
    """Project candidate points into the frame and match by descriptor
    (`SearchByProjection(F, vpMapPoints)`, `ORBmatcher.cc:45`): a dense
    radius mask + Hamming argmin.  pt_normal/min_d/max_d enable the
    reference's `isInFrustum` gates.  Returns (per-feature point idx or −1,
    valid, the per-point frustum verdict)."""
    pc = lie.transform_points(t_cw, pt_pos)
    uv = cam_ops.project(cam, pc)
    in_front = pc[:, 2] > 0.1
    h_margin = 50.0
    in_img = (
        (uv[:, 0] > -h_margin) & (uv[:, 0] < cam.cx * 2 + h_margin)
        & (uv[:, 1] > -h_margin) & (uv[:, 1] < cam.cy * 2 + h_margin)
    )
    cand = pt_valid & in_front & in_img
    if pt_min_d is not None:
        cam_center = lie.inv_se3(t_cw)[:3, 3]
        po = pt_pos - cam_center
        dist = torch.linalg.vector_norm(po, dim=-1)
        cand = cand & (dist >= 0.8 * pt_min_d) & (dist <= 1.2 * pt_max_d)
        if pt_normal is not None:
            cosv = torch.sum(po * pt_normal, dim=-1) / torch.clamp_min(dist, 1e-9)
            has_n = torch.linalg.vector_norm(pt_normal, dim=-1) > 1e-6
            cand = cand & (~has_n | (cosv > 0.5))

    # per-feature scale-dependent radius (reference: th·scaleFactor^octave)
    r = radius * (1.2 ** feat_level.float())
    d2 = torch.sum((feat_xy[:, None, :] - uv[None, :, :]) ** 2, dim=-1)
    mask = (d2 <= (r[:, None] ** 2)) & cand[None, :]
    m = matcher.match(feat_desc, feat_valid, pt_desc, cand, mask=mask,
                      max_dist=matcher.TH_HIGH, ratio=0.85, mutual=True,
                      angles_a=feat_angle, angles_b=pt_angle,
                      check_rotation=check_rotation)
    return torch.where(m.valid, m.idx, -1), m.valid, cand


match_local_points = _match_body


def _frame_epilogue(t_cw, last_t_cw, ref_pose):
    """The motion-model velocity (orthonormalized: it re-enters every pose
    prediction) and the relative-trajectory transform T_rel = T_cw·T_ref⁻¹."""
    velocity = lie.orthonormalize_se3(t_cw @ lie.inv_se3(last_t_cw))
    t_rel = t_cw @ lie.inv_se3(ref_pose)
    return velocity, t_rel


def _local_window_device(state: ms.MapState, pt_idx: torch.Tensor,
                         n_keep: int) -> torch.Tensor:
    """The `UpdateLocalKeyFrames` role (`src/Tracking.cc:1309-1398`): vote
    KFs by shared observations with the tracked points `pt_idx` (point
    slots, −1 ignored), take the top-`n_keep` voters, the best covisible
    neighbor of the 3 strongest, and the newest KF.  Returns ONE int32
    vector `[top_0..top_{n_keep-1}, nb_0..nb_2, newest]` (−1 = empty)."""
    P = state.pt_pos.shape[0]
    pt_in_set = _point_set(P, pt_idx)
    ok = ms._obs_ok(state)
    hit = ok & pt_in_set[torch.clamp_min(state.kf_feat_pt, 0).long()]
    votes = torch.sum(hit, dim=1).to(torch.int32) * state.kf_valid.to(torch.int32)
    order = torch.argsort(-votes, stable=True)
    top = order[:n_keep]
    top = torch.where(votes[top] > 0, top, -1)
    n3 = min(3, n_keep)
    rows = covis.covisibility_rows(state, torch.clamp_min(top[:n3], 0))
    b = torch.argmax(rows, dim=1)
    good = (rows.gather(1, b[:, None])[:, 0] >= covis.MIN_WEIGHT) & (top[:n3] >= 0)
    nbs = torch.where(good, b, -1)
    newest = torch.argmax(torch.where(state.kf_valid, state.kf_frame_id, -1))
    newest = torch.where(torch.any(state.kf_valid), newest, -1)
    return torch.cat([top, nbs, newest[None]]).to(torch.int32)


def _gather_local_points_device(state: ms.MapState,
                                kf_window_mask: torch.Tensor):
    """(LOCAL_PTS,) indices + mask of the points observed by the KF window:
    members first in slot order, as `lax.top_k` over the mask gives."""
    pmask = ms.point_mask_of(state, kf_window_mask)
    idx, mask = ms.first_members(pmask, LOCAL_PTS)
    pad = LOCAL_PTS - idx.shape[0]  # tiny test maps hold < LOCAL_PTS
    return (torch.nn.functional.pad(idx, (0, pad)),
            torch.nn.functional.pad(mask, (0, pad)))


def _gather_local_points(state: ms.MapState, kf_window: np.ndarray):
    """Host wrapper: the window's KF slots as a mask."""
    kf_mask = np.zeros(state.kf_valid.shape[0], bool)
    kf_mask[np.asarray(kf_window, np.int64)] = True
    return _gather_local_points_device(state, torch.from_numpy(kf_mask).to(state.kf_valid.device))


def _track_stage_core(cam, state: ms.MapState, vote_pt_idx, base_pt_idx,
                      t_init, feat_xy, feat_desc, feat_level, feat_valid,
                      feat_angle, ur, depth, last_pt_idx, last_angles,
                      radius, th_depth_m, n_keep: int, check_rotation: bool,
                      stereo: bool, update_stats: bool):
    """One tracking stage on the device, with no host sync: local-KF window
    retrieval (`UpdateLocalKeyFrames`), local-point gather, projective
    matching (`SearchByProjection`) and robust pose GN.

    vote_pt_idx: (F,) feature→point slots used to VOTE the window (last
    frame's for motion-model, the current frame's for track-local-map).
    base_pt_idx: (F,) associations kept where this stage finds no match.
    last_pt_idx/last_angles feed the rotation-consistency gate.

    Returns (t_cw, pt_final, stats, pt_visible', pt_found') with stats =
    [n_matched, n_inliers, ref_kf, n_close_tracked, n_close_free, ref_n,
    n_window_pts] (int32, on the device) and the found/visible arrays None
    unless update_stats.
    """
    K = state.kf_valid.shape[0]
    P = state.pt_pos.shape[0]
    dev = state.kf_valid.device

    # ---- local-KF window by shared observations (Tracking.cc:1309-1398) --
    in_set = _point_set(P, vote_pt_idx)
    ok_tab = ms._obs_ok(state)
    hit = ok_tab & in_set[torch.clamp_min(state.kf_feat_pt, 0).long()]
    votes = torch.sum(hit, dim=1).to(torch.int32) * state.kf_valid.to(torch.int32)
    order = torch.argsort(-votes, stable=True)
    nk = min(n_keep, K)
    top = order[:nk]
    top_ok = votes[top] > 0
    # best covisible neighbor of the 3 strongest voters (:1368-1392)
    n3 = min(3, nk)
    rows = covis.covisibility_rows(state, top[:n3])
    b = torch.argmax(rows, dim=1)
    good = (rows.gather(1, b[:, None])[:, 0] >= covis.MIN_WEIGHT) & top_ok[:n3]
    newest = torch.argmax(torch.where(state.kf_valid, state.kf_frame_id, -1))
    has_kf = torch.any(state.kf_valid)
    wmask = ms.mark(K + 1, torch.cat([torch.where(top_ok, top, K), torch.where(good, b, K),
                                      torch.where(has_kf, newest, K)[None]]))
    # fallback window: the nk newest valid KFs (bootstrap, post-reloc)
    _, recent = top_k_stable(torch.where(state.kf_valid, state.kf_frame_id, -1), nk)
    rmask = ms.mark(K + 1, torch.where(state.kf_valid[recent], recent, K))
    # (device scalars index by gather: as a subscript they are read on the host)
    any_votes = votes.gather(0, order[:1])[0] > 0
    wmask = torch.where(any_votes, wmask, rmask)[:K]
    ref_kf = torch.where(any_votes, order[0],
                         torch.where(has_kf, newest, -1)).to(torch.int32)

    # ---- local points + projective match ----
    idx, mask = _gather_local_points_device(state, wmask)
    pt_angle = torch.full((P + 1,), torch.nan, dtype=torch.float32, device=dev)
    pt_angle[torch.where(last_pt_idx >= 0, last_pt_idx.long(), P)] = last_angles
    pt_li, matched, in_frustum = _match_body(
        cam, t_init, state.pt_pos[idx], state.pt_valid[idx] & mask,
        state.pt_desc[idx], feat_xy, feat_desc, feat_level, feat_valid,
        radius, state.pt_normal[idx], state.pt_min_d[idx],
        state.pt_max_d[idx], feat_angle=feat_angle, pt_angle=pt_angle[idx],
        check_rotation=check_rotation)
    pt_global = torch.where(pt_li >= 0, idx[torch.clamp_min(pt_li, 0)], -1)
    pt_merged = torch.where(pt_global >= 0, pt_global, base_pt_idx.long())

    # ---- robust pose GN ----
    pts_w = state.pt_pos[torch.clamp_min(pt_merged, 0)]
    obs = torch.cat([feat_xy, ur[:, None]], -1) if stereo else feat_xy
    inv_s2 = 1.0 / (1.2 ** (2.0 * feat_level.float()))
    res = pose_gn.optimize_pose(cam, t_init, pts_w, obs, inv_s2,
                                (pt_merged >= 0) & feat_valid, stereo=stereo)
    pt_final = torch.where(res.inliers, pt_merged, -1).to(torch.int32)

    # ---- stats for the host's decisions (incl. NeedNewKeyFrame census) --
    n_matched = torch.sum(pt_merged >= 0)
    close = (depth > 0) & (depth < th_depth_m) & feat_valid
    n_cl_tracked = torch.sum(close & (pt_final >= 0))
    n_cl_free = torch.sum(close & (pt_final < 0))
    rk = torch.clamp_min(ref_kf, 0).long()[None]
    ref_n = torch.sum((state.kf_feat_pt.index_select(0, rk) >= 0)
                      & state.kf_feat_valid.index_select(0, rk))
    # window point count BEFORE the LOCAL_PTS compaction: the host warns
    # when points were dropped from the tracked set (no silent caps)
    n_window_pts = torch.sum(ms.point_mask_of(state, wmask))
    stats = torch.stack([n_matched, res.n_inliers.long(), ref_kf.long(),
                         n_cl_tracked, n_cl_free, ref_n,
                         n_window_pts]).to(torch.int32)

    vis = fnd = None
    if update_stats:
        # found/visible counters (MapPoint::IncreaseVisible/Found): visible
        # only for points passing the frustum test (Tracking.cc:1592)
        ones = torch.ones(idx.shape[0], dtype=torch.int32, device=dev)
        visible = torch.zeros(P + 1, dtype=torch.int32, device=dev)
        visible.scatter_add_(0, torch.where(mask & in_frustum, idx, P), ones)
        found = torch.zeros(P + 1, dtype=torch.int32, device=dev)
        found.scatter_add_(0, torch.where(pt_final >= 0, pt_final.long(), P),
                           torch.ones_like(pt_final))
        vis = state.pt_visible + visible[:P]
        fnd = state.pt_found + found[:P]
    return res.t_cw, pt_final, stats, vis, fnd


def _fetch(stats: torch.Tensor) -> np.ndarray:
    """The host's one read of a stage's stats vector."""
    return stats.cpu().numpy()


def _track_frame_fused(cam, state: ms.MapState, t_last, velocity,
                       feat_xy, feat_desc, feat_level, feat_valid,
                       feat_angle, ur, depth, last_pt_idx, last_angles,
                       radius, th_depth_m, n_keep: int, stereo: bool,
                       pre_fetch=None):
    """The per-frame tracking pipeline: the motion-model stage
    (`TrackWithMotionModel`, with the doubled-window retry of
    `Tracking.cc:966-976`) and, when it succeeds, the local-map stage
    (`TrackLocalMap`).  The host reads the motion-model stage's stats to
    take the branch, and the local-map stage's at the end (`pre_fetch` is
    called just before that read).

    Returns (t_cw, pt_idx, stats, pt_visible', pt_found') with host stats
    = [s1(7) | s2(7) | mm_ok]; s2 = −1s when the motion-model stage failed
    (the host falls back to reference-KF tracking / relocalization)."""
    F = feat_xy.shape[0]
    base = torch.full((F,), -1, dtype=torch.int32, device=feat_xy.device)
    t_pred = velocity @ t_last

    def run(r, vote, base_idx, t0, rot: bool, upd: bool):
        return _track_stage_core(
            cam, state, vote, base_idx, t0, feat_xy, feat_desc, feat_level,
            feat_valid, feat_angle, ur, depth, last_pt_idx, last_angles,
            r, th_depth_m, n_keep, rot, stereo, upd)

    t1, pt1, s1, _, _ = run(radius, last_pt_idx, base, t_pred, True, False)
    s1 = _fetch(s1)
    if s1[0] < 20:
        t1, pt1, s1, _, _ = run(2.0 * radius, last_pt_idx, base, t_pred, True, False)
        s1 = _fetch(s1)
    mm_ok = bool(s1[0] >= 20 and s1[1] >= 10)
    if mm_ok:
        t2, pt2, s2, vis, fnd = run(4.0, pt1, pt1, t1, False, True)
        if pre_fetch is not None:
            pre_fetch()
        s2 = _fetch(s2)
    else:
        t2, pt2, vis, fnd = t1, pt1, state.pt_visible, state.pt_found
        s2 = np.full(N_STATS, -1, np.int32)
    stats = np.concatenate([s1, s2, np.asarray([int(mm_ok)], np.int32)])
    return t2, pt2, stats, vis, fnd


def _track_frame_device(cam, state: ms.MapState, t_last, velocity,
                        feat_xy, feat_desc, feat_level, feat_valid,
                        feat_angle, ur, depth, last_pt_idx, last_angles,
                        radius, th_depth_m, n_keep: int, stereo: bool):
    """`_track_frame_fused` with no host read, for the pipelined path: the
    retry at twice the radius and the local-map stage always run, and the
    motion-model stage's counts select their results on the device, as the
    JAX package's `lax.cond`s choose them.  Returns (t_cw, pt_idx, stats (15,)
    on the device, pt_visible', pt_found')."""
    F = feat_xy.shape[0]
    base = torch.full((F,), -1, dtype=torch.int32, device=feat_xy.device)
    t_pred = velocity @ t_last

    def run(r, vote, base_idx, t0, rot: bool, upd: bool):
        return _track_stage_core(
            cam, state, vote, base_idx, t0, feat_xy, feat_desc, feat_level,
            feat_valid, feat_angle, ur, depth, last_pt_idx, last_angles,
            r, th_depth_m, n_keep, rot, stereo, upd)

    t1, pt1, s1, _, _ = run(radius, last_pt_idx, base, t_pred, True, False)
    t1b, pt1b, s1b, _, _ = run(2.0 * radius, last_pt_idx, base, t_pred, True, False)
    retry = s1[0] < 20
    t1, pt1, s1 = (torch.where(retry, t1b, t1), torch.where(retry, pt1b, pt1),
                   torch.where(retry, s1b, s1))
    mm_ok = (s1[0] >= 20) & (s1[1] >= 10)
    t2, pt2, s2, vis, fnd = run(4.0, pt1, pt1, t1, False, True)
    stats = torch.cat([s1, torch.where(mm_ok, s2, -1), mm_ok.to(torch.int32)[None]])
    return (torch.where(mm_ok, t2, t1), torch.where(mm_ok, pt2, pt1), stats,
            torch.where(mm_ok, vis, state.pt_visible), torch.where(mm_ok, fnd, state.pt_found))


def _copy_to_host_async(stats: torch.Tensor):
    """Start the stats' copy to the host: (pinned buffer, event) on the
    card; on the CPU the tensor itself."""
    if stats.device.type != "cuda":
        return stats, None
    host = torch.empty(stats.shape, dtype=stats.dtype, pin_memory=True)
    host.copy_(stats, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _host_stats(pending) -> np.ndarray:
    """Wait for a copy from `_copy_to_host_async` and read it."""
    host, event = pending
    if event is not None:
        event.synchronize()
    return host.numpy()


class Tracker:
    """Host-driven tracking state machine (stereo, RGB-D and mono,
    synchronous or one frame deep with `TrackingConfig.pipelined`).

    `state` must live on `device`; entry points default to the card and
    raise without one unless given device="cpu"."""

    def __init__(self, cfg: SystemConfig, state: ms.MapState, device="cuda"):
        self.device = device_mod.resolve(device)
        self.cfg = cfg
        self.state = state
        self.status = "NOT_INITIALIZED"
        self.velocity = torch.eye(4, device=self.device)  # T_curr_prev model
        self.last_frame: Optional[Frame] = None
        self.ref_kf = -1
        self.last_kf_frame_id = -1
        self.frame_id = -1
        self.init_ref: Optional[Frame] = None  # mono initialization anchor
        # (timestamp, T_cw, ok) per frame — absolute at track time
        self.trajectory = []
        # (timestamp, ref_kf_slot, T_rel = T_cw·T_ref⁻¹, ok, frame id), as
        # the reference stores frame poses (`System::SaveTrajectoryTUM`);
        # the frame id names the entry (timestamps need not be distinct)
        self.relative_trajectory = []
        self.n_inliers_last = 0
        self.map_changed = False  # set by the System on loop closure / GBA
        # PnP trial samples (the JAX package's PRNGKey(0) stream)
        self._gen = torch.Generator(device=self.device).manual_seed(0)
        # mono H/F RANSAC samples, drawn on the CPU (initializer.draw_indices)
        self._init_gen = torch.Generator().manual_seed(0)
        self._kv_memo = None  # (kf_valid tensor, host copy)
        self._stage_stats = None  # last tracking stage's stats (np)
        self._inflight = None     # the pipelined path's dispatched frame
        # frames whose covisible window held more points than LOCAL_PTS
        self.local_pts_overflows = 0
        # optional place-recognition hook: frame -> candidate KF slots
        # (the `DetectRelocalizationCandidates` path, KeyFrameDatabase.cc:199)
        self.reloc_candidates_fn = None
        # optional mapping-idleness probe: keyframe condition c1b waits for
        # an idle mapper (`Tracking.cc:1103-1110` bLocalMappingIdle)
        self.mapping_idle_fn = None
        # optional hook called just before the per-frame stats read, so a
        # wait that must happen this frame rides under it
        self.pre_fetch_hook = None

    # ------------------------------------------------------------------
    def _upload_image(self, img) -> torch.Tensor:
        """Host→device image transfer: uint8 inputs travel as 1 byte/px and
        are cast to f32 on the device."""
        return orb.to_image(orb.upload(img, self.device))

    def make_frame(self, img, img_right=None, depth_map=None,
                   timestamp: float = 0.0) -> Frame:
        cam = self.cfg.cam
        if img_right is not None:
            il = self._upload_image(img)
            ir = self._upload_image(img_right)
            feats, fr = orb.extract_pair(il, ir, self.cfg.orb)
            sm = stereo_mod.match_stereo(feats, fr, il, ir, cam.bf,
                                         min_z=cam.bf / cam.fx)
            ur, dep = sm.u_right, sm.depth
        else:
            feats = orb.extract(self._upload_image(img), self.cfg.orb)
            F = feats.xy.shape[0]
            ur = torch.full((F,), -1.0, device=self.device)
            dep = torch.full((F,), -1.0, device=self.device)
            if depth_map is not None:
                dm = orb.upload(depth_map, self.device).float()
                sm = stereo_mod.depth_to_stereo(feats, dm, cam.bf, self.cfg.depth_scale)
                ur, dep = sm.u_right, sm.depth
        if any(abs(d) > 0.0 for d in cam.dist):
            # keypoint undistortion (`Frame::UndistortKeyPoints`), after
            # stereo matching, which needs raw pixel alignment
            feats = feats._replace(xy=cam_ops.undistort_pixels(cam, feats.xy))
        F = feats.xy.shape[0]
        return Frame(feats, ur, dep, torch.eye(4, device=self.device),
                     torch.full((F,), -1, dtype=torch.int32, device=self.device),
                     timestamp)

    # ------------------------------------------------------------------
    def track(self, img=None, img_right=None, depth_map=None,
              timestamp: float = 0.0, frame: Optional[Frame] = None) -> list:
        """Process one frame.  Returns a list of status dicts in frame order;
        the caller handles keyframe insertion for each whose "new_kf" is set.
        `frame`: a pre-built Frame (`system/prefetch.FramePrefetcher`).

        With `TrackingConfig.pipelined`, in the steady OK state this call
        queues this frame's stages and finalizes the previous frame, so the
        dicts describe the previous frame (none, or two after a failure);
        while the pipeline primes, a provisional dict (``provisional=True``)
        is returned.  State-machine transitions drain the pipeline and run
        synchronously."""
        self.frame_id += 1
        if frame is None:
            frame = self.make_frame(img, img_right, depth_map, timestamp)
        else:
            timestamp = frame.timestamp

        if self.status == "NOT_INITIALIZED":
            out = {"new_kf": False, "frame": frame, "ok": False,
                   "fid": self.frame_id, "timestamp": timestamp}
            ok = self._stereo_init(frame) if self._stereo else self._mono_init(frame)
            if ok:
                self.status = "OK"
                out["new_kf"] = True  # map init creates the first KF
                out["ok"] = True
                self.trajectory.append((timestamp, self.last_frame.t_cw, True))
            out["frame"] = self.last_frame or frame
            return [out]
        if self.cfg.tracking.pipelined and self.status == "OK" \
                and self.last_frame is not None and not self.map_changed:
            return self._track_pipelined(frame, timestamp)
        outs = self.finalize_pending()  # drain the pipeline before a sync frame
        return outs + self._track_sync(frame, timestamp, self.frame_id)

    def _track_sync(self, frame: Frame, timestamp: float, fid: int) -> list:
        """The synchronous per-frame path: the fast path, then the fallback
        chain when its motion-model stage failed."""
        ok = False
        fused_done = False
        if self.status == "OK" and self.last_frame is not None:
            frame, ok, fused_done = self._track_frame_fast(frame)
        if not fused_done:
            if self.status == "OK" and not ok:
                frame, ok = self._track_reference_kf(frame)
            if self.status == "LOST" or not ok:
                frame, ok = self._relocalize(frame)
            if ok:
                frame, n_tracked = self._track_local_map(frame)
                ok = n_tracked >= self.cfg.tracking.min_tracked_for_ok
                self.n_inliers_last = n_tracked
        return [self._commit_frame(frame, timestamp, fid, ok)]

    def _commit_frame(self, frame: Frame, timestamp: float, fid: int,
                      ok: bool, velocity=None, t_rel=None, rel_ref=None) -> dict:
        """Per-frame epilogue: status transition, motion-model velocity,
        trajectory entries (device tensors), keyframe census.  The pipelined
        path passes the velocity and T_rel it computed at dispatch, with the
        reference keyframe T_rel is relative to."""
        was_lost = self.status == "LOST"
        self.status = "OK" if ok else "LOST"
        eye = torch.eye(4, device=self.device)
        if velocity is None:
            last_t = self.last_frame.t_cw if self.last_frame is not None else eye
            ref_pose = self.state.kf_pose[self.ref_kf] if self.ref_kf >= 0 else eye
            velocity, t_rel = _frame_epilogue(frame.t_cw, last_t, ref_pose)
        if ok and self.last_frame is not None and not was_lost:
            self.velocity = velocity
        elif was_lost:
            # the pose before a loss is meaningless: a velocity against it
            # poisons the motion model after relocalization
            self.velocity = eye
        self.trajectory.append((timestamp, frame.t_cw, ok))
        ref = rel_ref if rel_ref is not None else self.ref_kf
        if ref >= 0:
            self.relative_trajectory.append((timestamp, ref, t_rel, ok, fid))
        self.last_frame = frame
        return {"frame": frame, "ok": ok, "fid": fid, "timestamp": timestamp,
                "new_kf": ok and self._need_new_keyframe(fid)}

    # ---- one-frame-deep pipelined tracking ---------------------------
    def _dispatch_pipelined(self, frame: Frame, timestamp: float) -> dict:
        """Queue the tracking stages of `frame` against the optimistic last
        outputs (the in-flight frame's, if any) and the pose epilogue, and
        start the stats' copy to the host; no host read."""
        infl = self._inflight
        if infl is not None:
            lf_pt, lf_ang, base_t = infl["pt_idx"], infl["frame"].feats.angle, infl["t_cw"]
        else:
            lf = self.last_frame
            lf_pt, lf_ang, base_t = lf.pt_idx, lf.feats.angle, lf.t_cw
        pre_state = self.state
        t_cw, pt_idx, stats, vis, fnd = _track_frame_device(
            self.cfg.cam, self.state, base_t, self.velocity,
            frame.feats.xy, frame.feats.desc, frame.feats.level,
            frame.feats.valid, frame.feats.angle, frame.ur, frame.depth,
            lf_pt, lf_ang, self._radius, self._th_depth_m(),
            self.cfg.map.local_window, self._stereo)
        stats_host = _copy_to_host_async(stats)
        self.state = self.state._replace(pt_visible=vis, pt_found=fnd)
        # ref_kf is one frame stale here: T_rel is exact for whichever
        # keyframe it records
        eye = torch.eye(4, device=self.device)
        ref_pose = self.state.kf_pose[self.ref_kf] if self.ref_kf >= 0 else eye
        vel, t_rel = _frame_epilogue(t_cw, base_t, ref_pose)
        return {"fid": self.frame_id, "frame": frame, "t_cw": t_cw, "pt_idx": pt_idx,
                "stats": stats_host, "ts": timestamp, "pre_state": pre_state,
                "vel": vel, "t_rel": t_rel, "ref": self.ref_kf}

    def _track_pipelined(self, frame: Frame, timestamp: float) -> list:
        infl = self._inflight
        disp = self._dispatch_pipelined(frame, timestamp)
        self._inflight = disp
        if infl is None:
            # priming: this frame's decisions come with the next call
            prov = frame._replace(t_cw=disp["t_cw"], pt_idx=disp["pt_idx"])
            return [{"frame": prov, "ok": True, "new_kf": False, "fid": disp["fid"],
                     "timestamp": timestamp, "provisional": True}]
        return self._finalize_one(infl, speculative=disp)

    def finalize_pending(self) -> list:
        """Finalize the in-flight pipelined frame, if any (state
        transitions, flush, shutdown)."""
        infl = self._inflight
        if infl is None:
            return []
        self._inflight = None
        return self._finalize_one(infl, speculative=None)

    def _finalize_one(self, infl: dict, speculative) -> list:
        """Read and decide the in-flight frame.  On success its optimistic
        outputs are committed and the speculative next dispatch stays valid;
        on failure the speculative dispatch is rewound, the fallback chain
        runs for the failed frame, and the speculative frame is tracked again
        synchronously."""
        if self.pre_fetch_hook is not None:
            self.pre_fetch_hook()
        stats = _host_stats(infl["stats"])
        self._warn_local_overflow(stats)
        if stats[9] >= 0:
            self.ref_kf = int(stats[9])
        elif stats[2] >= 0:
            self.ref_kf = int(stats[2])
        ok = False
        if stats[14] != 0:
            self._stage_stats = stats[7:14]
            n_tracked = int(stats[8])
            ok = n_tracked >= self.cfg.tracking.min_tracked_for_ok
        else:
            self._stage_stats = stats[0:7]
        if ok:
            self.n_inliers_last = n_tracked
            frame1 = infl["frame"]._replace(t_cw=infl["t_cw"], pt_idx=infl["pt_idx"])
            return [self._commit_frame(frame1, infl["ts"], infl["fid"], True,
                                       velocity=infl["vel"], t_rel=infl["t_rel"],
                                       rel_ref=infl["ref"])]
        if speculative is not None:
            self.state = speculative["pre_state"]
            self._inflight = None
        frame1, ok2 = self._track_reference_kf(infl["frame"])
        if not ok2:
            frame1, ok2 = self._relocalize(frame1)
        if ok2:
            frame1, n = self._track_local_map(frame1)
            ok2 = n >= self.cfg.tracking.min_tracked_for_ok
            self.n_inliers_last = n
        outs = [self._commit_frame(frame1, infl["ts"], infl["fid"], ok2)]
        if speculative is not None:
            outs += self._track_sync(speculative["frame"], speculative["ts"],
                                     speculative["fid"])
        return outs

    # ------------------------------------------------------------------
    def _stereo_init(self, frame: Frame) -> bool:
        """Reference stereo init (`Tracking.cc:551-605`): enough features
        with depth; the map starts at the configured first pose (fork's
        ground-frame init, `Tracking.cc:759-794`) or the identity."""
        n_depth = int(torch.sum((frame.depth > 0) & frame.feats.valid))
        if n_depth < 100:
            return False
        t0 = torch.eye(4, device=self.device)
        if self.cfg.t_world_camera0 is not None:
            t_wc = torch.tensor(self.cfg.t_world_camera0, dtype=torch.float32,
                                device=self.device)
            t0 = lie.inv_se3(t_wc)
        self.last_frame = frame._replace(t_cw=t0)
        return True

    def _mono_init(self, frame: Frame) -> bool:
        """Two-frame H/F initialization (`Tracking.cc:607-819`)."""
        if self.init_ref is None:
            if int(torch.sum(frame.feats.valid)) > 100:
                self.init_ref = frame
            return False
        ref = self.init_ref
        m = matcher.match(
            ref.feats.desc, ref.feats.valid, frame.feats.desc, frame.feats.valid,
            mask=matcher.radius_mask(ref.feats.xy, frame.feats.xy, 100.0),
            max_dist=matcher.TH_LOW, ratio=0.9, mutual=True,
            # rotation-consistency histogram gate (reference
            # `SearchForInitialization`, ORBmatcher.cc:405 + rotHist)
            angles_a=ref.feats.angle, angles_b=frame.feats.angle, check_rotation=True)
        if int(torch.sum(m.valid)) < 100:
            self.init_ref = frame  # reference refresh, as the reference does
            return False
        uv2 = frame.feats.xy[torch.clamp_min(m.idx, 0)]
        res = init_mod.initialize(self.cfg.cam, ref.feats.xy, uv2, m.valid, self._init_gen)
        # one read: [ok | good | points]
        n = res.good.shape[0]
        host = torch.cat([res.ok.float()[None], res.good.float(),
                          res.pts_w.reshape(-1)]).cpu().numpy()
        if not host[0]:
            return False
        # median-depth normalization (reference :770-800)
        good = host[1:1 + n] > 0.5
        pts = host[1 + n:].reshape(n, 3)
        med = max(float(np.median(pts[good, 2])) if good.any() else 1.0, 1e-6)
        t21 = torch.cat([torch.cat([res.t_21[:3, :3], res.t_21[:3, 3:] / med], 1),
                         res.t_21[3:]])
        self.init_result = {"ref_frame": ref, "cur_frame": frame, "matches": m, "t21": t21,
                            "pts": res.pts_w / med, "good": res.good}
        self.last_frame = frame._replace(t_cw=t21)
        return True

    # ------------------------------------------------------------------
    @property
    def _stereo(self) -> bool:
        return self.cfg.sensor in ("stereo", "rgbd")

    @property
    def _radius(self) -> float:
        """Motion-model search radius: 7 stereo/RGB-D, 15 mono
        (`Tracking.cc:957-963`)."""
        return 7.0 if self._stereo else 15.0

    def _th_depth_m(self) -> float:
        cam = self.cfg.cam
        return cam.bf / max(cam.fx, 1e-9) * self.cfg.tracking.th_depth

    def _pose_from_matches(self, frame: Frame, pt_idx, matched, t_init):
        pts_w = self.state.pt_pos[torch.clamp_min(pt_idx, 0).long()]
        use_stereo = bool(torch.any(frame.ur >= 0))
        obs = torch.cat([frame.feats.xy, frame.ur[:, None]], -1) if use_stereo \
            else frame.feats.xy
        inv_s2 = 1.0 / (1.2 ** (2.0 * frame.feats.level.float()))
        res = pose_gn.optimize_pose(self.cfg.cam, t_init, pts_w, obs, inv_s2,
                                    matched & frame.feats.valid, stereo=use_stereo)
        pt_final = torch.where(res.inliers, pt_idx, -1).to(torch.int32)
        return frame._replace(t_cw=res.t_cw, pt_idx=pt_final), int(res.n_inliers)

    def _run_stage(self, frame: Frame, vote_pt_idx, base_pt_idx, t_init,
                   radius: float, check_rotation: bool, update_stats: bool):
        """Run one tracking stage and fetch its stats vector."""
        lf = self.last_frame if self.last_frame is not None else frame
        t_cw, pt_final, stats, vis, fnd = _track_stage_core(
            self.cfg.cam, self.state, vote_pt_idx, base_pt_idx, t_init,
            frame.feats.xy, frame.feats.desc, frame.feats.level,
            frame.feats.valid, frame.feats.angle, frame.ur, frame.depth,
            lf.pt_idx, lf.feats.angle, radius, self._th_depth_m(),
            self.cfg.map.local_window, check_rotation, self._stereo, update_stats)
        stats = _fetch(stats)  # the single per-stage host sync
        self._warn_local_overflow(stats)
        if update_stats:
            self.state = self.state._replace(pt_visible=vis, pt_found=fnd)
        if stats[2] >= 0:
            self.ref_kf = int(stats[2])
        self._stage_stats = stats
        return frame._replace(t_cw=t_cw, pt_idx=pt_final), stats

    def _warn_local_overflow(self, stats):
        """Count + warn (once) when the frame's covisible window exceeded
        the LOCAL_PTS gather capacity (no silent caps)."""
        n_window = max(int(stats[6]), int(stats[13]) if len(stats) > 13 else -1)
        if n_window > LOCAL_PTS:
            self.local_pts_overflows += 1
            if self.local_pts_overflows == 1:
                warnings.warn(
                    f"local point window ({n_window}) exceeds LOCAL_PTS="
                    f"{LOCAL_PTS}; overflow points are not tracked this frame",
                    RuntimeWarning)

    def _update_last_frame(self):
        """`Tracking::UpdateLastFrame` (Tracking.cc:921-947): after a big map
        change (`map_changed`), re-derive the last frame's pose from its
        reference keyframe's current pose and the stored relative
        transform.  The velocity is kept: it is camera-relative."""
        if not self.map_changed or self.last_frame is None:
            return
        rel = self.relative_trajectory
        if not rel:
            return
        ts, ref, t_rel, ok, _fid = rel[-1]
        if not ok or ts != self.last_frame.timestamp:
            return
        t_cw = lie.orthonormalize_se3(
            torch.as_tensor(t_rel, device=self.device) @ self.state.kf_pose[ref])
        self.last_frame = self.last_frame._replace(t_cw=t_cw)
        self.map_changed = False

    def _track_frame_fast(self, frame: Frame):
        """Motion-model + local-map tracking (see `_track_frame_fused`).
        Returns (frame, ok, fused_done); fused_done=False means the
        motion-model stage failed and the host runs the fallback chain."""
        self._update_last_frame()
        lf = self.last_frame
        radius = self._radius
        t_cw, pt_idx, stats, vis, fnd = _track_frame_fused(
            self.cfg.cam, self.state, lf.t_cw, self.velocity,
            frame.feats.xy, frame.feats.desc, frame.feats.level,
            frame.feats.valid, frame.feats.angle, frame.ur, frame.depth,
            lf.pt_idx, lf.feats.angle, radius, self._th_depth_m(),
            self.cfg.map.local_window, self._stereo, pre_fetch=self.pre_fetch_hook)
        # ref KF = top covisibility voter, stage 2's when it ran
        if stats[9] >= 0:
            self.ref_kf = int(stats[9])
        elif stats[2] >= 0:
            self.ref_kf = int(stats[2])
        self._warn_local_overflow(stats)
        if stats[14] == 0:  # motion-model stage failed → fallback chain
            self._stage_stats = stats[0:7]
            return frame, False, False
        self.state = self.state._replace(pt_visible=vis, pt_found=fnd)
        self._stage_stats = stats[7:14]
        n_tracked = int(stats[8])
        self.n_inliers_last = n_tracked
        ok = n_tracked >= self.cfg.tracking.min_tracked_for_ok
        return frame._replace(t_cw=t_cw, pt_idx=pt_idx), ok, True

    def _track_motion_model(self, frame: Frame):
        """Constant-velocity prediction + projective match against the
        covisible window of the last frame's tracked points (:949), with the
        doubled-window retry (:966-976), as separate stages."""
        if self.last_frame is None:
            return frame, False
        self._update_last_frame()
        t_pred = self.velocity @ self.last_frame.t_cw
        radius = self._radius
        new_frame, stats = self._run_stage(
            frame, self.last_frame.pt_idx, frame.pt_idx, t_pred,
            radius=radius, check_rotation=True, update_stats=False)
        if stats[0] < 20:
            new_frame, stats = self._run_stage(
                frame, self.last_frame.pt_idx, frame.pt_idx, t_pred,
                radius=2.0 * radius, check_rotation=True, update_stats=False)
            if stats[0] < 20:
                return frame, False
        return new_frame, int(stats[1]) >= 10

    def _kf_matches(self, frame: Frame, k: int, ratio: float):
        """Descriptor match of the frame against KF k's mapped features ->
        (F,) point slots or −1."""
        st = self.state
        m = matcher.match(frame.feats.desc, frame.feats.valid, st.kf_desc[k],
                          st.kf_feat_valid[k] & (st.kf_feat_pt[k] >= 0),
                          max_dist=matcher.TH_LOW, ratio=ratio, mutual=True)
        return torch.where(m.valid, st.kf_feat_pt[k][torch.clamp_min(m.idx, 0)], -1)

    def _track_reference_kf(self, frame: Frame):
        """Descriptor match against the reference KF (:839)."""
        if self.ref_kf < 0:
            return frame, False
        k = self.ref_kf
        pt_idx = self._kf_matches(frame, k, 0.7)
        if int(torch.sum(pt_idx >= 0)) < 15:
            return frame, False
        t_init = self.last_frame.t_cw if self.last_frame is not None \
            else self.state.kf_pose[k]
        frame, n = self._pose_from_matches(frame, pt_idx, pt_idx >= 0, t_init)
        return frame, n >= 10

    def _track_local_map(self, frame: Frame):
        """Re-match against the full local point set at the refined pose and
        optimize once more (:1012); found/visible statistics update."""
        new_frame, stats = self._run_stage(
            frame, frame.pt_idx, frame.pt_idx, frame.t_cw,
            radius=4.0, check_rotation=False, update_stats=True)
        return new_frame, int(stats[1])

    def _relocalize(self, frame: Frame):
        """Relocalization: candidates from `reloc_candidates_fn` (a BoW
        database, when installed) or the recent KFs, then per-candidate
        descriptor match + PnP RANSAC (`Tracking::Relocalization` :1445)."""
        if self.reloc_candidates_fn is not None:
            cands = list(self.reloc_candidates_fn(frame)) or self._recent_kfs(5)
        else:
            cands = self._recent_kfs(5)
        inv_s2 = 1.0 / (1.2 ** (2.0 * frame.feats.level.float()))
        for k in cands:
            pt_idx = self._kf_matches(frame, k, 0.75)
            if int(torch.sum(pt_idx >= 0)) < 15:
                continue
            res = pnp.solve_pnp_ransac(
                self.cfg.cam, self.state.pt_pos[torch.clamp_min(pt_idx, 0).long()],
                frame.feats.xy, inv_s2, (pt_idx >= 0) & frame.feats.valid, self._gen)
            if bool(res.ok):
                pt_final = torch.where(res.inliers, pt_idx, -1).to(torch.int32)
                return frame._replace(t_cw=res.t_cw, pt_idx=pt_final), True
        return frame, False

    # ------------------------------------------------------------------
    def _need_new_keyframe(self, fid: int = None) -> bool:
        """`Tracking::NeedNewKeyFrame` parity (`src/Tracking.cc:1059-1142`):
        close-point census (`bNeedToInsertClose`), c1a (≥ MaxFrames since
        the last KF), c1b (≥ MinFrames and the mapper idle), c1c (weak
        tracking vs the reference KF, or close-point pressure), c2 (tracked
        inliers below thRefRatio of the reference KF's, or close-point
        pressure, with > 15 inliers).  Insert iff (c1a|c1b|c1c) & c2, or
        c1a with > 15 inliers (a bounded KF interval)."""
        since = (fid if fid is not None else self.frame_id) - self.last_kf_frame_id
        n_kf = int(self._kf_valid_np().sum())

        # counts from the last stage's stats vector — no extra fetches
        stats = self._stage_stats
        ref_n = int(stats[5]) if stats is not None else 0

        need_close = False
        if self._stereo and stats is not None:
            need_close = int(stats[4]) > self.cfg.tracking.close_free_th \
                and int(stats[3]) < self.cfg.tracking.close_tracked_th
            # spawned close points become visible only at adoption
            # (async_kf_frames later): gate the census meanwhile
            need_close = need_close and since > max(self.cfg.async_kf_frames, 0)

        # thRefRatio: 0.75 stereo/RGB-D, 0.9 mono, 0.4 when the map is tiny
        th_ref = 0.4 if n_kf < 2 else (0.75 if self._stereo else 0.9)

        c1a = since >= self.cfg.tracking.max_frames_between_kf
        idle = self.mapping_idle_fn() if self.mapping_idle_fn is not None else True
        c1b = since >= self.cfg.tracking.min_frames_between_kf and idle
        c1c = self._stereo and (self.n_inliers_last < ref_n * 0.25 or need_close)
        c2 = (self.n_inliers_last < ref_n * th_ref or need_close) \
            and self.n_inliers_last > 15
        return ((c1a or c1b or c1c) and c2) or (c1a and self.n_inliers_last > 15)

    def _local_kf_window(self, pt_idx=None) -> np.ndarray:
        """Local keyframes by shared observations (`UpdateLocalKeyFrames`,
        `src/Tracking.cc:1309-1365`): KFs observing the frame's tracked
        points vote; the top `local_window` voters, the best covisible
        neighbors of the strongest, and the newest KF.  The top voter
        becomes the reference KF.  Falls back to the most recent KFs when
        no point is tracked."""
        if pt_idx is not None:
            pt = pt_idx.cpu().numpy() if isinstance(pt_idx, torch.Tensor) \
                else np.asarray(pt_idx)
            pts = np.unique(pt[pt >= 0])
        else:
            pts = np.zeros(0, np.int64)
        if len(pts) == 0:
            return self._recent_window()
        n_keep = self.cfg.map.local_window
        out = _local_window_device(
            self.state, torch.as_tensor(pts, device=self.state.kf_valid.device),
            n_keep).cpu().numpy()
        top, nbs, newest = out[:n_keep], out[n_keep:-1], int(out[-1])
        voters = top[top >= 0]
        if len(voters) == 0:
            return self._recent_window()
        self.ref_kf = int(voters[0])
        window = [int(k) for k in voters]
        for b in nbs:
            if b >= 0 and int(b) not in window:
                window.append(int(b))
        if newest >= 0 and newest not in window:
            window.append(newest)
        return np.asarray(window, np.int64)

    def _kf_valid_np(self) -> np.ndarray:
        """Host copy of kf_valid, memoized by tensor identity (it changes at
        keyframe rate)."""
        kv = self.state.kf_valid
        if self._kv_memo is None or self._kv_memo[0] is not kv:
            self._kv_memo = (kv, kv.cpu().numpy())
        return self._kv_memo[1]

    def _recent_window(self) -> np.ndarray:
        valid = np.nonzero(self._kf_valid_np())[0]
        return valid[-self.cfg.map.local_window:] if len(valid) else \
            np.zeros(0, np.int64)

    def _recent_kfs(self, n: int):
        valid = np.nonzero(self._kf_valid_np())[0]
        return valid[-n:][::-1].tolist()
