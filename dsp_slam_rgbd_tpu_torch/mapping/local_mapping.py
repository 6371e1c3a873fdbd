"""Local mapping: keyframe insertion, point management, local (joint) BA.

Counterpart of `dsp_slam_rgbd_tpu/mapping/local_mapping.py`, the
`LocalMapping` pipeline (`src/LocalMapping.cc:55-164`): ProcessNewKeyFrame
(:180), close-depth point spawning (`Tracking.cc:1185-1237`),
CreateNewMapPoints (:259, two-view triangulation against the best
covisible neighbors), SearchInNeighbors fusion (:506), MapPointCulling
(:222), KeyFrameCulling (:684) and LocalJointBundleAdjustment
(`Optimizer_util.cc:309`).

Everything stays on the device: the host passes slot numbers and ids as
Python ints and reads back one small vector per keyframe (the BA counts
and the culled slots, `ba_cull_read`), plus one counts vector the first
time a map shape is seen.  BA problems are compacted to the window
(`LocalIndex` maps local blocks to map slots) with power-of-two capacity
buckets, so a map of KITTI-00 size keeps a window-sized local problem.
Compaction keeps the JAX package's order (selected entries first, each
group in slot order), which also fixes the order of assembly's sums.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from dsp_slam_rgbd_tpu_torch.frontend import matcher
from dsp_slam_rgbd_tpu_torch.frontend.fast import top_k_stable
from dsp_slam_rgbd_tpu_torch.frontend.stereo import nanmedian
from dsp_slam_rgbd_tpu_torch.mapping import ba
from dsp_slam_rgbd_tpu_torch.mapping import covisibility as covis
from dsp_slam_rgbd_tpu_torch.mapping import map_state as ms
from dsp_slam_rgbd_tpu_torch.ops import camera as cam_ops
from dsp_slam_rgbd_tpu_torch.ops import lie
from dsp_slam_rgbd_tpu_torch.ops import scatter
from dsp_slam_rgbd_tpu_torch.solvers import triangulate as tri
from dsp_slam_rgbd_tpu_torch.utils import timers


def _set_row(a: torch.Tensor, row: int, value) -> torch.Tensor:
    out = a.clone()
    if isinstance(value, torch.Tensor):
        out[row] = value
    else:  # fill_: a scalar assigned into a card tensor is copied from the host
        out[row].fill_(value)
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


def _triangulate_device(state: ms.MapState, cam, kf_slot: int, first_id: int,
                        max_new: int, n_neighbors: int):
    """Two-view triangulation against the best covisible neighbors, one
    neighbor after another: features claimed against one neighbor leave
    the free pool before the next, like the reference's sequential loop,
    and a cursor walks the pre-allocated point slots.  The cursor and the
    free mask stay tensors (no host read).  Returns (new state, n_created
    as a 0-d tensor)."""
    K = state.kf_valid.shape[0]
    P = state.pt_pos.shape[0]
    F = state.kf_feat_pt.shape[1]
    dev = state.kf_valid.device
    slots = ms.free_slots_device(state.pt_valid, max_new).long()

    # neighbor order by covisibility weight (GetBestCovisibilityKeyFrames)
    row = covis.covisibility_row(state, kf_slot)
    w_sorted, order = top_k_stable(row, min(n_neighbors, K))

    t1 = state.kf_pose[kf_slot]
    c1 = lie.inv_se3(t1)[:3, 3]
    uv1 = state.kf_xy[kf_slot]
    desc1 = state.kf_desc[kf_slot]
    slot_ok = slots >= 0
    slots_safe = torch.where(slot_ok, slots, P)
    feat_ids = torch.arange(F, device=dev)

    pt_pos, pt_valid, pt_desc = state.pt_pos, state.pt_valid, state.pt_desc
    pt_ref, pt_first = state.pt_ref_kf, state.pt_first_kf
    pt_vis, pt_fnd = state.pt_visible, state.pt_found
    kf_feat_pt = state.kf_feat_pt
    free_a = state.kf_feat_valid[kf_slot] & (state.kf_feat_pt[kf_slot] < 0)
    cursor = torch.zeros((), dtype=torch.long, device=dev)
    for i in range(order.shape[0]):
        nb = order[i:i + 1]            # (1,): a 0-d subscript is read on the host
        nb_ok = (nb != kf_slot) & (w_sorted[i:i + 1] >= covis.MIN_WEIGHT)
        t2 = state.kf_pose[nb][0]
        baseline = torch.linalg.vector_norm(lie.inv_se3(t2)[:3, 3] - c1)
        if cam.bf > 0.0:
            # stereo baseline gate (reference :289-306)
            nb_ok = nb_ok & (baseline >= cam.bf / cam.fx)
        else:
            # mono: baseline / median scene depth > 0.01
            obs_pt = kf_feat_pt[nb][0]
            seen = (obs_pt >= 0) & state.kf_feat_valid[nb][0]
            pc2 = lie.transform_points(t2, pt_pos[torch.clamp_min(obs_pt, 0).long()])
            med = nanmedian(torch.where(seen, pc2[:, 2], torch.nan))
            nb_ok = nb_ok & torch.where(torch.isfinite(med) & (med > 0),
                                        baseline / med > 0.01, True)

        free_b = state.kf_feat_valid[nb][0] & (kf_feat_pt[nb][0] < 0)
        m = matcher.match(desc1, free_a & nb_ok, state.kf_desc[nb][0], free_b,
                          max_dist=matcher.TH_LOW, ratio=0.8, mutual=True)
        m_idx = torch.clamp_min(m.idx, 0)
        uv2 = state.kf_xy[nb][0][m_idx]
        # closed-form 3x3 per point, origin-shifted for f32
        pts = tri.triangulate_two_views_fast(cam, cam, t1, t2, uv1, uv2)
        masks = tri.acceptance_masks(cam, cam, t1, t2, pts, uv1, uv2)
        good = m.valid & masks["parallax"] & masks["depth"] & masks["reproj"] \
            & torch.all(torch.isfinite(pts), dim=-1) & nb_ok

        # rank accepted features; claim slots cursor..cursor+n_good-1
        rank = torch.cumsum(good.long(), 0) - 1
        take = good & (cursor + rank < max_new)
        sl_i = torch.clamp(cursor + rank, 0, max_new - 1)
        sl = torch.where(take & slot_ok[sl_i], slots_safe[sl_i], P)   # P drops
        sl_val = torch.where(sl < P, sl, -1).to(torch.int32)

        pt_pos = _scatter(pt_pos, sl, pts)
        pt_valid = _scatter(pt_valid, sl, True)
        pt_desc = _scatter(pt_desc, sl, desc1)
        pt_ref = _scatter(pt_ref, sl, kf_slot)
        pt_first = _scatter(pt_first, sl, first_id)
        # fresh counters for recycled slots (see spawn_depth_points)
        pt_vis = _scatter(pt_vis, sl, 1)
        pt_fnd = _scatter(pt_fnd, sl, 1)
        # both keyframes' rows of the feature table, flat with a dump entry
        created = sl < P
        tgt = torch.cat([torch.where(created, kf_slot * F + feat_ids, K * F),
                         torch.where(created, nb * F + m_idx, K * F)])
        kf_feat_pt = _scatter(kf_feat_pt.reshape(-1), tgt,
                              torch.cat([sl_val, sl_val])).reshape(K, F)
        free_a = free_a & ~created
        cursor = cursor + torch.sum(created)
    return state._replace(
        pt_pos=pt_pos, pt_valid=pt_valid, pt_desc=pt_desc, pt_ref_kf=pt_ref,
        pt_first_kf=pt_first, pt_visible=pt_vis, pt_found=pt_fnd,
        kf_feat_pt=kf_feat_pt), cursor


def triangulate_new_points(state: ms.MapState, cam, kf_slot: int,
                           max_new: int = 256, n_neighbors: int = 10,
                           first_id: int | None = None) -> ms.MapState:
    """Two-view triangulation against the best covisible neighbors
    (CreateNewMapPoints :259: nn = 10 stereo / 20 mono neighbors, baseline
    gate, descriptor match of the free features).

    first_id: monotonic keyframe id for point-culling age (see
    spawn_depth_points)."""
    if first_id is None:
        first_id = kf_slot
    return _triangulate_device(state, cam, kf_slot, first_id, max_new, n_neighbors)[0]


def fuse_neighbors(state: ms.MapState, cam, kf_slot: int,
                   radius: float = 3.0) -> ms.MapState:
    """SearchInNeighbors role (:506): project the 3 best covisible
    neighbors' points into this KF; unassociated features matching a
    projected point adopt it."""
    from dsp_slam_rgbd_tpu_torch.tracking.tracker import _match_body

    K = state.kf_valid.shape[0]
    row = covis.covisibility_row(state, kf_slot)
    w, order = top_k_stable(row, min(3, K))
    nb_mask = ms.mark(K + 1, torch.where(w >= covis.MIN_WEIGHT, order, K))[:K]
    nb_pts = ms.point_mask_of(state, nb_mask)

    free = state.kf_feat_valid[kf_slot] & (state.kf_feat_pt[kf_slot] < 0)
    pt_idx, matched, _ = _match_body(
        cam, state.kf_pose[kf_slot], state.pt_pos, nb_pts & state.pt_valid,
        state.pt_desc, state.kf_xy[kf_slot], state.kf_desc[kf_slot],
        state.kf_level[kf_slot], free, radius=radius)
    new_assoc = torch.where(matched & free, pt_idx, state.kf_feat_pt[kf_slot])
    return state._replace(kf_feat_pt=_set_row(state.kf_feat_pt, kf_slot,
                                              new_assoc.to(torch.int32)))


def update_point_geometry(state: ms.MapState) -> ms.MapState:
    """Refresh per-point viewing normals and scale-invariance depth ranges:
    normal = mean direction from the observing camera centers; [min_d,
    max_d] from the reference-KF distance and the octave of its
    observation.  Edgewise over the (K, F) observation table, O(K·F).
    Normals sum in the table's order on every device (`ops/scatter.py`)."""
    K, F = state.kf_feat_pt.shape
    P = state.pt_pos.shape[0]
    centers = lie.inv_se3(state.kf_pose)[:, :3, 3]       # (K, 3)

    ok = ms._obs_ok(state)                                # (K, F)
    pt = torch.clamp_min(state.kf_feat_pt, 0).long()      # (K, F)
    diff = state.pt_pos[pt] - centers[:, None, :]         # (K, F, 3)
    dirs = diff / torch.clamp_min(torch.linalg.vector_norm(diff, dim=-1, keepdim=True), 1e-9)
    tgt = torch.where(ok, pt, P).reshape(-1)
    # the dump row P is read by nobody: its rows stay out of the sum
    nsum = scatter.scatter_add(P + 1, scatter.plan(tgt, P + 1, ok.reshape(-1)),
                               torch.where(ok[..., None], dirs, 0.0).reshape(-1, 3))
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


def cull_points(state: ms.MapState, current_id: int,
                min_found_ratio: float = 0.2,
                min_obs_after: int = 4) -> ms.MapState:
    """MapPointCulling (`LocalMapping.cc:222`): judge RECENT points only
    (age < 3 in monotonic keyframe ids, as the reference's
    mlpRecentAddedMapPoints): a recent point dies on a found/visible
    ratio under `min_found_ratio`, or with weighted observations under
    `min_obs_after` at age ≥ 2 (stereo observations count double).  Dead
    points are detached from the keyframe feature tables.

    current_id: the monotonic id of the keyframe being processed (the
    counter stamped into pt_first_kf; slot indices are recycled)."""
    n_obs = ms.point_obs_counts_weighted(state)
    ratio = state.pt_found.float() / torch.clamp_min(state.pt_visible.float(), 1.0)
    age = current_id - state.pt_first_kf
    recent = (age >= 0) & (age < 3) & (state.pt_first_kf >= 0)
    bad = recent & ((ratio < min_found_ratio) | ((age >= 2) & (n_obs < min_obs_after)))
    keep = state.pt_valid & ~bad
    dead = state.pt_valid & ~keep
    assoc = state.kf_feat_pt
    assoc = torch.where(dead[torch.clamp_min(assoc, 0).long()] & (assoc >= 0), -1, assoc)
    return state._replace(pt_valid=keep, kf_feat_pt=assoc)


def _cull_keyframes_device(state: ms.MapState, kf_slot: int,
                           redundancy: float, max_cull: int):
    """`max_cull` rounds of KeyFrameCulling: each round removes the local
    KF (covisible with kf_slot, never kf_slot itself) with the largest
    share of points seen by ≥ 3 other KFs, if that share is ≥ redundancy
    (first slot on ties).  A cull changes the counts the next round judges
    by.  Then points whose reference KF was culled are re-anchored to the
    observing KF with the newest frame id.  Returns (state, (max_cull,)
    int32 culled slots, −1 for a round that culled nothing)."""
    K = state.kf_valid.shape[0]
    P = state.pt_pos.shape[0]
    dev = state.kf_valid.device
    this = ms.mark(K, torch.full((1,), kf_slot, dtype=torch.long, device=dev))
    kf_valid, kf_feat_pt = state.kf_valid, state.kf_feat_pt
    culled = []
    for _ in range(max_cull):
        st = state._replace(kf_valid=kf_valid, kf_feat_pt=kf_feat_pt)
        n_obs = ms.point_obs_counts(st)
        local = (covis.covisibility_row(st, kf_slot) >= covis.MIN_WEIGHT) \
            & kf_valid & ~this                            # never the fresh KF
        ok = ms._obs_ok(st)
        redundant = ok & (n_obs[torch.clamp_min(kf_feat_pt, 0).long()] >= 4)
        mine = torch.sum(ok, dim=1).float()
        red = torch.sum(redundant, dim=1).float()
        cand = local & (mine > 0) & (red >= redundancy * mine)
        frac = torch.where(cand, red / torch.clamp_min(mine, 1.0), -1.0)
        k = torch.argmax(frac)[None]
        hit = cand[k]
        tgt = torch.where(hit, k, K)                      # K = dropped
        kf_valid = _scatter(kf_valid, tgt, False)
        kf_feat_pt = _scatter(kf_feat_pt, tgt, -1)
        culled.append(torch.where(hit, k, -1))
    state = state._replace(kf_valid=kf_valid, kf_feat_pt=kf_feat_pt)
    # re-anchor pt_ref_kf away from culled slots (the reference reassigns
    # mpRefKF in MapPoint::EraseObservation): the observing KF with the
    # newest frame id, by one scatter-max of frame_id·K + slot
    ok = ms._obs_ok(state)
    kf_ids = torch.arange(K, device=dev)[:, None]
    enc = torch.where(ok, state.kf_frame_id[:, None].long() * K + kf_ids, -1)
    tgt = torch.where(ok, state.kf_feat_pt.long(), P)
    best = torch.full((P + 1,), -1, dtype=torch.long, device=dev).scatter_reduce_(
        0, tgt.reshape(-1), enc.reshape(-1), reduce="amax", include_self=True)[:P]
    ref = state.pt_ref_kf
    ref_bad = (ref < 0) | ~kf_valid[torch.clamp_min(ref, 0).long()]
    new_ref = torch.where(best >= 0, best % K, -1).to(ref.dtype)
    culled_v = torch.cat(culled).to(torch.int32) if culled \
        else torch.zeros(0, dtype=torch.int32, device=dev)
    return state._replace(pt_ref_kf=torch.where(ref_bad, new_ref, ref)), culled_v


def cull_keyframes(state: ms.MapState, kf_slot: int, redundancy: float = 0.9,
                   max_cull: int = 2):
    """KeyFrameCulling (:684): local KFs whose points are ≥ 90% seen by ≥ 3
    other KFs are removed, up to `max_cull` of them.  Returns (state,
    [culled slots]); the caller purges each slot from its host mirrors.
    Culled slots' poses are left in place so trajectories can re-anchor."""
    new_state, culled_v = _cull_keyframes_device(state, kf_slot, redundancy, max_cull)
    return new_state, [int(k) for k in culled_v.cpu().numpy() if k >= 0]


def kf_point_stage(state: ms.MapState, cam, kf_slot: int, frame,
                   frame_id: int, th_depth_m: float, first_id: int,
                   stereo: bool, n_neighbors: int,
                   min_obs_after: int) -> ms.MapState:
    """The keyframe point stage with no host read: insert + (stereo/RGB-D)
    close-depth spawn + triangulation + neighbor fusion + point culling +
    point geometry."""
    state = insert_keyframe(state, frame, kf_slot, frame_id)
    if stereo:
        state = spawn_depth_points(state, cam, kf_slot, frame, th_depth_m, 256, first_id)
    state, _ = _triangulate_device(state, cam, kf_slot, first_id, 256, n_neighbors)
    state = fuse_neighbors(state, cam, kf_slot)
    state = cull_points(state, first_id, min_obs_after=min_obs_after)
    return update_point_geometry(state)


class LocalIndex(NamedTuple):
    """Compaction maps: local BA block index → global map slot (−1 pad).
    They keep the dense solve's (B, B) reduced system and (B, P_loc)
    coupling sized to the window, not the map capacity."""
    kf_idx: torch.Tensor    # (Kl,) int32
    pt_idx: torch.Tensor    # (Pl,) int32
    obj_idx: torch.Tensor   # (Ol,) int32


def _bucket(n: int, minimum: int = 16) -> int:
    """Round capacity up to a power of two."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _ba_masks(state: ms.MapState, center_kf: int, max_kfs: int,
              global_window: bool):
    """The BA problem's masks: window, frontier, involved KFs, selected
    observations (K, F) and live object edges."""
    if global_window:
        in_w = state.kf_valid
        frontier = torch.zeros_like(in_w)
        wpts = state.pt_valid
    else:
        in_w, frontier, wpts = covis.local_window(state, center_kf, max_kfs)
    # gauge anchor: with no frontier (early map: the window is the whole
    # map) the oldest keyframe is fixed (the reference fixes KF 0,
    # `Optimizer.cc:492`)
    K = in_w.shape[0]
    no_frontier = ~torch.any(frontier)
    oldest = torch.argmin(torch.where(in_w, state.kf_frame_id, torch.iinfo(torch.int32).max))
    anchor = ms.mark(K + 1, torch.where(no_frontier & torch.any(in_w), oldest, K)[None])[:K]
    frontier = frontier | anchor
    involved = in_w | frontier

    kf_pt = state.kf_feat_pt
    pt = torch.clamp_min(kf_pt, 0).long()
    sel = (kf_pt >= 0) & state.kf_feat_valid & involved[:, None] & state.kf_valid[:, None] \
        & wpts[pt] & state.pt_valid[pt]

    # object edges on involved KFs, static objects only (the reference adds
    # only static objects' relative-pose edges to the joint problem)
    okf = torch.clamp_min(state.oobs_kf, 0).long()
    oobj = torch.clamp_min(state.oobs_obj, 0).long()
    oobs_live = state.oobs_valid & involved[okf] & ~state.obj_dynamic[oobj] \
        & state.obj_valid[oobj]
    return in_w, frontier, involved, sel, oobs_live


def _counts(state: ms.MapState, involved, sel, oobs_live):
    """(5,) int32 [n_kf, n_pt, n_obs, n_obj, n_oobs] from the full masks,
    and the object mask."""
    P = state.pt_pos.shape[0]
    O = state.obj_valid.shape[0]
    pmask = ms.mark(P + 1, torch.where(sel, state.kf_feat_pt.long(), P).reshape(-1))[:P]
    omask = ms.mark(O + 1, torch.where(oobs_live, state.oobs_obj.long(), O))[:O]
    return torch.stack([torch.sum(involved), torch.sum(pmask), torch.sum(sel),
                        torch.sum(omask), torch.sum(oobs_live)]).to(torch.int32), omask


def _ba_counts_device(state: ms.MapState, center_kf: int, max_kfs: int,
                      global_window: bool) -> torch.Tensor:
    """The counts vector alone: one small read lets the host pick buckets."""
    _, _, involved, sel, oobs_live = _ba_masks(state, center_kf, max_kfs, global_window)
    return _counts(state, involved, sel, oobs_live)[0]


def _ba_assemble_device(state: ms.MapState, center_kf: int, max_kfs: int,
                        global_window: bool, Kl: int, Pl: int, Ol: int,
                        N: int, M: int):
    """Device-side compaction and gather of the BA problem at capacities
    (Kl, Pl, Ol, N, M).  Returns (BAProblem, LocalIndex, counts): counts
    come from the full masks, so a caller that assembled with guessed
    capacities can verify afterwards that nothing was cut."""
    K = state.kf_valid.shape[0]
    P = state.pt_pos.shape[0]
    F = state.kf_feat_pt.shape[1]
    O = state.obj_valid.shape[0]
    dev = state.kf_valid.device
    i32 = torch.int32
    in_w, frontier, involved, sel, oobs_live = _ba_masks(
        state, center_kf, max_kfs, global_window)
    counts, omask = _counts(state, involved, sel, oobs_live)

    # Compaction orders are `first_members`': members first, then the rest,
    # each in slot order (the JAX package's stable `argsort(~mask)[:n]`).
    # --- observation compaction: selected first over (K·F) ---
    obs_order, obs_ok = ms.first_members(sel.reshape(-1), N)
    okf, ofeat = obs_order // F, obs_order % F
    obs_pt_g = torch.where(obs_ok, state.kf_feat_pt[okf, ofeat], 0).long()
    uv = state.kf_xy[okf, ofeat]
    ur = state.kf_ur[okf, ofeat]
    obs_uv = torch.where(obs_ok[:, None], torch.cat([uv, ur[:, None]], dim=-1), 0.0)
    obs_info = torch.where(
        obs_ok, 1.0 / (1.2 ** (2.0 * state.kf_level[okf, ofeat].float())), 0.0)

    # observability guard: a point is optimized only if its in-problem
    # edges determine it: ≥ 2 observations, or ≥ 1 stereo edge
    ptgt = torch.where(obs_ok, obs_pt_g, P)
    n_obs_pt = torch.zeros(P + 1, dtype=i32, device=dev).scatter_add_(
        0, ptgt, torch.ones_like(ptgt, dtype=i32))[:P]
    has_stereo = ms.mark(P + 1, torch.where(obs_ok & (obs_uv[:, 2] >= 0), obs_pt_g, P))[:P]
    determined = (n_obs_pt >= 2) | has_stereo

    # --- keyframe / point / object compaction maps ---
    def index_and_map(mask, n, cap):
        order, ok = ms.first_members(mask, n)
        idx = torch.where(ok, order, -1).to(i32)
        local = _scatter(torch.zeros(cap, dtype=i32, device=dev),
                         torch.where(ok, order, cap), torch.arange(n, dtype=i32, device=dev))
        return idx, local

    kf_idx, kf_map = index_and_map(involved, Kl, K)
    pt_idx, pt_map = index_and_map(ms.mark(P + 1, ptgt)[:P], Pl, P)
    obj_idx, obj_map = index_and_map(omask, Ol, O)

    # --- object edge compaction ---
    oo_order, oo_ok = ms.first_members(oobs_live, M)
    oobs_kf_g = torch.where(oo_ok, state.oobs_kf[oo_order], 0)
    oobs_obj_g = torch.where(oo_ok, state.oobs_obj[oo_order], 0)
    eye = torch.eye(4, dtype=state.oobs_t_co.dtype, device=dev)
    oobs_t = torch.where(oo_ok[:, None, None], state.oobs_t_co[oo_order], eye)

    kf_sel = torch.clamp_min(kf_idx, 0).long()
    pt_sel = torch.clamp_min(pt_idx, 0).long()
    obj_sel = torch.clamp_min(obj_idx, 0).long()
    prob = ba.BAProblem(
        kf_pose=state.kf_pose[kf_sel],
        kf_fixed=frontier[kf_sel] | ~in_w[kf_sel] | (kf_idx < 0),
        kf_valid=state.kf_valid[kf_sel] & (kf_idx >= 0),
        pts=state.pt_pos[pt_sel],
        pt_valid=(pt_idx >= 0) & determined[pt_sel] & state.pt_valid[pt_sel],
        obs_kf=torch.where(obs_ok, kf_map[okf], 0),
        obs_pt=torch.where(obs_ok, pt_map[obs_pt_g], 0),
        obs_uv=obs_uv,
        obs_info=obs_info,
        obs_mask=obs_ok,
        obj_pose=state.obj_pose[obj_sel],
        obj_valid=state.obj_valid[obj_sel] & (obj_idx >= 0),
        oobs_kf=kf_map[torch.clamp_min(oobs_kf_g, 0).long()] * oo_ok,
        oobs_obj=obj_map[torch.clamp_min(oobs_obj_g, 0).long()] * oo_ok,
        oobs_t_co=oobs_t,
        oobs_mask=oo_ok,
    )
    return prob, LocalIndex(kf_idx, pt_idx, obj_idx), counts


# optimistic-bucket memo: (map shapes, window, global) → last bucket tuple.
# Buckets only grow (bounded by the map capacities), so after the first
# keyframe of a map shape the blocking counts read disappears from the
# keyframe stage: the assembly's own counts verify the guess afterwards.
_bucket_memo: dict = {}


def _shapes(state: ms.MapState):
    return (state.kf_valid.shape[0], state.pt_pos.shape[0], state.kf_feat_pt.shape[1],
            state.obj_valid.shape[0], state.oobs_valid.shape[0])


def _buckets_for(counts, K, P, F, O, Q):
    n_kf, n_pt, n_obs, n_obj, n_oobs = (int(c) for c in counts)
    Kl = min(_bucket(max(n_kf, 1)), K)
    Pl = min(_bucket(max(n_pt, 1), minimum=64), P)
    Ol = min(_bucket(max(n_obj, 1), minimum=4), O)
    N = min(_bucket(max(n_obs, 1), minimum=256), K * F)
    M = min(_bucket(max(n_oobs, 1), minimum=16), Q)
    return Kl, Pl, Ol, N, M


def _counts_fit(counts, buckets) -> bool:
    n_kf, n_pt, n_obs, n_obj, n_oobs = (int(c) for c in counts)
    Kl, Pl, Ol, N, M = buckets
    return n_kf <= Kl and n_pt <= Pl and n_obs <= N and n_obj <= Ol and n_oobs <= M


def _grown(buckets, counts, shapes):
    """Buckets grown to hold `counts` (never shrunk)."""
    return tuple(max(a, b) for a, b in zip(buckets, _buckets_for(counts, *shapes)))


def _memo_buckets(state: ms.MapState, center_kf: int, max_kfs: int, global_window: bool):
    """(memo key, buckets): the memoized guess, or the exact buckets from
    one counts read the first time a map shape is seen."""
    shapes = _shapes(state)
    key = shapes + (max_kfs, global_window)
    buckets = _bucket_memo.get(key)
    if buckets is None:
        counts = _ba_counts_device(state, center_kf, max_kfs, global_window).cpu().numpy()
        buckets = _bucket_memo[key] = _buckets_for(counts, *shapes)
    return key, buckets


def build_local_ba_problem(state: ms.MapState, center_kf: int,
                           max_kfs: int, global_window: bool = False):
    """Assemble a compact fixed-capacity BA problem for the covisible window
    (solved by `ba.local_ba` / `ba.global_ba_pcg`); with `global_window`
    every valid keyframe and point enters.  Capacities are the buckets of
    the exact counts, read first (nothing is cut).  Returns (prob, idx)."""
    shapes = _shapes(state)
    counts = _ba_counts_device(state, center_kf, max_kfs, global_window).cpu().numpy()
    buckets = _buckets_for(counts, *shapes)
    _bucket_memo[shapes + (max_kfs, global_window)] = buckets
    prob, idx, _ = _ba_assemble_device(state, center_kf, max_kfs, global_window, *buckets)
    return prob, idx


def apply_ba_result(state: ms.MapState, idx: LocalIndex, res: ba.BAResult) -> ms.MapState:
    """Scatter compact BA results back into the map.  Rotations are
    re-projected onto SO(3) on the way back: BA's f32 exp compositions
    seed orthonormality defects that the tracker's velocity chain
    amplifies."""
    K = state.kf_pose.shape[0]
    P = state.pt_pos.shape[0]
    O = state.obj_pose.shape[0]
    kf_tgt = torch.where(idx.kf_idx >= 0, idx.kf_idx, K).long()
    pt_tgt = torch.where(idx.pt_idx >= 0, idx.pt_idx, P).long()
    obj_tgt = torch.where(idx.obj_idx >= 0, idx.obj_idx, O).long()
    return state._replace(
        kf_pose=_scatter(state.kf_pose, kf_tgt, lie.orthonormalize_se3(res.kf_pose)),
        pt_pos=_scatter(state.pt_pos, pt_tgt, res.pts),
        obj_pose=_scatter(state.obj_pose, obj_tgt, lie.orthonormalize_se3(res.obj_pose)),
    )


def _solve_ba_optimistic(state: ms.MapState, cam, center_kf: int,
                         max_kfs: int, global_window: bool,
                         solve_fn) -> ms.MapState:
    """Assemble + solve with memoized capacity buckets; the counts read
    comes after the solve is launched.  On a verified overflow the problem
    is assembled again with grown buckets and solved again from the pre-BA
    state (the cut result is discarded)."""
    key, buckets = _memo_buckets(state, center_kf, max_kfs, global_window)
    prob, idx, counts_dev = _ba_assemble_device(state, center_kf, max_kfs,
                                                global_window, *buckets)
    new_state = apply_ba_result(state, idx, solve_fn(prob))
    counts = counts_dev.cpu().numpy()
    if _counts_fit(counts, buckets):
        return new_state
    grown = _bucket_memo[key] = _grown(buckets, counts, _shapes(state))
    prob, idx, _ = _ba_assemble_device(state, center_kf, max_kfs, global_window, *grown)
    return apply_ba_result(state, idx, solve_fn(prob))


def local_ba_step(state: ms.MapState, cam, center_kf: int,
                  max_kfs: int = 10) -> ms.MapState:
    return _solve_ba_optimistic(state, cam, center_kf, max_kfs, False,
                                lambda prob: ba.local_ba(cam, prob))


def _ba_cull_device(state: ms.MapState, cam, center_kf: int, max_kfs: int,
                    Kl: int, Pl: int, Ol: int, N: int, M: int, max_cull: int):
    """Local BA (assemble + solve + apply) and keyframe culling with one
    result vector [counts(5) | culled(max_cull)] for the host."""
    prob, idx, counts = _ba_assemble_device(state, center_kf, max_kfs, False,
                                            Kl, Pl, Ol, N, M)
    state = apply_ba_result(state, idx, ba.local_ba(cam, prob))
    state, culled = _cull_keyframes_device(state, center_kf, 0.9, max_cull)
    return state, torch.cat([counts, culled])


def ba_cull_dispatch(state: ms.MapState, cam, center_kf: int,
                     max_kfs: int = 10, max_cull: int = 2):
    """Launch the combined BA+cull with memoized optimistic buckets.
    Returns a pending handle; the caller may launch further work on the
    optimistic `pending["state"]` before `ba_cull_read`."""
    key, buckets = _memo_buckets(state, center_kf, max_kfs, False)
    new_state, vec = _ba_cull_device(state, cam, center_kf, max_kfs, *buckets, max_cull)
    return {"state": new_state, "vec": vec, "buckets": buckets, "key": key,
            "pre_state": state, "cam": cam, "center": center_kf,
            "max_kfs": max_kfs, "max_cull": max_cull, "shapes": _shapes(state)}


def ba_cull_read(pending, vec=None):
    """Read and verify a `ba_cull_dispatch` result (`vec`: the result
    vector if the caller already read it).  Returns (fit, culled slots,
    redo state): fit=False means the buckets overflowed, and the caller
    must adopt `redo_state`, solved again from the pre-BA state with
    grown buckets."""
    if vec is None:
        vec = pending["vec"].cpu().numpy()   # the keyframe stage's one read
    counts, culled_v = vec[:5], vec[5:]
    buckets = pending["buckets"]
    if _counts_fit(counts, buckets):
        return True, [int(k) for k in culled_v if k >= 0], None
    grown = _bucket_memo[pending["key"]] = _grown(buckets, counts, pending["shapes"])
    redo_state, vec = _ba_cull_device(
        pending["pre_state"], pending["cam"], pending["center"],
        pending["max_kfs"], *grown, pending["max_cull"])
    return False, [int(k) for k in vec.cpu().numpy()[5:] if k >= 0], redo_state


def local_ba_and_cull_step(state: ms.MapState, cam, center_kf: int,
                           max_kfs: int = 10, max_cull: int = 2):
    """Combined BA+cull (dispatch + immediate read).  Returns (state,
    culled slots)."""
    pend = ba_cull_dispatch(state, cam, center_kf, max_kfs, max_cull)
    fit, culled, redo = ba_cull_read(pend)
    return (pend["state"] if fit else redo), culled


def global_ba_step(state: ms.MapState, cam, n_iters: int = 10,
                   dense_limit: int = 96) -> ms.MapState:
    """Global joint BA over the whole map: the dense Schur path up to
    `dense_limit` pose blocks, the matrix-free PCG path past it.  The call
    is the span `ba.global`, with its pose blocks, points and path."""
    with timers.span("ba.global") as sp:
        def solve(prob):
            blocks = prob.kf_pose.shape[0] + prob.obj_pose.shape[0]
            dense = blocks <= dense_limit
            sp.set(pose_blocks=blocks, points=prob.pts.shape[0], path="dense" if dense else "pcg")
            if dense:
                return ba.global_ba(cam, prob, n_iters=n_iters)
            return ba.global_ba_pcg(cam, prob, n_iters=n_iters)

        return _solve_ba_optimistic(state, cam, 0, 0, True, solve)
