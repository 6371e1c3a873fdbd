"""Loop closing: detection consistency, Sim(3) computation, correction.

Counterpart of `dsp_slam_rgbd_tpu/loop/loop_closing.py` (reference
`LoopClosing`, `src/LoopClosing.cc` + `_util.cc`):

  * `ConsistencyState` — the consecutive-detection consistency groups of
    `DetectLoop` (:113), host-side;
  * `compute_loop_sim3` — `ComputeSim3` (:241): descriptor matches between
    query and candidate KF features, 3D-3D correspondences from their map
    points, Sim3Solver RANSAC, guided re-match, GN refinement and the
    loop-group projection gate;
  * `correct_loop` — `CorrectLoopWithObjects` (`LoopClosing_util.cc:28`):
    propagate the corrective Sim(3) to the query's covisible group, remap
    their map points and objects, then essential-graph optimization;
  * `fuse_duplicate_points` / `fuse_duplicate_objects` — `SearchAndFuse`.

Map-state updates are functional; the host drives the sequencing.  Host
reads: `compute_loop_sim3` reads its RANSAC verdict, and after the
refinement one [accept | group count] pair; `correct_loop` one packed
[kf_valid | kf_frame_id | covisibility] vector for the essential graph;
`fuse_duplicate_points` one pair of side counts to size its tiles.
"""
from __future__ import annotations

import numpy as np
import torch

from dsp_slam_rgbd_tpu_torch.frontend import matcher
from dsp_slam_rgbd_tpu_torch.frontend.orb import upload
from dsp_slam_rgbd_tpu_torch.mapping import covisibility as covis
from dsp_slam_rgbd_tpu_torch.mapping import map_state as ms
from dsp_slam_rgbd_tpu_torch.mapping import pose_graph
from dsp_slam_rgbd_tpu_torch.ops import camera as cam_ops
from dsp_slam_rgbd_tpu_torch.ops import lie
from dsp_slam_rgbd_tpu_torch.solvers import sim3 as sim3_mod


class ConsistencyState:
    """Host-side consecutive-detection bookkeeping (reference
    `mvConsistentGroups`)."""

    def __init__(self, min_consistency: int = 3):
        self.groups: list[tuple[set, int]] = []  # (kf set, count)
        self.min_consistency = min_consistency

    def update(self, candidate_groups: list[set],
               candidates: list[int] | None = None) -> list[int]:
        """Feed this keyframe's candidate groups (each a set of KF slots);
        returns candidate KFs that reached the consistency threshold.

        candidates[i] names the retrieval candidate that produced group i —
        only that keyframe is promoted (the reference's
        `mvpEnoughConsistentCandidates.push_back(pCandidateKF)`,
        `LoopClosing.cc:170-220`): promoting the whole covisible group lets
        a recent keyframe riding in a candidate's group reach the Sim3 stage
        and fire a spurious self-closure."""
        new_groups = []
        consistent = []
        for i, grp in enumerate(candidate_groups):
            count = 0
            for prev, prev_count in self.groups:
                if grp & prev:
                    count = max(count, prev_count + 1)
            new_groups.append((grp, count))
            if count >= self.min_consistency:
                if candidates is not None:
                    consistent.append(int(candidates[i]))
                else:
                    consistent.extend(sorted(grp))
        self.groups = new_groups
        return consistent


def _clamp(idx: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(idx, 0).long()


def _pairs_from_match(state: ms.MapState, kf_q: int, kf_c: int, idx, valid):
    """Lift a per-query-feature match (idx into kf_c features) to 3D-3D
    pairs in the two camera frames."""
    pt_q = state.kf_feat_pt[kf_q]
    pt_c = state.kf_feat_pt[kf_c][_clamp(idx)]
    ok = valid & (pt_q >= 0) & (pt_c >= 0)
    ok = ok & state.pt_valid[_clamp(pt_q)] & state.pt_valid[_clamp(pt_c)]
    p_q = lie.transform_points(state.kf_pose[kf_q], state.pt_pos[_clamp(pt_q)])
    p_c = lie.transform_points(state.kf_pose[kf_c], state.pt_pos[_clamp(pt_c)])
    return p_q, p_c, state.kf_xy[kf_q], state.kf_xy[kf_c][_clamp(idx)], ok


def guided_rematch(state: ms.MapState, cam, kf_q: int, kf_c: int,
                   t_qc: torch.Tensor, radius: float = 7.5):
    """Sim3-guided projection re-match (`ORBmatcher::SearchBySim3`,
    `ORBmatcher.cc:1102`): project the candidate KF's map points into the
    query image with t_qc and admit descriptor matches within a
    scale-dependent pixel radius; mutual best-match replaces the
    reference's two-directional agreement check."""
    pt_c = state.kf_feat_pt[kf_c]
    have_c = state.kf_feat_valid[kf_c] & (pt_c >= 0) & state.pt_valid[_clamp(pt_c)]
    p_c = lie.transform_points(state.kf_pose[kf_c], state.pt_pos[_clamp(pt_c)])
    p_q = lie.transform_points(t_qc, p_c)
    uv_pred = cam_ops.project(cam, p_q)
    r = radius * 1.2 ** state.kf_level[kf_c].float()
    # (F_q, F_c) admissible window around each candidate point's projection
    d2 = torch.sum((state.kf_xy[kf_q][:, None, :] - uv_pred[None, :, :]) ** 2, -1)
    win = d2 <= (r[None, :] ** 2)
    vq = state.kf_feat_valid[kf_q] & (state.kf_feat_pt[kf_q] >= 0)
    return matcher.match(state.kf_desc[kf_q], vq, state.kf_desc[kf_c],
                         have_c & (p_q[:, 2] > 0), mask=win, max_dist=matcher.TH_HIGH,
                         mutual=True)


def _group_projection_count(state: ms.MapState, cam, kf_q: int, kf_c: int,
                            t_21, radius: float = 10.0):
    """The reference's final loop-acceptance gate (`LoopClosing.cc:331-356`):
    project every map point observed by the candidate's covisible group into
    the query keyframe through the refined Sim3 and count descriptor matches
    within a 10 px window (`SearchByProjection(mvpLoopMapPoints)`).  A
    wrong-but-self-consistent Sim3 (perceptual aliasing) passes the
    20-inlier refinement gate yet fails this one."""
    K = state.kf_valid.shape[0]
    group = covis.covisibility_row(state, kf_c) >= covis.MIN_WEIGHT
    group = (group | (torch.arange(K, device=group.device) == kf_c)) & state.kf_valid
    pmask = ms.point_mask_of(state, group)
    # candidate-cam → query-cam through the loop Sim3
    p_q = lie.transform_points(t_21 @ state.kf_pose[kf_c], state.pt_pos)
    uv = cam_ops.project(cam, p_q)
    cand = pmask & (p_q[:, 2] > 0.1)
    d2 = torch.sum((state.kf_xy[kf_q][:, None, :] - uv[None, :, :]) ** 2, -1)
    m = matcher.match(state.kf_desc[kf_q], state.kf_feat_valid[kf_q], state.pt_desc, cand,
                      mask=d2 <= radius ** 2, max_dist=matcher.TH_HIGH, mutual=True)
    return torch.sum(m.valid).to(torch.int32)


def compute_loop_sim3(state: ms.MapState, cam, kf_q: int, kf_c: int,
                      generator: torch.Generator, fix_scale: bool = True,
                      min_accept: int = 20, min_group_matches: int = 40):
    """Full loop Sim(3) pipeline (`LoopClosing::ComputeSim3`,
    `LoopClosing.cc:241-356`): descriptor matches → Sim3Solver RANSAC
    (samples from the CPU `generator`) → guided `SearchBySim3` re-match →
    `OptimizeSim3` GN refinement → the loop-group projection gate; the
    loop is accepted only if the refined solution keeps ≥ `min_accept`
    inliers AND ≥ `min_group_matches` of the candidate group's map points
    re-project onto query descriptors.

    Returns sim3.Sim3Result with t_21 mapping candidate-camera coords into
    query-camera coords (the reference's Scm); its `ok` is a host bool."""
    vq = state.kf_feat_valid[kf_q] & (state.kf_feat_pt[kf_q] >= 0)
    vc = state.kf_feat_valid[kf_c] & (state.kf_feat_pt[kf_c] >= 0)
    m = matcher.match(state.kf_desc[kf_q], vq, state.kf_desc[kf_c], vc,
                      max_dist=matcher.TH_LOW, mutual=True)
    p_q, p_c, uv_q, uv_c, ok = _pairs_from_match(state, kf_q, kf_c, m.idx, m.valid)
    ones = torch.ones(p_c.shape[0], device=p_c.device)
    res = sim3_mod.solve_sim3_ransac(cam, cam, p_c, p_q, uv_c, uv_q, ones, ones, ok,
                                     generator, fix_scale=fix_scale)
    if not bool(res.ok):  # host read
        return res._replace(ok=False)

    # guided re-match with the RANSAC estimate in both directions (the
    # reference's SearchBySim3 projects KF1 points into KF2 and KF2 points
    # into KF1, ORBmatcher.cc:1102-1256), then union with the descriptor
    # matches (original pairs win, then forward, then reverse)
    m2 = guided_rematch(state, cam, kf_q, kf_c, res.t_21)
    m3 = guided_rematch(state, cam, kf_c, kf_q, lie.inv_sim3(res.t_21))
    # m3 is per-candidate-feature → query idx; invert to per-query → cand
    Fq = state.kf_xy.shape[1]
    tgt = torch.where(m3.valid, m3.idx, Fq).long()
    rev_idx = torch.full((Fq + 1,), -1, dtype=torch.int64, device=tgt.device)
    rev_idx = rev_idx.scatter(0, tgt, torch.arange(m3.idx.shape[0], device=tgt.device))[:Fq]
    idx_u = torch.where(m.valid, m.idx, torch.where(m2.valid, m2.idx, rev_idx))
    val_u = m.valid | m2.valid | (rev_idx >= 0)
    p_q, p_c, uv_q, uv_c, ok_u = _pairs_from_match(state, kf_q, kf_c, idx_u, val_u)

    t_ref, inl, n_in = sim3_mod.refine_sim3_gn(cam, cam, res.t_21, p_c, p_q, uv_c, uv_q,
                                               ok_u, fix_scale=fix_scale)
    ok_fin = (n_in >= min_accept) & torch.all(torch.isfinite(t_ref))
    # the group gate is computed alongside and read with the verdict: one read
    n_group = _group_projection_count(state, cam, kf_q, kf_c, t_ref)
    ok_h, n_group = torch.stack([ok_fin.to(torch.int32), n_group]).cpu().tolist()
    return sim3_mod.Sim3Result(t_ref, inl, n_in, bool(ok_h) and n_group >= min_group_matches)


def correct_loop(state: ms.MapState, cam, kf_q: int, kf_c: int,
                 t_qc_corrected: torch.Tensor, fix_scale: bool = True,
                 pg_iters: int = 20) -> ms.MapState:
    """Propagate the loop correction and optimize the essential graph.

    t_qc_corrected: Sim(3) mapping candidate-camera coords to query-camera
    coords (output of compute_loop_sim3).  The corrected query pose is
    S_qw_corr = t_qc_corrected · T_cand_cw; the correction is applied to
    the query's covisible group and their points/objects (reference
    `LoopClosing_util.cc:92-152`), then the pose graph is optimized with
    the loop edge added.
    """
    K = state.kf_pose.shape[0]
    dev = state.kf_pose.device
    slots = torch.arange(K, device=dev)
    group = (covis.covisibility_row(state, kf_q) >= covis.MIN_WEIGHT) & state.kf_valid
    # the loop candidate anchors the correction and is never part of the
    # warped group
    group = (group | (slots == kf_q)) & (slots != kf_c)

    # edge measurements come from the pre-correction poses (the reference's
    # NonCorrectedSim3), or every residual is zero post-warp and the graph
    # optimization never distributes drift
    poses_uncorrected = state.kf_pose

    S_old = state.kf_pose[kf_q]
    S_corr = t_qc_corrected @ state.kf_pose[kf_c]
    # the group moves into the corrected frame: T_k ↦ T_k · Δw with
    # Δw = S_old⁻¹·S_corr, i.e. world points warp by delta_world = Δw⁻¹
    delta_w = lie.inv_sim3(S_old) @ S_corr
    delta_world = lie.inv_sim3(delta_w)

    new_kf_pose = torch.where(group[:, None, None],
                              state.kf_pose @ lie.inv_sim3(delta_world), state.kf_pose)

    # warp map points owned by the group (points seen by group KFs)
    owned = ms.point_mask_of(state, group)
    new_pts = torch.where(owned[:, None], lie.transform_points(delta_world, state.pt_pos),
                          state.pt_pos)

    # warp objects observed by the group (the reference remaps MapObjects too)
    O = state.obj_pose.shape[0]
    oobs_in_group = state.oobs_valid & group[_clamp(state.oobs_kf)]
    obj_in = ms.mark(O + 1, torch.where(oobs_in_group, state.oobs_obj.long(), O))[:O]
    # Sim(3) ∘ SE(3): full product, then factor the scale out of the
    # rotation block into obj_scale (objects keep SE(3) pose + scalar scale)
    s = lie.sim3_scale(delta_world)
    prod = delta_world @ state.obj_pose
    new_obj_pose = torch.cat([torch.cat([prod[:, :3, :3] * (1.0 / s), prod[:, :3, 3:]], -1),
                              prod[:, 3:]], -2)
    new_obj = torch.where(obj_in[:, None, None], new_obj_pose, state.obj_pose)
    new_obj_scale = torch.where(obj_in, state.obj_scale * s, state.obj_scale)

    state = state._replace(kf_pose=new_kf_pose, pt_pos=new_pts, obj_pose=new_obj,
                           obj_scale=new_obj_scale)

    # --- essential graph: spanning chain + covisibility + loop edge ---
    # one host read: [kf_valid | kf_frame_id | covisibility matrix]
    Wn = covis.covisibility_matrix(state)
    host = torch.cat([state.kf_valid.long(), state.kf_frame_id.long(),
                      Wn.reshape(-1).long()]).cpu().numpy()
    kf_valid, fids, Wn = host[:K].astype(bool), host[K:2 * K], host[2 * K:].reshape(K, K)
    kf_idx = np.nonzero(kf_valid)[0]
    # spanning chain in temporal order (kf_frame_id): slots are recycled
    # after culling, so consecutive slots can hold temporally distant KFs
    kf_idx = kf_idx[np.argsort(fids[kf_idx], kind="stable")]
    chain = np.stack([kf_idx[:-1], kf_idx[1:]], 1) if len(kf_idx) > 1 \
        else np.zeros((0, 2), np.int64)
    # strong covisibility edges (weight ≥ 100, reference
    # OptimizeEssentialGraph's covisibility edges)
    sa, sb = np.nonzero(np.triu(Wn >= 100, 1))
    ei = upload(np.concatenate([chain[:, 0], sa, [kf_c]]).astype(np.int64), dev)
    ej = upload(np.concatenate([chain[:, 1], sb, [kf_q]]).astype(np.int64), dev)

    # measurements from the uncorrected relative estimates; the loop edge
    # (last) carries the Sim3-solve measurement instead
    meas = pose_graph.relative_sim3(poses_uncorrected[ej], poses_uncorrected[ei])
    meas = torch.cat([meas[:-1], t_qc_corrected[None].to(meas.dtype)])
    fixed = slots == kf_c
    res = pose_graph.optimize_pose_graph(
        state.kf_pose, state.kf_valid, fixed, ei, ej, meas,
        torch.ones(ei.shape[0], dtype=torch.bool, device=dev),
        fix_scale=fix_scale, n_iters=pg_iters)

    # re-anchor points to their reference KF motion (spanning-tree
    # propagation role, `Optimizer.cc:780` recover step): p ↦ T_new⁻¹·T_old·p
    ref = _clamp(state.pt_ref_kf)
    T_old = state.kf_pose[ref]
    T_new_inv = lie.inv_sim3(res.poses[ref])
    p_cam = torch.einsum("pij,pj->pi", T_old[:, :3, :3], state.pt_pos) + T_old[:, :3, 3]
    moved = torch.einsum("pij,pj->pi", T_new_inv[:, :3, :3], p_cam) + T_new_inv[:, :3, 3]
    keep_ref = (state.pt_valid & (state.pt_ref_kf >= 0))[:, None]
    new_pts2 = torch.where(keep_ref, moved, state.pt_pos)

    # recover SE(3) keyframe poses from the Sim(3) result: [sR, t] ->
    # [R, t/s] (the reference's essential-graph recover step)
    inv_s = 1.0 / lie.sim3_scale(res.poses)
    poses_se3 = torch.cat([res.poses[:, :3] * inv_s[:, None, None], res.poses[:, 3:]], 1)
    return state._replace(kf_pose=poses_se3, pt_pos=new_pts2)


def _bucket_tiles(n: int, tile: int) -> int:
    """Power-of-two tile count covering n points."""
    t = 1
    while t * tile < n:
        t *= 2
    return t


def _compact(mask: torch.Tensor, size: int) -> torch.Tensor:
    """The indices of mask's true entries in ascending order, padded to
    `size` with len(mask) (`jnp.nonzero(size=, fill_value=)`)."""
    P = mask.shape[0]
    idx, live = ms.first_members(mask, size)
    out = torch.where(live, idx, P)
    return torch.nn.functional.pad(out, (0, size - out.shape[0]), value=P)


def fuse_duplicate_points(state: ms.MapState, group_q: torch.Tensor,
                          group_c: torch.Tensor, radius: float = 0.15,
                          max_hamming: int = 50, tile: int = 2048):
    """Merge duplicate map points after a loop correction (`SearchAndFuse`
    role, `LoopClosing_util.cc:175`): points created on the revisit (seen by
    the query group) that coincide with older points from the loop side
    (within `radius`, descriptors within `max_hamming`) are replaced —
    observations repoint to the older landmark.

    group_q / group_c: (K,) bool masks of the two keyframe groups.

    Returns (state, remap) with remap (P,) mapping every old slot to its
    surviving slot (identity where nothing fused); the caller pushes it
    through any frame-level point references it holds (the reference's
    `MapPoint::Replace` pointer redirection).

    Both sides compact into (n_tiles, tile) index grids and every q-tile
    scans every c-tile (a dense P × P matrix would be O(GB) at capacity);
    the two side counts are read on the host (one read) to size the grids,
    power-of-two bucketed.
    """
    pts_c = ms.point_mask_of(state, group_c) & state.pt_valid
    pts_q = ms.point_mask_of(state, group_q) & state.pt_valid & ~pts_c
    P = state.pt_pos.shape[0]
    dev = state.pt_pos.device
    identity = torch.arange(P, device=dev)
    n_q, n_c = torch.stack([pts_q.sum(), pts_c.sum()]).cpu().tolist()
    if n_q == 0 or n_c == 0:
        return state, identity
    tq, tc = _bucket_tiles(n_q, tile), _bucket_tiles(n_c, tile)
    iq = _compact(pts_q, tq * tile)
    ic = _compact(pts_c, tc * tile)
    best_d2, best_tg = _fuse_match_tiles(state.pt_pos, state.pt_desc, iq.reshape(tq, tile),
                                         ic.reshape(tc, tile), radius, max_hamming)

    dies_flat = (best_d2 < torch.inf) & (iq < P)
    dies = torch.zeros(P + 1, dtype=torch.bool, device=dev).scatter(0, iq, dies_flat)[:P]
    remap = torch.arange(P + 1, device=dev).scatter(
        0, iq, torch.where(dies_flat, best_tg, torch.clamp_max(iq, P - 1)))[:P]
    assoc = state.kf_feat_pt
    new_assoc = torch.where(assoc >= 0, remap[_clamp(assoc)].to(torch.int32), assoc)
    return state._replace(pt_valid=state.pt_valid & ~dies, kf_feat_pt=new_assoc), remap


def _fuse_match_tiles(pt_pos, pt_desc, iq, ic, radius: float, max_hamming: int):
    """Best loop-side fusion target for every revisit-side point.

    iq (TQ, TILE) / ic (TC, TILE): global point indices (P = dead pad).
    Scans all TQ·TC tile pairs with a (TILE, TILE) working set; returns
    (best_d2 (TQ·TILE,), best_target (TQ·TILE,)) with inf/undefined where
    no candidate matched."""
    P = pt_pos.shape[0]
    TILE = iq.shape[1]
    rows = torch.arange(TILE, device=pt_pos.device)
    out_d, out_t = [], []
    for qi in iq:
        qi_s = torch.clamp_max(qi, P - 1)
        pq, dq, lq = pt_pos[qi_s], pt_desc[qi_s], qi < P
        best_d2 = torch.full((TILE,), torch.inf, device=pt_pos.device)
        best_tg = torch.full((TILE,), P - 1, dtype=torch.int64, device=pt_pos.device)
        for ci in ic:
            ci_s = torch.clamp_max(ci, P - 1)
            d2 = torch.sum((pq[:, None, :] - pt_pos[ci_s][None, :, :]) ** 2, dim=-1)
            ham = matcher.hamming_matrix(dq, pt_desc[ci_s])
            pair = (lq[:, None] & (ci < P)[None, :] & (d2 <= radius * radius)
                    & (ham <= max_hamming))
            d2m = torch.where(pair, d2, torch.inf)
            j = torch.argmin(d2m, dim=1)
            v = d2m[rows, j]
            upd = v < best_d2
            best_d2 = torch.where(upd, v, best_d2)
            best_tg = torch.where(upd, ci_s[j], best_tg)
        out_d.append(best_d2)
        out_t.append(best_tg)
    return torch.cat(out_d), torch.cat(out_t)


def fuse_duplicate_objects(state: ms.MapState, dist_th: float = 1.5) -> ms.MapState:
    """Merge objects whose centers coincide after correction
    (`SearchAndFuseObjects` `LoopClosing_util.cc:221-293`): the younger
    object is invalidated, its observations repoint to the older slot."""
    c = state.obj_pose[:, :3, 3]
    O = c.shape[0]
    d = torch.linalg.vector_norm(c[:, None, :] - c[None, :, :], dim=-1)
    both = state.obj_valid[:, None] & state.obj_valid[None, :]
    ii = torch.arange(O, device=c.device)
    dup = both & (d < dist_th) & (ii[None, :] < ii[:, None])  # j < i: i dies
    target = torch.argmax(dup.to(torch.int32), dim=1)  # first older duplicate
    dies = torch.any(dup, dim=1)
    remap = torch.where(dies, target, ii)

    def repoint(a):
        return torch.where(a >= 0, remap[_clamp(a)].to(torch.int32), a)

    return state._replace(obj_valid=state.obj_valid & ~dies, oobs_obj=repoint(state.oobs_obj),
                          pt_object=repoint(state.pt_object))
