"""Keyframe mapping stage: the reference's LocalMapping + LoopClosing
threads as a serially processed job pipeline.

Counterpart of `dsp_slam_rgbd_tpu/system/mapping_stage.py`.  The reference
runs mapping/objects/BA in the `LocalMapping` thread while `Tracking`
processes the next frames (`src/System.cc:120-143`,
`src/LocalMapping.cc:55-164`); the loop thread consumes its queue after
that (`src/LoopClosing.cc:60`).  Here a keyframe's stage — the point
stage, the batched object stage, local BA + keyframe culling, the BoW
update, the global-BA drain, loop detection and correction — is one
`process()` call on a `MappingStage` that owns the mapping lineage of the
map state.  Jobs are strictly serial: each starts from the previous job's
state.

Host reads per keyframe, as in the JAX package: with stereo detections,
the association result (`object_stage.associate_read`) and one bundled
[recon flags | BA+cull vector] read; without them, the BA+cull read alone.
With a vocabulary, the loop stage adds one read of the packed candidate
matrix (`_loop_candidates_device`) from its sixth keyframe on, and, when a
candidate is consistent, the reads of `loop_closing` (see there).

With a `recon_mesh` (`parallel/mesh.py`) the new-object reconstruction
shards over its ranks.  Every rank of the default group runs the same
stage on the same inputs, so each makes the same collectives in the same
order (from the thread and CUDA stream that run `process`).  The stage
holds the ranks to that (`parallel/distributed.agree`): at the start of
every job they must hold the same job and bit-identical map sums, and
before the reconstruction the same unmatched count; otherwise every rank
raises there, instead of one rank waiting in a collective that the
others never make.  That costs one small all_gather and one host read
per job, two when the job has detections.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from dsp_slam_rgbd_tpu_torch.config import SystemConfig
from dsp_slam_rgbd_tpu_torch.frontend.orb import upload
from dsp_slam_rgbd_tpu_torch.loop import keyframe_db, loop_closing, vocabulary
from dsp_slam_rgbd_tpu_torch.mapping import covisibility as covis
from dsp_slam_rgbd_tpu_torch.mapping import local_mapping as lm
from dsp_slam_rgbd_tpu_torch.mapping import objects as obj_mod
from dsp_slam_rgbd_tpu_torch.mapping.local_mapping import _set_row
from dsp_slam_rgbd_tpu_torch.ops import lie
from dsp_slam_rgbd_tpu_torch.parallel import distributed as dist
from dsp_slam_rgbd_tpu_torch.system import mono_objects
from dsp_slam_rgbd_tpu_torch.system import object_stage as ostage
from dsp_slam_rgbd_tpu_torch.system.detections import (MaskLabel, MonoDetection,
                                                       mono_detection_from_mask)


def _loop_candidates_device(state, db, kf_slot: int, recent_after_fid: int,
                            max_cands: int):
    """Loop-candidate retrieval + the candidates' covisible rows, read by
    the host at once: returns a (2 + max_cands, max_cands + K) f32 matrix
    packing [cand_idx pad | -], [- | scores], [- | rows...].

    Scale-safe: the query's connected set is one covisibility row and group
    scoring expands only the top-`max_cands` candidates' rows
    (`detect_loop_candidates_grouped`) — no (K, K) matrix, no (K, P)
    membership build (feasible at `MapConfig.kitti_large` capacities,
    2048 KF × 300k pts)."""
    K = state.kf_valid.shape[0]
    slots = torch.arange(K, device=state.kf_valid.device)
    row_q = covis.covisibility_row(state, kf_slot)
    connected = (row_q >= covis.MIN_WEIGHT) | (slots == kf_slot)
    recent = state.kf_frame_id >= recent_after_fid
    cand_idx, scores, rows_w = keyframe_db.detect_loop_candidates_grouped(
        db, db.bow[kf_slot], connected | recent, state, top_l=min(max_cands, K))
    L = cand_idx.shape[0]
    rows = (rows_w >= covis.MIN_WEIGHT) & (cand_idx >= 0)[:, None]
    head = torch.nn.functional.pad(cand_idx.float(), (0, max_cands + K - L))
    body = torch.nn.functional.pad(torch.cat([scores[None], rows.float()]),
                                   (max_cands, 0, 0, max_cands - L))
    return torch.cat([head[None], body])


def map_fingerprint(state) -> torch.Tensor:
    """f64 sums of the map's keyframes, points and objects (valid slots
    only), on the map's device: equal bits on two ranks whose maps are."""
    def total(x, valid):
        keep = valid.reshape(valid.shape + (1,) * (x.dim() - valid.dim()))
        return torch.where(keep, x, 0).double().sum()

    s = state
    return torch.stack([total(s.kf_pose, s.kf_valid), total(s.pt_pos, s.pt_valid),
                        total(s.obj_pose, s.obj_valid), total(s.obj_code, s.obj_valid),
                        s.kf_valid.sum().double(), s.pt_valid.sum().double(),
                        s.obj_valid.sum().double()])


def _sanitize_assoc(pt_idx, base_valid, base_first, view_first):
    """Drop frame→point associations whose point slot was culled or
    recycled by mapping jobs the tracker has not adopted yet: the frame was
    tracked against an older snapshot, so a slot index may now name a
    DIFFERENT landmark in the mapping lineage (the reference avoids this
    via MapPoint pointer identity + isBad; static-shape slots need the
    explicit tenant check)."""
    pi = torch.clamp_min(pt_idx, 0).long()
    same_tenant = base_valid[pi] & (base_first[pi] == view_first[pi])
    return torch.where((pt_idx >= 0) & same_tenant, pt_idx, -1)


@dataclass
class KFJob:
    """One keyframe's mapping work, captured at enqueue time."""
    frame: object                 # tracking.tracker.Frame (device tensors)
    detections: Optional[list]
    kf_slot: int                  # pre-allocated by the caller
    kid: int                      # monotonic keyframe id (n_kf at enqueue)
    frame_id: int
    timestamp: float
    # the tracker's view at enqueue (for association sanitization)
    view_pt_first: object = None


@dataclass
class KFResult:
    """Everything the caller applies at adoption time."""
    state: object                 # post-job mapping lineage head
    kf_slot: int
    kid: int
    timestamp: float
    frame_id: int = -1            # the tracker's id of the keyframe's frame
    # state the job STARTED from — the delta base for merging the
    # tracker's found/visible counters accrued while the job ran
    base_pt_visible: object = None
    base_pt_found: object = None
    base_pt_first: object = None
    # (culled_slot, fallback_slot, T_culled @ inv(T_fallback) (4, 4))
    culled: list = field(default_factory=list)
    pt_remap: object = None       # loop-fusion remap (P,) or None
    kf_valid_host: object = None  # mirror copy at job end
    map_changed: bool = False
    loop_closed: bool = False


class MappingStage:
    """Owns the mapping lineage + the keyframe-rate pipeline state.

    `decoder`: the port's `DeepSDFDecoder` (None: detections are ignored).
    `vocab`: a `loop.vocabulary.Vocabulary` (None: no BoW database and no
    loop closing).  `recon_mesh`: a `parallel/mesh.py` mesh over which the
    new-object reconstruction shards (every rank runs the same stage on
    the same inputs).  Runs on the device of `state`, `decoder` and
    `vocab`."""

    def __init__(self, cfg: SystemConfig, state, kf_valid_host, decoder=None,
                 vocab: vocabulary.Vocabulary = None, recon_mesh=None):
        self.cfg = cfg
        self._recon_mesh = recon_mesh
        self._jobs = 0   # jobs processed (the agreement checks' sequence number)
        self.state = state
        self.kf_valid_host = kf_valid_host  # shared with the caller
        self.decoder = decoder
        self.vocab = vocab
        self.db = keyframe_db.empty(cfg.map.max_kf, vocab.n_words,
                                    device=state.kf_valid.device) \
            if vocab is not None else None
        self.consistency = loop_closing.ConsistencyState()
        # loop-closure cooldown (reference `mLastLoopKFid + 10` gate,
        # LoopClosing.cc:DetectLoop): no new correction until 10 keyframes
        # after the last — a second closure on a half-corrected map (the
        # staged GBA budget still draining) compounds a bad Sim3
        self._last_loop_kid = -100
        # staged global-BA budget: iterations still owed after a loop
        # closure, drained a slice at a time on subsequent keyframes
        self._gba_iters_left = 0
        self.gba_slice_iters = 2
        self.loop_closures = 0
        self._oobs_cursor = {}  # per-object ring cursors
        # Sim(3) RANSAC samples (drawn on the CPU: the card and the CPU see
        # the same hypotheses; the JAX package's PRNGKey(43) stream differs)
        self._gen = torch.Generator().manual_seed(43)

    # ------------------------------------------------------------------
    def process(self, job: KFJob) -> KFResult:
        """Run the whole keyframe stage for one job (strictly serial)."""
        res = KFResult(
            state=self.state, kf_slot=job.kf_slot, kid=job.kid,
            timestamp=job.timestamp, frame_id=job.frame_id,
            base_pt_visible=self.state.pt_visible,
            base_pt_found=self.state.pt_found,
            base_pt_first=self.state.pt_first_kf,
        )
        frame = job.frame
        if job.view_pt_first is not None \
                and job.view_pt_first is not self.state.pt_first_kf:
            frame = frame._replace(pt_idx=_sanitize_assoc(
                frame.pt_idx, self.state.pt_valid, self.state.pt_first_kf,
                job.view_pt_first))
        detections = job.detections
        if self._recon_mesh is not None:
            dist.agree("keyframe job", [self._jobs, job.frame_id, job.kf_slot, job.kid,
                                        len(detections or ())], map_fingerprint(self.state))
        self._jobs += 1

        slot, kid = job.kf_slot, job.kid
        # early launch of the association (it reads only object fields and
        # the frame pose): its read in _object_stage comes after the point
        # stage is queued
        assoc_pending = None
        if detections and self.decoder is not None \
                and not isinstance(detections[0], (MaskLabel, MonoDetection)):
            assoc_pending = ostage.associate_dispatch(self.state, detections, frame.t_cw)
        stereo = self.cfg.sensor in ("stereo", "rgbd")
        self.state = lm.kf_point_stage(
            self.state, self.cfg.cam, slot, frame, job.frame_id,
            self.cfg.tracking.th_depth * self.cfg.cam.bf / self.cfg.cam.fx,
            kid, stereo,
            n_neighbors=10 if stereo else 20,
            min_obs_after=4 if stereo else 3)

        recon_pending = None
        if detections:
            recon_pending = self._object_stage(slot, frame, detections, assoc_pending, kid)

        # combined BA + keyframe cull with one tail read; new objects insert
        # on the optimistic post-BA state (their first pose edge joins the
        # next keyframe's BA window, like the reference's asynchronous
        # LocalMapping object stage)
        pend_ba = lm.ba_cull_dispatch(self.state, self.cfg.cam, slot,
                                      self.cfg.map.local_window)
        self.state = pend_ba["state"]
        ins_args = None
        if recon_pending is not None:
            # bundled tail read: [recon flags | BA+cull vector]
            flags_dev, Ucap = recon_pending[3], recon_pending[4]
            O = self.state.obj_valid.shape[0]
            vec_dev = pend_ba["vec"]
            both = torch.cat([flags_dev.to(vec_dev.dtype), vec_dev]).cpu().numpy()
            flags = both[:Ucap + O].astype(np.int64)
            ins_args = self._finish_new_objects(slot, recon_pending, kid, flags=flags)
            fit, culled, redo = lm.ba_cull_read(pend_ba, vec=both[Ucap + O:])
        else:
            fit, culled, redo = lm.ba_cull_read(pend_ba)
        if not fit:
            # rare bucket overflow: adopt the re-solved state and re-apply
            # the object insert on top of it
            self.state = redo
            if ins_args is not None:
                self.state = ostage.insert_new_objects(self.state, *ins_args)
        res.map_changed = True  # local BA moved poses under the tracker
        for c in culled:
            self.kf_valid_host[c] = False
            res.culled.append(self._on_keyframe_culled(c))
        self._update_bow(slot)
        self._drain_gba_budget()  # owed post-loop global-BA slice, if any
        remap = self._loop_stage(slot, kid, job.frame_id)
        if remap is not None:
            res.pt_remap = remap
            res.loop_closed = True
        res.state = self.state
        res.kf_valid_host = self.kf_valid_host.copy()
        return res

    # ------------------------------------------------------------------
    def _on_keyframe_culled(self, culled: int):
        """Purge a culled KF from the BoW database and compute the
        trajectory re-anchor transform (applied by the caller at adoption).
        The new anchor is the temporally nearest surviving keyframe."""
        if self.db is not None:
            self.db = self.db.remove(culled)
        kv = self.kf_valid_host
        fids = self.state.kf_frame_id.cpu().numpy()
        culled_fid = int(fids[culled])
        alive = np.nonzero(kv)[0]
        fallback = culled
        if len(alive):
            fallback = int(alive[np.argmin(np.abs(fids[alive] - culled_fid))])
        T_culled = self.state.kf_pose[culled]
        T_new_inv = lie.inv_se3(self.state.kf_pose[fallback])
        return (culled, fallback, T_culled @ T_new_inv)

    # ------------------------------------------------------------------
    def _object_stage(self, kf_slot: int, frame, detections, assoc_pending, kid: int):
        """Associate detections, fit/update objects, record observations
        (`LocalMapping_util.cc` object stage).  Returns a pending
        unmatched-reconstruction handle for `_finish_new_objects` (stereo
        path), or None."""
        if self.decoder is None:
            return None
        if isinstance(detections[0], MaskLabel):
            # raw disk masks → MonoDetections with the CURRENT frame's
            # keypoints (`Tracking_util.cc:163-208`)
            cam = self.cfg.cam
            invK = np.linalg.inv(np.asarray(
                [[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]],
                np.float32))
            xy = frame.feats.xy.cpu().numpy().copy()
            xy[~frame.feats.valid.cpu().numpy()] = -1e6  # never inside a mask
            detections = [mono_detection_from_mask(d.mask, invK, feats_xy=xy)
                          for d in detections]

        if isinstance(detections[0], MonoDetection):
            # mono path: mask-only detections, pose recovered from owned
            # map points (Tracking_util.cc:210-288 + LocalMapping_util.cc
            # :213-445)
            self.state, assoc = mono_objects.associate_by_projection(
                self.state, kf_slot, detections)
            self.state, assoc = mono_objects.create_new_objects(
                self.state, kf_slot, detections, assoc, kfseq=kid)
            self.state, obs = mono_objects.process_detected_objects(
                self.state, self.cfg.cam, self.cfg.recon, self.decoder, kf_slot,
                kid, detections, assoc)
            for o, t_co in obs:
                self._add_object_obs(o, kf_slot, t_co)
            return None
        # ---- batched stereo object stage (system/object_stage.py)
        if assoc_pending is not None:
            assoc, unmatched_idx = ostage.associate_read(
                assoc_pending, self.state.obj_valid.shape[0])
        else:
            assoc, unmatched_idx = ostage.associate_batch(self.state, detections, kf_slot)
        dev = self.state.obj_pose.device
        a_rows = np.nonzero(assoc >= 0)[0]
        if len(a_rows):
            Acap = ostage.bucket(len(a_rows))
            obj_idx = np.full(Acap, -1, np.int64)
            obj_idx[: len(a_rows)] = a_rows
            a_valid = np.zeros(Acap, bool)
            a_valid[: len(a_rows)] = True
            S = detections[0].pts.shape[0]
            det_t = np.tile(np.eye(4, dtype=np.float32), (Acap, 1, 1))
            det_pts = np.zeros((Acap, S, 3), np.float32)
            det_mask = np.zeros((Acap, S), bool)
            for j, o in enumerate(a_rows):
                d = detections[int(assoc[o])]
                det_t[j], det_pts[j], det_mask[j] = d.t_co, d.pts, d.pts_mask
            qs = self._oobs_slots(obj_idx, a_valid)
            self.state = ostage.refine_associated(
                self.decoder, self.cfg.recon, self.state, upload(obj_idx, dev),
                upload(a_valid, dev), upload(det_t, dev), upload(det_pts, dev),
                upload(det_mask, dev), kf_slot, upload(qs, dev))

        pending = None
        mesh = self._recon_mesh
        if mesh is not None:
            dist.agree("unmatched detections", [self._jobs, len(unmatched_idx), len(a_rows)])
        if unmatched_idx:
            pending = ostage.recon_unmatched(
                self.decoder, self.cfg.recon, self.state, detections, unmatched_idx,
                mesh=mesh, min_cap=mesh.shape["obj"] if mesh is not None else 1)

        keep = obj_mod.cull_objects(self.state.obj_valid, self.state.obj_n_obs,
                                    self.state.obj_last_kf, kf_slot)
        # drop the pose edges of culled objects so their ring-buffer region
        # is clean for the next tenant and BA never sees stale constraints
        oobj = self.state.oobs_obj
        oobs_live = self.state.oobs_valid & keep[torch.clamp_min(oobj, 0).long()] & (oobj >= 0)
        self.state = self.state._replace(obj_valid=keep, oobs_valid=oobs_live)
        return pending

    def _finish_new_objects(self, kf_slot: int, pending, kid: int, flags=None):
        """Unpack the unmatched-reconstruction flags and scatter every
        accepted object into the map at once.  `flags`: the flags vector
        if already read (bundled tail read)."""
        res, bb_min, bb_max, good, obj_valid_np, _U = \
            ostage.recon_unmatched_read(pending, flags=flags)
        Ucap = len(good)
        slots = np.full(Ucap, -1, np.int64)
        free = np.nonzero(~obj_valid_np)[0]
        gi = np.nonzero(good)[0]
        take = min(len(gi), len(free))
        slots[gi[:take]] = free[:take]
        ok = good & (slots >= 0)
        if not ok.any():
            return None
        qs = self._oobs_slots(slots, ok)
        dev = self.state.obj_pose.device
        ins_args = (upload(slots, dev), upload(ok, dev), res.t_cam_obj, res.code, bb_min,
                    bb_max, kf_slot, kid, upload(qs, dev))
        self.state = ostage.insert_new_objects(self.state, *ins_args)
        return ins_args

    # ------------------------------------------------------------------
    def _oobs_slots(self, obj_slots, valid) -> np.ndarray:
        """Pre-allocate observation-ring slots for a batch of objects (same
        per-object partitioned ring as `_add_object_obs`; cursors advance
        only for valid rows).  Returns (len(obj_slots),) int64, −1 pad."""
        Q = self.state.oobs_kf.shape[0]
        O = self.state.obj_pose.shape[0]
        S = max(Q // O, 1)
        qs = np.full(len(obj_slots), -1, np.int64)
        for i, o in enumerate(np.asarray(obj_slots)):
            o = int(o)
            if o < 0 or not valid[i]:
                continue
            c = self._oobs_cursor.get(o, 0)
            qs[i] = (o * S + c % S) % Q
            self._oobs_cursor[o] = c + 1
        return qs

    @property
    def oobs_overwrites(self) -> int:
        """Pose edges overwritten by their object's ring wrapping (each one
        is a camera-object constraint the global joint BA no longer sees;
        size max_oobs up if this grows on a run)."""
        Q = self.state.oobs_kf.shape[0]
        S = max(Q // self.state.obj_pose.shape[0], 1)
        return sum(max(0, c - S) for c in self._oobs_cursor.values())

    def _add_object_obs(self, obj_slot: int, kf_slot: int, t_co):
        """Record a camera-object pose edge.  The buffer is partitioned into
        per-object rings (Q // O slots each) so one busy object can never
        evict another object's edges."""
        Q = self.state.oobs_kf.shape[0]
        O = self.state.obj_pose.shape[0]
        S = max(Q // O, 1)
        c = self._oobs_cursor.get(obj_slot, 0)
        q = (obj_slot * S + c % S) % Q
        self._oobs_cursor[obj_slot] = c + 1
        st = self.state
        t_co = torch.as_tensor(np.asarray(t_co, np.float32), device=st.oobs_t_co.device)
        self.state = st._replace(
            oobs_kf=_set_row(st.oobs_kf, q, kf_slot),
            oobs_obj=_set_row(st.oobs_obj, q, obj_slot),
            oobs_t_co=_set_row(st.oobs_t_co, q, t_co),
            oobs_valid=_set_row(st.oobs_valid, q, True),
        )

    # ------------------------------------------------------------------
    def _update_bow(self, kf_slot: int):
        if self.vocab is None:
            return
        w = vocabulary.quantize(self.vocab, self.state.kf_desc[kf_slot],
                                self.state.kf_feat_valid[kf_slot])
        self.db = self.db.add(kf_slot, vocabulary.bow_vector(w, self.vocab.n_words))

    def _loop_stage(self, kf_slot: int, kid: int, frame_id: int):
        """Loop detection + correction per keyframe (LoopClosing::Run).
        Returns the point-fusion remap (P,) when a loop closed, else None.
        `kid` is this keyframe's monotonic id; `kid + 1` keyframes exist
        after it."""
        if self.db is None or kid + 1 < 6:
            return None
        # cooldown after a closure (LoopClosing.cc mLastLoopKFid + 10): no
        # correction until 10 keyframes pass, but detection + consistency
        # accounting keep running, so the 3-consecutive-KF consistency
        # chain is already built the moment the cooldown expires
        in_cooldown = kid < self._last_loop_kid + 10
        # candidate retrieval + top-candidate covisible rows + scores: one read
        MAX_CANDS = 8
        out = _loop_candidates_device(
            self.state, self.db, kf_slot,
            frame_id - 2 * self.cfg.tracking.max_frames_between_kf, MAX_CANDS).cpu().numpy()
        K = self.state.kf_valid.shape[0]
        cand_idx = out[0, :MAX_CANDS].astype(np.int64)
        scores = out[1, MAX_CANDS:MAX_CANDS + K]
        rows = out[2:2 + MAX_CANDS, MAX_CANDS:MAX_CANDS + K] > 0.5
        # −1 holes can sit mid-array (the 0.75·best-acc gate rejects by
        # position): keep candidate↔row alignment by position
        pos = np.nonzero(cand_idx >= 0)[0]
        cidx = cand_idx[pos]
        if len(cidx) == 0:
            self.consistency.update([])
            return None
        groups = [set(np.nonzero(rows[p])[0].tolist()) | {int(cand_idx[p])} for p in pos]
        consistent = self.consistency.update(groups, candidates=[int(c) for c in cidx])
        if not consistent or in_cooldown:
            return None
        # try every enough-consistent candidate in descending BoW score
        # (the reference iterates all of mvpEnoughConsistentCandidates,
        # `LoopClosing::ComputeSim3`, LoopClosing.cc:241-270)
        cands_sorted = sorted(set(consistent), key=lambda k: -float(scores[k]))
        fix_scale = self.cfg.sensor != "mono"
        res, best = None, -1
        for c in cands_sorted[:5]:
            r = loop_closing.compute_loop_sim3(self.state, self.cfg.cam, kf_slot, c,
                                               self._gen, fix_scale=fix_scale)
            if r.ok:
                res, best = r, c
                break
        if res is None:
            return None
        self.state = loop_closing.correct_loop(self.state, self.cfg.cam, kf_slot, best,
                                               res.t_21, fix_scale=fix_scale)
        # fuse duplicated landmarks between the two sides of the loop (two
        # covisibility rows — never the (K, K) matrix)
        slots = torch.arange(K, device=self.state.kf_valid.device)
        rows_qc = covis.covisibility_rows(self.state, torch.stack([slots[kf_slot], slots[best]]))
        group_q = (rows_qc[0] >= covis.MIN_WEIGHT) | (slots == kf_slot)
        group_c = (rows_qc[1] >= covis.MIN_WEIGHT) | (slots == best)
        self.state, pt_remap = loop_closing.fuse_duplicate_points(
            self.state, group_q & self.state.kf_valid, group_c & self.state.kf_valid)
        self.state = loop_closing.fuse_duplicate_objects(self.state)
        # global joint BA after the essential graph, staged: the reference
        # runs GlobalJointBundleAdjustment in an abortable thread
        # (`LoopClosing_util.cc:213,307-308`); here the 10-iteration budget
        # is drained `gba_slice_iters` at a time — one slice now, the rest
        # on subsequent keyframes (`_drain_gba_budget`), each re-linearized
        # from the current state
        self._gba_iters_left = 10
        self._drain_gba_budget()
        self.loop_closures += 1
        self._last_loop_kid = kid
        return pt_remap

    def _drain_gba_budget(self):
        """Run one bounded slice of the owed post-loop global BA."""
        if self._gba_iters_left <= 0:
            return
        it = min(self.gba_slice_iters, self._gba_iters_left)
        self.state = lm.global_ba_step(self.state, self.cfg.cam, n_iters=it)
        self._gba_iters_left -= it
