"""The system loop: tracking, the asynchronous keyframe stage, exports.

Counterpart of `dsp_slam_rgbd_tpu/system/slam.py` (reference `System`,
`src/System.cc`): `SLAMSystem` wires the tracker, the map, the keyframe
`MappingStage` (local mapping, objects, loop closing) and the DeepSDF
decoder, and exposes `track_stereo`/`track_rgbd`/`track_mono`/
`track_frame` and the `save_*` exporters.

The reference's threads become two host threads with a functional state
hand-over: the main thread tracks every frame and, when a frame becomes a
keyframe, allocates its slot and enqueues a `KFJob`; one mapping worker
thread runs the jobs in order through `MappingStage.process`.  A job's
result is adopted exactly `async_kf_frames` frames after its enqueue
(blocking if the worker has not finished), so a run does not depend on
how fast the worker is; `async_kf_frames=0` runs each job inline.

On the card the worker runs on a CUDA stream of its own.  At enqueue an
event recorded on the main thread's stream is waited on by the worker's;
at the end of a job an event recorded on the worker's stream is waited on
by the main stream before the result is merged (`threading.Event` remains
the host's hand-shake).  Tensors that one stream allocated and the other
uses are marked with `record_stream`, so the caching allocator never
hands their memory back to its own stream while the other's work on them
is queued: the job's frame and the tracker's snapshot for the worker,
the result's state, remap, re-anchoring transforms and BoW database for
the main thread.  `MapState`s are never written in place (every mutation
returns new tensors), so the base counters a result carries are true
snapshots.

Two host mirrors of `kf_valid`, so that slot allocation does not depend
on the worker's speed: the main thread's, which allocates slots at
enqueue and learns a job's culls at its adoption, and the mapping stage's
own, which a job marks and culls on the worker thread and which is
exactly the valid slots of the worker's state (the JAX package shares one
mirror between the threads; with `async_kf_frames=0` the two agree with
it).  Relocalization reads the BoW database adopted with the last result,
not the worker's live one.

When the default process group (`parallel/distributed.py`) has more than
one rank, the system builds an (obj,) mesh over every rank and the
new-object reconstruction shards over it (the JAX package's
`len(jax.devices()) > 1`); a mesh that cannot be built raises.  Every rank
runs the whole loop on the same inputs, so the mapping stages make the
same collectives in the same order as long as the replicated maps stay
bit-identical: `distributed.initialize` makes the card's ops
deterministic for that, and the mapping stage and `flush` check it
(`distributed.agree`), so a split raises on every rank.
"""
from __future__ import annotations

import queue
import threading
import time
import warnings
from collections import deque

import numpy as np
import torch

from dsp_slam_rgbd_tpu_torch import device as device_mod
from dsp_slam_rgbd_tpu_torch.config import SystemConfig
from dsp_slam_rgbd_tpu_torch.frontend.orb import upload
from dsp_slam_rgbd_tpu_torch.loop import keyframe_db, loop_closing, vocabulary
from dsp_slam_rgbd_tpu_torch.mapping import local_mapping as lm
from dsp_slam_rgbd_tpu_torch.mapping import map_state as ms
from dsp_slam_rgbd_tpu_torch.ops import lie
from dsp_slam_rgbd_tpu_torch.parallel import distributed as dist
from dsp_slam_rgbd_tpu_torch.parallel import mesh as mesh_mod
from dsp_slam_rgbd_tpu_torch.system import io as io_mod
from dsp_slam_rgbd_tpu_torch.system.mapping_stage import KFJob, MappingStage
from dsp_slam_rgbd_tpu_torch.system.prefetch import record_on
from dsp_slam_rgbd_tpu_torch.tracking.tracker import Tracker


def _adopt_merge(state, base_vis, base_fnd, base_first, view_vis, view_fnd,
                 view_first, lf_pt_idx, pt_remap):
    """Merge the tracker's contributions into an adopted mapping state:

    - the found/visible counter deltas the tracker accrued while the job
      ran, except on slots the job culled and recycled (a delta for the old
      tenant must not count for the new landmark);
    - the live frame's associations pushed through the loop-fusion remap
      (the reference's `MapPoint::Replace`) and dropped where the slot's
      tenant changed or died.

    Returns (state with merged counters, the frame's new point slots)."""
    same = state.pt_first_kf == base_first
    dv = torch.where(same, view_vis - base_vis, 0)
    df = torch.where(same, view_fnd - base_fnd, 0)
    new_state = state._replace(pt_visible=state.pt_visible + dv,
                               pt_found=state.pt_found + df)
    pi = torch.where(lf_pt_idx >= 0,
                     pt_remap[torch.clamp_min(lf_pt_idx, 0).long()].to(lf_pt_idx.dtype),
                     lf_pt_idx)
    p = torch.clamp_min(pi, 0).long()
    live = state.pt_valid[p] & (state.pt_first_kf[p] == view_first[p])
    return new_state, torch.where((pi >= 0) & live, pi, -1)


def _new_map(cfg: SystemConfig, device) -> ms.MapState:
    m = cfg.map
    return ms.empty(max_kf=m.max_kf, max_feat=m.max_feat, max_pts=m.max_pts,
                    max_obj=m.max_obj, code_len=cfg.recon.code_len, max_oobs=m.max_oobs,
                    device=device)


class SLAMSystem:
    """`decoder`: the port's `DeepSDFDecoder` (None: detections are
    ignored); `vocab`: a `loop.vocabulary.Vocabulary` (None: no loop closing
    and no BoW relocalization).  Runs on `device` (default the card; raises
    without one unless given device="cpu")."""

    def __init__(self, cfg: SystemConfig, decoder=None, vocab: vocabulary.Vocabulary = None,
                 device="cuda"):
        self.device = device_mod.resolve(device)
        self.cfg = cfg
        self.decoder = decoder
        self.vocab = vocab
        # the worker's stream (None on the CPU)
        self._map_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" \
            else None
        self._kf_valid_host = np.zeros(cfg.map.max_kf, bool)   # the allocator's mirror
        self.kf_slots_exhausted = 0  # keyframes dropped because every slot was taken
        self.localization_only = False
        self._pending = deque()   # in-flight jobs in enqueue order: (job, holder, done, due)
        self._job_q = queue.Queue()
        self._worker = None       # started with the first asynchronous job
        self._frame_dets = {}     # frame id -> the detections passed with that frame
        # host time the main thread spent blocked on the worker (ms)
        self.blocked_ms = {"adopt": 0.0, "prewait": 0.0}
        self.state = _new_map(cfg, self.device)
        # more than one rank: the new-object reconstruction shards over them
        world_size, _ = dist.world()
        self.recon_mesh = mesh_mod.make_mesh(n_obj=world_size, n_ray=1) \
            if world_size > 1 else None
        self.mapping = MappingStage(cfg, self.state, np.zeros(cfg.map.max_kf, bool),
                                    decoder=decoder, vocab=vocab, recon_mesh=self.recon_mesh)
        self._start_lineage()

    def _start_lineage(self):
        """A fresh tracker and n_kf over `self.state`, which the mapping stage
        also starts from (construction, `reset`)."""
        self.tracker = Tracker(self.cfg, self.state, device=self.device)
        if self.mapping.db is not None:
            self.tracker.reloc_candidates_fn = self._reloc_candidates
        self.tracker.pre_fetch_hook = self._prewait_mapping
        self.tracker.mapping_idle_fn = lambda: not self._pending
        self.n_kf = 0
        self.mapping.state = self.state
        self._db_view = self.mapping.db
        record_on((self.state, self.mapping.db), self._map_stream)

    # -- mapping-stage views -------------------------------------------
    @property
    def db(self) -> keyframe_db.BowDatabase:
        """The BoW database as of the last adopted keyframe."""
        return self._db_view

    @property
    def consistency(self):
        return self.mapping.consistency

    @property
    def loop_closures(self) -> int:
        return self.mapping.loop_closures

    @property
    def gba_slice_iters(self) -> int:
        return self.mapping.gba_slice_iters

    @gba_slice_iters.setter
    def gba_slice_iters(self, v: int):
        self.mapping.gba_slice_iters = v

    # ------------------------------------------------------------------
    def _run_job(self, job: KFJob, holder: dict, done: threading.Event, ready) -> None:
        """Run one keyframe job on the worker's stream (any thread): wait for
        the main stream's work up to the enqueue (`ready`), mark the slot in
        the stage's own mirror, process, record the end event."""
        try:
            with torch.cuda.stream(self._map_stream):   # no-op on the CPU
                if ready is not None:
                    self._map_stream.wait_event(ready)
                self.mapping.kf_valid_host[job.kf_slot] = True
                holder["result"] = self.mapping.process(job)
                holder["db"] = self.mapping.db
                if self._map_stream is not None:
                    holder["event"] = torch.cuda.Event()
                    holder["event"].record(self._map_stream)
        except BaseException as e:  # raised again at adoption
            holder["exc"] = e
        finally:
            done.set()

    def _worker_loop(self):
        while True:
            item = self._job_q.get()
            if item is None:
                return
            self._run_job(*item)

    def _enqueue_kf(self, frame, detections, timestamp: float, fid=None) -> bool:
        """Allocate the keyframe's slot and hand the keyframe stage to the
        worker (or run it inline in sync mode and for the two bootstrap
        keyframes).  False when every keyframe slot is taken (warned once,
        counted in `kf_slots_exhausted`; tracking goes on).  `fid`: the
        keyframe's frame id (the pipelined tracker finalizes a frame late)."""
        if fid is None:
            fid = self.tracker.frame_id
        slot = int(ms.alloc_slots(self._kf_valid_host, 1)[0])
        if slot < 0:
            self.kf_slots_exhausted += 1
            if self.kf_slots_exhausted == 1:
                warnings.warn(f"keyframe capacity exhausted (max_kf={self.cfg.map.max_kf}); "
                              "dropping keyframes: increase MapConfig.max_kf", RuntimeWarning)
            return False
        self._kf_valid_host[slot] = True
        job = KFJob(frame=frame, detections=detections, kf_slot=slot, kid=self.n_kf,
                    frame_id=fid, timestamp=timestamp, view_pt_first=self.state.pt_first_kf)
        self.n_kf += 1
        self.tracker.last_kf_frame_id = fid
        ready = None
        if self._map_stream is not None:
            record_on((job.frame, job.view_pt_first), self._map_stream)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        # the bootstrap keyframes run inline: the next frame tracks on them
        sync = self.cfg.async_kf_frames <= 0 or self.n_kf <= 2
        holder, done = {}, threading.Event()
        if sync:
            self._run_job(job, holder, done, ready)
            self._adopt((job, holder, done, self.tracker.frame_id))
            return True
        if self._worker is None:
            self._worker = threading.Thread(target=self._worker_loop, daemon=True,
                                            name="mapping-stage")
            self._worker.start()
        self._pending.append((job, holder, done, self.tracker.frame_id + self.cfg.async_kf_frames))
        self._job_q.put((job, holder, done, ready))
        return True

    def _adopt_due(self):
        """Adopt every result whose due frame has come (at the start of a
        frame, before `tracker.frame_id` is incremented: hence the +1)."""
        while self._pending and self._pending[0][3] <= self.tracker.frame_id + 1:
            self._adopt(self._pending.popleft())

    def _adopt(self, entry):
        job, holder, done, _due = entry
        t0 = time.perf_counter()
        done.wait()
        self.blocked_ms["adopt"] += (time.perf_counter() - t0) * 1e3
        if "exc" in holder:
            raise holder["exc"]
        res = holder["result"]
        if "event" in holder:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(holder["event"])
            record_on((res.state, res.base_pt_visible, res.base_pt_found, res.base_pt_first,
                       res.pt_remap, res.culled, holder["db"]), cur)
        lf = self.tracker.last_frame
        view = self.tracker.state
        P = res.state.pt_pos.shape[0]
        lf_pt = lf.pt_idx if lf is not None \
            else torch.zeros(0, dtype=torch.int32, device=self.device)
        remap = res.pt_remap if res.pt_remap is not None \
            else torch.arange(P, dtype=torch.int32, device=self.device)
        new_state, new_pt = _adopt_merge(
            res.state, res.base_pt_visible, res.base_pt_found, res.base_pt_first,
            view.pt_visible, view.pt_found, view.pt_first_kf, lf_pt, remap)
        if lf is not None:
            self.tracker.last_frame = lf._replace(pt_idx=new_pt)
        self.state = new_state
        self.tracker.state = new_state
        self._db_view = holder["db"]
        for c, _, _ in res.culled:
            self._kf_valid_host[c] = False
        self.tracker._kv_memo = (new_state.kf_valid, res.kf_valid_host)
        # the job's frame became keyframe `kf_slot`: its relative-trajectory
        # entry is re-anchored to itself (T_rel = I), as the reference's
        # CreateNewKeyFrame makes the new keyframe the frame's reference.
        # The entry is found by frame id (the JAX package matches the
        # timestamp, which picks a later frame when timestamps repeat)
        rel = self.tracker.relative_trajectory
        for i in range(len(rel) - 1, -1, -1):
            ts, _ref, _t_rel, ok, fid = rel[i]
            if fid == res.frame_id:
                rel[i] = (ts, res.kf_slot, torch.eye(4, device=self.device), ok, fid)
                break
        # entries referencing culled keyframes (whose slots may be recycled)
        # move to the fallback keyframe, over the whole list
        if res.culled:
            fix = {c: (fb, t) for c, fb, t in res.culled}
            for i, (ts, ref, t_rel, ok, fid) in enumerate(rel):
                if ref in fix:
                    fb, t = fix[ref]
                    rel[i] = (ts, fb, t_rel @ t, ok, fid)
            if self.tracker.ref_kf in fix:
                self.tracker.ref_kf = fix[self.tracker.ref_kf][0]
        if self.tracker.ref_kf < 0:
            self.tracker.ref_kf = res.kf_slot
        if res.map_changed:
            self.tracker.map_changed = True

    def _prewait_mapping(self):
        """Wait (without adopting) for the job due at the next frame, just
        before the tracker's stats read, so the wait overlaps the read."""
        if self._pending and self._pending[0][3] <= self.tracker.frame_id + 2:
            t0 = time.perf_counter()
            self._pending[0][2].wait()
            self.blocked_ms["prewait"] += (time.perf_counter() - t0) * 1e3

    def flush(self):
        """Finalize the tracking pipeline and adopt every in-flight job.
        Call before reading the final map, saving or resetting."""
        for out in self.tracker.finalize_pending():
            self.state = self.tracker.state
            if not self.localization_only:
                self._handle_track_out(out)
        self.state = self.tracker.state
        while self._pending:
            self._adopt(self._pending.popleft())
        if self.recon_mesh is not None:
            # a rank with a keyframe job more than the others meets their
            # flush here, not a collective of its own
            dist.agree("flush", [self.n_kf, self.mapping._jobs])

    # ------------------------------------------------------------------
    def _reloc_candidates(self, frame, top_k: int = 5) -> list:
        """BoW retrieval for relocalization (`DetectRelocalizationCandidates`):
        the frame scored against the adopted database, grouped over the
        tracker's view of the map (only the top-k candidates' covisibility
        rows).  One host read."""
        w = vocabulary.quantize(self.vocab, frame.feats.desc, frame.feats.valid)
        q = vocabulary.bow_vector(w, self.vocab.n_words)
        cand_idx, _ = keyframe_db.detect_reloc_candidates_grouped(
            self._db_view, q, self.tracker.state, top_l=top_k)
        return [int(k) for k in cand_idx.cpu().numpy() if k >= 0]

    # ------------------------------------------------------------------
    def activate_localization_mode(self):
        """Track against the frozen map, insert no keyframes (reference
        `System::ActivateLocalizationMode`)."""
        self.flush()
        self.localization_only = True

    def deactivate_localization_mode(self):
        self.localization_only = False

    def reset(self):
        """Clear map, database and tracker (reference `System::Reset`)."""
        self.flush()
        self.state = _new_map(self.cfg, self.device)
        self._kf_valid_host[:] = False
        m = self.mapping
        m.kf_valid_host[:] = False
        if m.vocab is not None:
            m.db = keyframe_db.empty(self.cfg.map.max_kf, m.vocab.n_words, device=self.device)
        m.consistency = loop_closing.ConsistencyState()
        m._gba_iters_left = 0
        m._last_loop_kid = -100
        m._oobs_cursor = {}
        self._frame_dets.clear()
        self._start_lineage()

    def load_state(self, path: str) -> dict:
        """Restore a `utils/checkpoint.py` MapState into the running system,
        rebuilding both keyframe mirrors (the allocator's source of truth).
        Returns the checkpoint's extra entries."""
        from dsp_slam_rgbd_tpu_torch.utils import checkpoint

        self.flush()
        state, extra = checkpoint.load_state(path, device=self.device)
        record_on(state, self._map_stream)
        self.state = self.tracker.state = self.mapping.state = state
        kv = state.kf_valid.cpu().numpy()
        self._kf_valid_host[:] = kv
        self.mapping.kf_valid_host[:] = kv
        self.tracker._kv_memo = (state.kf_valid, kv.copy())
        self.n_kf = int(extra.get("n_kf", kv.sum()))
        return extra

    # ------------------------------------------------------------------
    def track_stereo(self, img_left, img_right, timestamp=0.0, detections=None):
        return self._track(img_left, img_right=img_right, timestamp=timestamp,
                           detections=detections)

    def track_rgbd(self, img, depth, timestamp=0.0, detections=None):
        return self._track(img, depth_map=depth, timestamp=timestamp, detections=detections)

    def track_mono(self, img, timestamp=0.0, detections=None):
        return self._track(img, timestamp=timestamp, detections=detections)

    def track_frame(self, frame, detections=None):
        """Track a Frame made ahead (`prefetch.FramePrefetcher`)."""
        return self._track(None, timestamp=frame.timestamp, detections=detections, frame=frame)

    def _track(self, img, img_right=None, depth_map=None, timestamp=0.0, detections=None,
               frame=None):
        # adopt the due results first: this frame tracks against the newest
        # adopted map (staleness async_kf_frames, whatever the worker's speed)
        self._adopt_due()
        self.tracker.state = self.state
        outs = self.tracker.track(img, img_right=img_right, depth_map=depth_map,
                                  timestamp=timestamp, frame=frame)
        self.state = self.tracker.state
        if self.localization_only:
            return outs[-1]
        # each finalized frame's keyframe takes that frame's own detections
        # (the pipelined tracker finalizes a frame late)
        self._frame_dets[self.tracker.frame_id] = detections
        for out in outs:
            self._handle_track_out(out)
        return outs[-1]

    def _handle_track_out(self, out):
        """Keyframe handling for one finalized tracking result."""
        if out.get("provisional"):
            return
        fid = out.get("fid")
        detections = self._frame_dets.pop(fid, None)
        for k in [k for k in self._frame_dets if k < fid]:
            del self._frame_dets[k]
        if not out.get("new_kf"):
            return
        first_kf = self.n_kf == 0
        timestamp = out.get("timestamp", 0.0)
        if self.tracker.status == "OK" and first_kf and self.cfg.sensor == "mono" \
                and hasattr(self.tracker, "init_result"):
            self._insert_mono_init()
            self.tracker.state = self.state
        else:
            self._enqueue_kf(out["frame"], detections, timestamp, fid=fid)
        if first_kf and self.tracker.ref_kf >= 0 and not self.tracker.relative_trajectory:
            # the init frame joins the relative trajectory (its reference
            # keyframe did not exist when it was tracked)
            t_rel = out["frame"].t_cw @ lie.inv_se3(self.state.kf_pose[self.tracker.ref_kf])
            self.tracker.relative_trajectory.append(
                (timestamp, self.tracker.ref_kf, t_rel, True, fid))

    # ------------------------------------------------------------------
    def _insert_mono_init(self):
        """The two initial keyframes and the median-depth-normalized points
        of the tracker's monocular initialization (`tracker.init_result`,
        reference `CreateInitialMapMonocular`), then the BoW database.
        Synchronous: the next frame tracks on this map.  One host read
        ([accepted matches | match indices | point slots in use])."""
        self.flush()
        tr, mapping, kv = self.tracker, self.mapping, self._kf_valid_host
        r = tr.init_result
        ref, cur, m = r["ref_frame"], r["cur_frame"], r["matches"]
        dev = tr.device
        k0 = int(ms.alloc_slots(kv, 1)[0])
        state = lm.insert_keyframe(mapping.state, ref._replace(t_cw=torch.eye(4, device=dev)),
                                   k0, 0)
        kv[k0] = True
        k1 = int(ms.alloc_slots(kv, 1)[0])
        state = lm.insert_keyframe(state, cur._replace(t_cw=r["t21"]), k1, 1)
        kv[k1] = True
        mapping.kf_valid_host[:] = kv

        N = m.valid.shape[0]
        host = torch.cat([(r["good"] & m.valid).long(), m.idx.long(),
                          state.pt_valid.long()]).cpu().numpy()
        chosen = np.nonzero(host[:N])[0]
        midx = host[N:2 * N]
        slots = ms.alloc_slots(host[2 * N:].astype(bool), len(chosen))
        ok = slots >= 0
        chosen, slots = chosen[ok], slots[ok]
        sl, ch = upload(slots, dev), upload(chosen, dev)

        def put(a, idx, value):
            return a.index_put(idx, value if isinstance(value, torch.Tensor)
                               else torch.full((), value, dtype=a.dtype, device=dev))

        # observations past the keyframes' feature slots (max_feat) are dropped,
        # as the JAX package's out-of-range `.at[].set` drops them
        F = state.kf_feat_pt.shape[1]
        kf_feat_pt = state.kf_feat_pt
        for k, feat in ((k0, chosen), (k1, midx[chosen])):
            keep = feat < F
            idx = upload(feat[keep], dev)
            kf_feat_pt = put(kf_feat_pt, (torch.full_like(idx, k), idx),
                             upload(slots[keep], dev).to(torch.int32))
        state = state._replace(
            pt_pos=put(state.pt_pos, (sl,), r["pts"][ch]),
            pt_valid=put(state.pt_valid, (sl,), True),
            pt_desc=put(state.pt_desc, (sl,), ref.feats.desc[ch]),
            pt_ref_kf=put(state.pt_ref_kf, (sl,), k0),
            pt_first_kf=put(state.pt_first_kf, (sl,), 0),  # monotonic keyframe id
            kf_feat_pt=kf_feat_pt)
        self.state = mapping.state = tr.state = state
        tr._kv_memo = (state.kf_valid, kv.copy())
        tr.ref_kf = k1
        tr.last_kf_frame_id = tr.frame_id
        self.n_kf = 2
        mapping._update_bow(k0)
        mapping._update_bow(k1)
        self._db_view = mapping.db
        record_on((state, mapping.db), self._map_stream)

    # ------------------------------------------------------------------
    def _frame_poses(self):
        """Per-frame poses from the CURRENT keyframe poses through the stored
        relative transforms, so BA and loop corrections reach the saved
        trajectories (reference `System::SaveTrajectoryTUM/KITTI`).  One
        bulk read."""
        self.flush()
        rel = self.tracker.relative_trajectory
        if rel:
            rels = torch.stack([t for _, _, t, _, _ in rel])
            host = torch.cat([self.state.kf_pose.reshape(-1), rels.reshape(-1)]).cpu().numpy()
            K = self.state.kf_pose.shape[0]
            kf_poses = host[:K * 16].reshape(K, 4, 4)
            refs = np.asarray([ref for _, ref, _, _, _ in rel])
            poses = np.einsum("nij,njk->nik", host[K * 16:].reshape(-1, 4, 4), kf_poses[refs])
            return (np.asarray([t for t, _, _, _, _ in rel]), poses,
                    np.asarray([o for _, _, _, o, _ in rel], bool))
        traj = self.tracker.trajectory
        if not traj:
            return np.zeros(0), np.zeros((0, 4, 4)), np.zeros(0, bool)
        poses = torch.stack([p for _, p, _ in traj])
        return (np.asarray([t for t, _, _ in traj]), poses.cpu().numpy(),
                np.asarray([o for _, _, o in traj], bool))

    def save_trajectory_kitti(self, path: str):
        _, poses, ok = self._frame_poses()
        io_mod.save_trajectory_kitti(path, poses, ok)

    def save_trajectory_tum(self, path: str):
        ts, poses, ok = self._frame_poses()
        io_mod.save_trajectory_tum(path, poses, ts, ok)

    def save_entire_map(self, dirname: str):
        self.flush()
        io_mod.save_entire_map(dirname, self.state)

    def shutdown(self):
        """Adopt what is in flight and join the worker (reference
        `System::Shutdown`)."""
        self.flush()
        if self._worker is not None:
            self._job_q.put(None)
            self._worker.join(timeout=30.0)
            self._worker = None
