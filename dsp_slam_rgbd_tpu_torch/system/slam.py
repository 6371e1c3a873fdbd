"""The system's keyframe glue around the tracker and the mapping stage.

Counterpart of two methods of `dsp_slam_rgbd_tpu/system/slam.py`'s
`SLAMSystem`, as free functions over the port's `Tracker`, its
`MappingStage` and the host keyframe mask (the orchestrator that will call
them as its methods — worker thread, adoption, exporters — is not ported
yet):

  * `insert_mono_init` — `SLAMSystem._insert_mono_init` (reference
    `CreateInitialMapMonocular`): the two initial keyframes and the
    median-depth-normalized points of a monocular initialization;
  * `reloc_candidates` — `SLAMSystem._reloc_candidates` (the
    `DetectRelocalizationCandidates` role): BoW retrieval for the
    tracker's relocalization hook.
"""
from __future__ import annotations

import numpy as np
import torch

from dsp_slam_rgbd_tpu_torch.frontend.orb import upload
from dsp_slam_rgbd_tpu_torch.loop import keyframe_db, vocabulary
from dsp_slam_rgbd_tpu_torch.mapping import local_mapping as lm
from dsp_slam_rgbd_tpu_torch.mapping import map_state as ms


def insert_mono_init(mapping, tracker, kf_valid_host: np.ndarray) -> int:
    """Create the two initial KFs + triangulated points of the tracker's
    monocular initialization (`tracker.init_result`) in `mapping.state`,
    hand the map to the tracker and fill the BoW database.  Synchronous:
    the next frame tracks against this map.  One host read ([accepted
    matches | match indices | point slots in use]).  Returns the keyframe
    count (2)."""
    r = tracker.init_result
    ref, cur, m = r["ref_frame"], r["cur_frame"], r["matches"]
    dev = tracker.device
    k0 = int(ms.alloc_slots(kf_valid_host, 1)[0])
    state = lm.insert_keyframe(mapping.state, ref._replace(t_cw=torch.eye(4, device=dev)), k0, 0)
    kf_valid_host[k0] = True
    k1 = int(ms.alloc_slots(kf_valid_host, 1)[0])
    state = lm.insert_keyframe(state, cur._replace(t_cw=r["t21"]), k1, 1)
    kf_valid_host[k1] = True

    N = m.valid.shape[0]
    host = torch.cat([(r["good"] & m.valid).long(), m.idx.long(),
                      state.pt_valid.long()]).cpu().numpy()
    chosen = np.nonzero(host[:N])[0]
    midx = host[N:2 * N]
    slots = ms.alloc_slots(host[2 * N:].astype(bool), len(chosen))
    ok = slots >= 0
    chosen, slots = chosen[ok], slots[ok]
    sl, ch = upload(slots, dev), upload(chosen, dev)
    sl32 = sl.to(torch.int32)

    def put(a, idx, value):
        return a.index_put(idx, value if isinstance(value, torch.Tensor)
                           else torch.full((), value, dtype=a.dtype, device=dev))

    kf_feat_pt = put(state.kf_feat_pt, (torch.full_like(ch, k0), ch), sl32)
    kf_feat_pt = put(kf_feat_pt, (torch.full_like(ch, k1), upload(midx[chosen], dev)), sl32)
    state = state._replace(
        pt_pos=put(state.pt_pos, (sl,), r["pts"][ch]),
        pt_valid=put(state.pt_valid, (sl,), True),
        pt_desc=put(state.pt_desc, (sl,), ref.feats.desc[ch]),
        pt_ref_kf=put(state.pt_ref_kf, (sl,), k0),
        pt_first_kf=put(state.pt_first_kf, (sl,), 0),  # monotonic keyframe id
        kf_feat_pt=kf_feat_pt)
    mapping.state = state
    tracker.state = state
    tracker._kv_memo = (state.kf_valid, kf_valid_host.copy())
    tracker.ref_kf = k1
    tracker.last_kf_frame_id = tracker.frame_id
    mapping._update_bow(k0)
    mapping._update_bow(k1)
    return 2


def reloc_candidates(mapping, tracker, frame, top_k: int = 5) -> list:
    """BoW retrieval for relocalization: quantize the frame, score it
    against `mapping.db` and group over the tracker's view of the map
    (scale-safe: only the top-k candidates' covisibility rows).  Install
    as `tracker.reloc_candidates_fn = lambda f: reloc_candidates(mapping,
    tracker, f)`.  One host read."""
    w = vocabulary.quantize(mapping.vocab, frame.feats.desc, frame.feats.valid)
    q = vocabulary.bow_vector(w, mapping.vocab.n_words)
    cand_idx, _ = keyframe_db.detect_reloc_candidates_grouped(mapping.db, q, tracker.state,
                                                              top_l=top_k)
    return [int(k) for k in cand_idx.cpu().numpy() if k >= 0]
