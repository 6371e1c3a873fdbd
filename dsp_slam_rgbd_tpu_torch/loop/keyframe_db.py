"""Keyframe database: place-recognition retrieval over BoW vectors.

Counterpart of `dsp_slam_rgbd_tpu/loop/keyframe_db.py` (reference
`KeyFrameDatabase`, `src/KeyFrameDatabase.cc`): the inverted file and the
accumulated-score grouping of `DetectLoopCandidates` (:76) and
`DetectRelocalizationCandidates` (:199).  The inverted file is the dense
(K, W) BoW matrix: scores against all keyframes are one reduction, and
candidate selection is vectorized.  Ties between equal scores go to the
lower slot, as `lax.top_k` gives them (stable descending sorts).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from dsp_slam_rgbd_tpu_torch.frontend.fast import top_k_stable
from dsp_slam_rgbd_tpu_torch.loop import vocabulary as vocab_mod
from dsp_slam_rgbd_tpu_torch.mapping import covisibility as covis
from dsp_slam_rgbd_tpu_torch.mapping.local_mapping import _set_row


class BowDatabase(NamedTuple):
    bow: torch.Tensor        # (K, W) L1-normalized BoW vectors
    kf_valid: torch.Tensor   # (K,)

    def add(self, kf_slot: int, v: torch.Tensor):
        return self._replace(bow=_set_row(self.bow, kf_slot, v),
                             kf_valid=_set_row(self.kf_valid, kf_slot, True))

    def remove(self, kf_slot: int):
        """Purge a culled keyframe (reference `KeyFrameDatabase::erase`) —
        otherwise dead slots keep surfacing as loop/reloc candidates."""
        return self._replace(bow=_set_row(self.bow, kf_slot, 0.0),
                             kf_valid=_set_row(self.kf_valid, kf_slot, False))


def empty(max_kf: int, n_words: int, device="cuda") -> BowDatabase:
    from dsp_slam_rgbd_tpu_torch import device as device_mod

    dev = device_mod.resolve(device)
    return BowDatabase(torch.zeros(max_kf, n_words, device=dev),
                       torch.zeros(max_kf, dtype=torch.bool, device=dev))


def _tfidf_scores(db: BowDatabase, query: torch.Tensor) -> torch.Tensor:
    """(K,) L1 scores with tf-idf weighting (DBoW2's TF_IDF scoring,
    `ORBVocabulary.h:31-32`): idf comes from the live database (document
    frequency over current keyframes), refreshed per query."""
    idf = vocab_mod.compute_idf(db.bow, db.kf_valid)
    rows = db.bow * idf[None, :]
    rows = rows / torch.clamp_min(torch.sum(rows, dim=1, keepdim=True), 1e-12)
    q = query * idf
    q = q / torch.clamp_min(torch.sum(q), 1e-12)
    return vocab_mod.l1_score(rows, q[None, :])


def _min_score_ref(db: BowDatabase, scores, connected_mask):
    """The minimum score among the connected keyframes, capped at 1 (0 when
    none is connected): the reference's baseline `minScore`."""
    cov_scores = torch.where(connected_mask & db.kf_valid, scores, torch.inf)
    m = torch.clamp_max(torch.min(cov_scores), 1.0)
    return torch.where(torch.isfinite(m), m, 0.0)


def _group_gate(scores, eligible, neigh):
    """Accumulated group scores (`accScore`, :131-160) and the 0.75-of-best
    gate over candidates `eligible`; neigh (K, K) float covisibility."""
    acc = scores + neigh @ torch.where(eligible, scores, 0.0)
    best_acc = torch.max(torch.where(eligible, acc, 0.0))
    return eligible & (acc >= 0.75 * best_acc)


def detect_loop_candidates(db: BowDatabase, query: torch.Tensor,
                           connected_mask: torch.Tensor,
                           covis_weights: torch.Tensor, min_score_ref=None):
    """Loop candidates for one query KF over the dense (K, K) covisibility
    weights (the connected set is excluded; scores accumulate over each
    candidate's covisible group).  Returns (candidate_mask (K,), scores (K,))."""
    scores = _tfidf_scores(db, query)
    if min_score_ref is None:
        min_score_ref = _min_score_ref(db, scores, connected_mask)
    eligible = db.kf_valid & ~connected_mask & (scores >= min_score_ref)
    return _group_gate(scores, eligible, (covis_weights > 0).float()), scores


def detect_reloc_candidates(db: BowDatabase, query: torch.Tensor,
                            covis_weights: torch.Tensor):
    """Relocalization candidates (no connected-set exclusion, score ≥ 0.75
    of best group score — reference :199-310)."""
    scores = _tfidf_scores(db, query)
    eligible = db.kf_valid & (scores > 0.0)
    return _group_gate(scores, eligible, (covis_weights > 0).float()), scores


def _grouped(db: BowDatabase, scores, eligible, state, top_l: int):
    """Group scores over the covisible rows of the top-`top_l` raw-score
    candidates only -> (cand_idx (top_l,) with −1 where the gate rejects,
    rows (top_l, K) covisibility counts of the candidates)."""
    svals, cidx = top_k_stable(torch.where(eligible, scores, -1.0),
                               min(top_l, scores.shape[0]))
    live = svals > 0.0
    rows = covis.covisibility_rows(state, torch.clamp_min(cidx, 0))  # (L, K)
    acc = svals + (rows > 0).float() @ torch.where(eligible, scores, 0.0)
    best_acc = torch.max(torch.where(live, acc, 0.0))
    keep = live & (acc >= 0.75 * best_acc)
    return torch.where(keep, cidx, -1).to(torch.int32), rows


def detect_loop_candidates_grouped(db: BowDatabase, query: torch.Tensor,
                                   connected_mask: torch.Tensor, state, top_l: int):
    """Scale-safe `detect_loop_candidates`: group scores accumulate over the
    covisible rows of the top-`top_l` raw-score candidates only —
    O(top_l·(P + K·F)) instead of the (K, K)-matrix group accumulation (the
    reference group-scores its short candidate list, each over
    `GetBestCovisibilityKeyFrames`, `KeyFrameDatabase.cc:131-160`).

    Returns (cand_idx (top_l,) score-ordered / −1 where the 0.75·best-acc
    gate rejects, scores (K,), rows (top_l, K) covisibility counts of the
    candidates)."""
    scores = _tfidf_scores(db, query)
    eligible = db.kf_valid & ~connected_mask \
        & (scores >= _min_score_ref(db, scores, connected_mask))
    cand, rows = _grouped(db, scores, eligible, state, top_l)
    return cand, scores, rows


def detect_reloc_candidates_grouped(db: BowDatabase, query: torch.Tensor, state,
                                    top_l: int):
    """Scale-safe `detect_reloc_candidates` (same top-L row expansion; no
    connected-set exclusion).  Returns (cand_idx (top_l,) with −1 holes,
    scores (K,))."""
    scores = _tfidf_scores(db, query)
    cand, _ = _grouped(db, scores, db.kf_valid & (scores > 0.0), state, top_l)
    return cand, scores
