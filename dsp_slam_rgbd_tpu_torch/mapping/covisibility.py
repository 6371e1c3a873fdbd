"""Covisibility graph queries.

Counterpart of `dsp_slam_rgbd_tpu/mapping/covisibility.py` (reference
`KeyFrame::UpdateConnections` / `GetBestCovisibilityKeyFrames`,
`src/KeyFrame.cc:125-203`): weight(i, j) = number of co-observed map
points, connections kept at weight ≥ 15.  A row is O(K·F) through a point
mask; the full matrix is computed `chunk` rows at a time.
"""
from __future__ import annotations

import torch

from dsp_slam_rgbd_tpu_torch.mapping import map_state as ms

MIN_WEIGHT = 15


def covisibility_rows(state: ms.MapState, kfs: torch.Tensor) -> torch.Tensor:
    """(L, K) int32 co-observation counts of each KF in `kfs` vs every KF
    (self zeroed): scatter a KF's point set into a (P,) mask, gather it
    through the whole feature→point table, and sum per keyframe."""
    P = state.pt_pos.shape[0]
    kfs = kfs.long().reshape(-1)
    L = kfs.shape[0]
    ok = ms._obs_ok(state)                               # (K, F)
    tgt = torch.where(ok, state.kf_feat_pt.long(), P)    # (K, F)
    # (L, P+1) point masks of the query KFs
    rows = torch.arange(L, device=ok.device)[:, None]
    pmask = ms.mark(L * (P + 1), (rows * (P + 1) + tgt[kfs]).reshape(-1))
    pmask = pmask.reshape(L, P + 1)[:, :P]
    pt = torch.clamp_min(state.kf_feat_pt, 0).long()    # (K, F)
    hits = ok[None] & pmask[:, pt]                       # (L, K, F)
    w = torch.sum(hits, dim=2).to(torch.int32) * state.kf_valid.to(torch.int32)
    return w.scatter(1, kfs[:, None], 0)


def covisibility_row(state: ms.MapState, kf) -> torch.Tensor:
    """(K,) int32 co-observation counts of `kf` (a slot number or a
    one-element tensor) vs every KF (self zeroed)."""
    if isinstance(kf, torch.Tensor):
        kfs = kf.reshape(1)
    else:  # filled on the device: a host scalar uploaded to the card blocks
        kfs = torch.full((1,), kf, dtype=torch.long, device=state.kf_valid.device)
    return covisibility_rows(state, kfs)[0]


def covisibility_matrix(state: ms.MapState, chunk: int = 16) -> torch.Tensor:
    """(K, K) int32 co-observation counts (diagonal zeroed), `chunk` rows at
    a time (O(chunk·(P + K·F)) working set)."""
    K = state.kf_valid.shape[0]
    dev = state.kf_valid.device
    W = torch.cat([covisibility_rows(state, torch.arange(s, min(s + chunk, K), device=dev))
                   for s in range(0, K, chunk)])
    return W * state.kf_valid[:, None].to(torch.int32)


def local_window(state: ms.MapState, center_kf: int, max_kfs: int,
                 min_weight: int = MIN_WEIGHT):
    """Covisible neighborhood of a keyframe: the local-BA window (reference
    `LocalBundleAdjustment`, `Optimizer.cc:453`).

    Returns (kf_mask (K,) bool incl. center, frontier_mask (K,) bool — KFs
    that see the window's points but are not in it, window_pts (P,) bool).
    """
    w_center = covisibility_row(state, center_kf)
    in_window = (w_center >= min_weight) & state.kf_valid
    # (fill_: a scalar assigned into a card tensor is copied from the host)
    in_window[center_kf].fill_(True)
    # cap to the top max_kfs by weight (equal weights in index order)
    score = torch.where(in_window, w_center + 1, -1)
    score[center_kf].fill_(torch.iinfo(torch.int32).max)
    order = torch.argsort(-score.long(), stable=True)
    in_window = in_window & ms.mark(in_window.shape[0], order[:max_kfs])

    window_pts = ms.point_mask_of(state, in_window)
    sees = ms.kf_sees_mask(state, window_pts)
    frontier = sees & ~in_window & state.kf_valid
    return in_window, frontier, window_pts


def best_covisible(state: ms.MapState, kf: int, n: int):
    """Indices and weights of the n best covisible KFs of `kf`."""
    w = torch.where(state.kf_valid, covisibility_row(state, kf), -1)
    order = torch.argsort(-w.long(), stable=True)[:n]
    return order, w[order]
