"""SLAM map state as fixed-capacity struct-of-arrays tensors.

Counterpart of `dsp_slam_rgbd_tpu/mapping/map_state.py`: every field, its
shape and its meaning are the JAX package's; descriptors are int32 words
holding the bits of its uint32 ones.  Capacities are static; every
mutation returns a new `MapState` (the tensors of the old one are not
written), so a caller may keep an old state as a snapshot.

Scatters that the JAX package writes with an out-of-range "drop" target
(P, K, F) write into a buffer with one spare row that is then sliced off.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dsp_slam_rgbd_tpu_torch import device as device_mod


class MapState(NamedTuple):
    # --- keyframes ---
    kf_pose: torch.Tensor       # (K, 4, 4) T_cw
    kf_valid: torch.Tensor      # (K,) bool
    kf_frame_id: torch.Tensor   # (K,) int32 source frame index
    # per-KF features
    kf_xy: torch.Tensor         # (K, F, 2)
    kf_level: torch.Tensor      # (K, F) int32
    kf_desc: torch.Tensor       # (K, F, 8) int32 words
    kf_ur: torch.Tensor         # (K, F) right coord (−1 mono)
    kf_feat_valid: torch.Tensor # (K, F) bool
    kf_feat_pt: torch.Tensor    # (K, F) int32 -> point slot or −1
    # --- map points ---
    pt_pos: torch.Tensor        # (P, 3)
    pt_valid: torch.Tensor      # (P,) bool
    pt_desc: torch.Tensor       # (P, 8) int32 distinctive descriptor
    pt_normal: torch.Tensor     # (P, 3) mean viewing direction
    pt_min_d: torch.Tensor      # (P,) scale-invariance range
    pt_max_d: torch.Tensor
    pt_ref_kf: torch.Tensor     # (P,) int32 reference KF
    pt_visible: torch.Tensor    # (P,) int32 counters (found/visible ratio)
    pt_found: torch.Tensor
    pt_first_kf: torch.Tensor   # (P,) int32 for culling age
    pt_object: torch.Tensor     # (P,) int32 owning object slot or −1
    pt_outlier: torch.Tensor    # (P,) bool object-outlier flag
    # --- objects ---
    obj_pose: torch.Tensor      # (O, 4, 4) T_wo SE(3)
    obj_scale: torch.Tensor     # (O,)
    obj_code: torch.Tensor      # (O, L) shape codes
    obj_valid: torch.Tensor     # (O,) bool
    obj_dynamic: torch.Tensor   # (O,) bool
    obj_velocity: torch.Tensor  # (O, 3)
    obj_n_obs: torch.Tensor     # (O,) int32
    obj_last_kf: torch.Tensor   # (O,) int32
    obj_ref_kfseq: torch.Tensor # (O,) int32 KF sequence number at creation
    obj_recon: torch.Tensor     # (O,) bool reconstructed flag
    obj_bbox_min: torch.Tensor  # (O, 3) decoded-shape bbox, object frame
    obj_bbox_max: torch.Tensor
    # object-KF relative pose observations (ring buffer per object)
    oobs_kf: torch.Tensor       # (Q,) int32 KF slot
    oobs_obj: torch.Tensor      # (Q,) int32 object slot
    oobs_t_co: torch.Tensor     # (Q, 4, 4) measured T_co
    oobs_valid: torch.Tensor    # (Q,) bool

    @property
    def max_kf(self):
        return self.kf_pose.shape[0]


def empty(max_kf: int = 64, max_feat: int = 1024, max_pts: int = 8192,
          max_obj: int = 16, code_len: int = 64, max_oobs: int = 256,
          device="cuda") -> MapState:
    K, F, P, O, Q = max_kf, max_feat, max_pts, max_obj, max_oobs
    dev = device_mod.resolve(device)
    i32, f32 = torch.int32, torch.float32

    def full(shape, value, dtype=f32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    def eyes(n):
        return torch.eye(4, dtype=f32, device=dev).expand(n, 4, 4).clone()

    return MapState(
        kf_pose=eyes(K),
        kf_valid=full((K,), False, torch.bool),
        kf_frame_id=full((K,), -1, i32),
        kf_xy=full((K, F, 2), 0.0),
        kf_level=full((K, F), 0, i32),
        kf_desc=full((K, F, 8), 0, i32),
        kf_ur=full((K, F), -1.0),
        kf_feat_valid=full((K, F), False, torch.bool),
        kf_feat_pt=full((K, F), -1, i32),
        pt_pos=full((P, 3), 0.0),
        pt_valid=full((P,), False, torch.bool),
        pt_desc=full((P, 8), 0, i32),
        pt_normal=full((P, 3), 0.0),
        pt_min_d=full((P,), 0.0),
        pt_max_d=full((P,), float("inf")),
        pt_ref_kf=full((P,), -1, i32),
        pt_visible=full((P,), 1, i32),
        pt_found=full((P,), 1, i32),
        pt_first_kf=full((P,), -1, i32),
        pt_object=full((P,), -1, i32),
        pt_outlier=full((P,), False, torch.bool),
        obj_pose=eyes(O),
        obj_scale=full((O,), 1.0),
        obj_code=full((O, code_len), 0.0),
        obj_valid=full((O,), False, torch.bool),
        obj_dynamic=full((O,), False, torch.bool),
        obj_velocity=full((O, 3), 0.0),
        obj_n_obs=full((O,), 0, i32),
        obj_last_kf=full((O,), -1, i32),
        obj_ref_kfseq=full((O,), -1, i32),
        obj_recon=full((O,), False, torch.bool),
        obj_bbox_min=full((O, 3), -1.0),
        obj_bbox_max=full((O, 3), 1.0),
        oobs_kf=full((Q,), -1, i32),
        oobs_obj=full((Q,), -1, i32),
        oobs_t_co=eyes(Q),
        oobs_valid=full((Q,), False, torch.bool),
    )


def alloc_slots(valid_mask, n: int) -> np.ndarray:
    """Host-side: first n free slot indices (−1 padding if full)."""
    free = np.nonzero(~np.asarray(valid_mask))[0]
    out = np.full(n, -1, np.int64)
    out[: min(n, len(free))] = free[:n]
    return out


def first_members(mask: torch.Tensor, k: int):
    """Device-side: the indices of `mask`'s true entries in ascending order,
    then its false entries in ascending order, cut to k — the order
    `lax.top_k(mask.astype(int), k)` gives — and whether each is true."""
    m = mask.to(torch.int64)
    n_true = torch.sum(m)
    rank_t = torch.cumsum(m, 0) - 1
    rank_f = torch.cumsum(1 - m, 0) - 1 + n_true
    pos = torch.where(mask, rank_t, rank_f)
    k = min(k, mask.shape[0])
    out = torch.zeros(k + 1, dtype=torch.int64, device=mask.device)
    out.scatter_(0, torch.where(pos < k, pos, k),
                 torch.arange(mask.shape[0], device=mask.device))
    out = out[:k]
    return out, mask[out]


def free_slots_device(valid_mask: torch.Tensor, n: int) -> torch.Tensor:
    """Device-side alloc_slots: first n free slot indices, −1 padded (int32),
    no host sync."""
    idx, free = first_members(~valid_mask, n)
    out = torch.where(free, idx, -1).to(torch.int32)
    return torch.nn.functional.pad(out, (0, n - out.shape[0]), value=-1)


def mark(n: int, idx: torch.Tensor) -> torch.Tensor:
    """(n,) bool, true at the (1-d) indices idx.  `index_fill_` takes the
    value as a scalar: `x[idx] = True` would first copy a one-element
    tensor from the host, which blocks the host on the card."""
    return torch.zeros(n, dtype=torch.bool, device=idx.device).index_fill_(0, idx, True)


def membership_matrix(state: MapState) -> torch.Tensor:
    """(K, P) bool: KF k observes point p (O(K·P): small maps and tests)."""
    K, F = state.kf_feat_pt.shape
    P = state.pt_pos.shape[0]
    pt = state.kf_feat_pt.long()
    ok = (pt >= 0) & state.kf_feat_valid
    kf_idx = torch.arange(K, device=pt.device)[:, None]
    M = mark(K * (P + 1), (kf_idx * (P + 1) + torch.where(ok, pt, P)).reshape(-1))
    return M.reshape(K, P + 1)[:, :P] & state.kf_valid[:, None] & state.pt_valid[None, :]


def _obs_ok(state: MapState) -> torch.Tensor:
    """(K, F) bool: feature slot holds a live observation of a live point."""
    pt = state.kf_feat_pt
    return ((pt >= 0) & state.kf_feat_valid & state.kf_valid[:, None]
            & state.pt_valid[torch.clamp_min(pt, 0).long()])


def _obs_targets(state: MapState, ok: torch.Tensor) -> torch.Tensor:
    """(K·F,) int64 point slot of each live observation, P (dump) elsewhere."""
    P = state.pt_pos.shape[0]
    return torch.where(ok, state.kf_feat_pt.long(), P).reshape(-1)


def point_mask_of(state: MapState, kf_mask: torch.Tensor) -> torch.Tensor:
    """(P,) bool: points observed by any KF in `kf_mask` (O(K·F))."""
    P = state.pt_pos.shape[0]
    ok = _obs_ok(state) & kf_mask[:, None]
    return mark(P + 1, _obs_targets(state, ok))[:P]


def point_obs_counts(state: MapState) -> torch.Tensor:
    """(P,) int32 number of observing keyframes per point (O(K·F))."""
    P = state.pt_pos.shape[0]
    ok = _obs_ok(state)
    out = torch.zeros(P + 1, dtype=torch.int32, device=ok.device)
    out.scatter_add_(0, _obs_targets(state, ok), ok.reshape(-1).to(torch.int32))
    return out[:P]


def point_obs_counts_weighted(state: MapState) -> torch.Tensor:
    """(P,) int32 observation count with stereo observations counted twice
    (reference `MapPoint::AddObservation`, `MapPoint.cc:100-108`)."""
    P = state.pt_pos.shape[0]
    ok = _obs_ok(state)
    w = torch.where(state.kf_ur >= 0, 2, 1).to(torch.int32)
    out = torch.zeros(P + 1, dtype=torch.int32, device=ok.device)
    out.scatter_add_(0, _obs_targets(state, ok),
                     torch.where(ok, w, 0).reshape(-1).to(torch.int32))
    return out[:P]


def kf_sees_mask(state: MapState, pt_mask: torch.Tensor) -> torch.Tensor:
    """(K,) bool: KFs observing at least one point in `pt_mask` (O(K·F))."""
    ok = _obs_ok(state)
    hits = ok & pt_mask[torch.clamp_min(state.kf_feat_pt, 0).long()]
    return torch.any(hits, dim=1)
