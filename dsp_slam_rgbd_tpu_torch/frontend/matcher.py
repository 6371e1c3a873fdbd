"""Descriptor matching: dense Hamming distances + the reference's gating.

Counterpart of `dsp_slam_rgbd_tpu/frontend/matcher.py` (reference
`ORBmatcher`): one dense (N, M) Hamming matrix plus boolean masks, the best
match with best/second-best ratio, mutual cross-check and the
rotation-consistency histogram.  Descriptors are (·, 8) int32 words.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from dsp_slam_rgbd_tpu_torch.frontend.fast import top_k_stable

TH_HIGH = 100
TH_LOW = 50
HISTO_BINS = 30


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (SWAR).  int32 shifts are arithmetic, so
    every right shift is masked before its bits are used."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F    # bytes hold counts <= 8: x >= 0 now
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(N, 8) x (M, 8) int32 -> (N, M) int32 Hamming distances, accumulated
    word by word (no (N, M, 8) intermediate)."""
    d = torch.zeros(desc_a.shape[0], desc_b.shape[0], dtype=torch.int32,
                    device=desc_a.device)
    for w in range(desc_a.shape[1]):
        d += popcount32(desc_a[:, w, None] ^ desc_b[None, :, w])
    return d


class Matches(NamedTuple):
    idx: torch.Tensor    # (N,) best match in B for each A (or -1)
    dist: torch.Tensor   # (N,) Hamming distance of best match
    valid: torch.Tensor  # (N,) bool


def match(desc_a, valid_a, desc_b, valid_b, mask=None, max_dist=TH_LOW,
          ratio=1.0, mutual=True, angles_a=None, angles_b=None,
          check_rotation=False) -> Matches:
    """Best-match search with the reference's gates.

    mask: optional (N, M) bool of admissible pairs.  ratio: best < ratio ·
    second-best (reference mfNNratio).  mutual: B's best must be A.
    check_rotation: keep only matches in the 3 dominant angle-difference
    histogram bins (reference `ComputeThreeMaxima`, HISTO_LENGTH=30).
    """
    n = desc_a.shape[0]
    d = hamming_matrix(desc_a, desc_b)
    pair_ok = valid_a[:, None] & valid_b[None, :]
    if mask is not None:
        pair_ok = pair_ok & mask
    big = 1 << 15
    d = torch.where(pair_ok, d, big)

    best = torch.argmin(d, dim=1)        # first minimum
    best_d = torch.gather(d, 1, best[:, None])[:, 0]
    rows = torch.arange(n, device=d.device)
    second_d = torch.amin(d.scatter(1, best[:, None], big), dim=1)

    ok = (best_d <= max_dist) & (best_d < ratio * second_d.float())

    if mutual:
        best_b = torch.argmin(d, dim=0)  # (M,) best A for each B
        ok = ok & (best_b[best] == rows)

    if check_rotation and angles_a is not None:
        # entries with a non-finite angle are exempt from the gate and kept
        # out of the histogram
        ang_b = angles_b[best]
        has_ang = torch.isfinite(angles_a) & torch.isfinite(ang_b)
        two_pi = 2.0 * math.pi
        rot = (angles_a - torch.where(has_ang, ang_b, 0.0)) % two_pi
        # a true division, the same bits on the card and the CPU
        bins = torch.floor(rot / torch.full_like(rot, two_pi) * HISTO_BINS).to(torch.int64)
        bins = torch.clamp(bins, 0, HISTO_BINS - 1)
        hist = torch.zeros(HISTO_BINS, dtype=torch.int32, device=d.device)
        hist.scatter_add_(0, bins, (ok & has_ang).to(torch.int32))
        top_v, top_i = top_k_stable(hist, 3)
        # ComputeThreeMaxima (ORBmatcher.cc:1444-1470): the 2nd and 3rd bins
        # are dropped when they hold < 0.1x the dominant bin
        keep = (top_v.float() >= 0.1 * top_v[0].float()) \
            | (torch.arange(3, device=d.device) == 0)
        top_i = torch.where(keep, top_i, -1)
        in_top = torch.any(bins[:, None] == top_i[None, :], dim=1)
        ok = ok & (in_top | ~has_ang)

    return Matches(torch.where(ok, best, -1), best_d, ok)


def radius_mask(xy_a, xy_b, radius):
    """(N, 2), (M, 2) -> (N, M) pairs within pixel radius; radius scalar or
    (N,) per query."""
    d2 = torch.sum((xy_a[:, None, :] - xy_b[None, :, :]) ** 2, dim=-1)
    if not torch.is_tensor(radius):
        return d2 <= float(radius) ** 2   # no host-to-device copy
    r = radius.to(d2.dtype)
    r2 = (r ** 2)[..., None] if r.ndim == 1 else r ** 2
    return d2 <= r2


def level_band_mask(level_a, level_b, band=1):
    """Scale consistency: |level_a − level_b| ≤ band."""
    return torch.abs(level_a[:, None] - level_b[None, :]) <= band
