"""Dense FAST-9/16 corner detection with score, NMS and per-cell selection.

Counterpart of `dsp_slam_rgbd_tpu/frontend/fast.py` (reference per-cell
cv::FAST + quad-tree redistribution, `src/ORBextractor.cc:810-815`): the
16-pixel ring test runs densely over the image, the score is the largest
threshold for which the pixel stays a corner, 3x3 non-max suppression, the
best corner per cell, then the global top-K cells by score.  Everything is
exact f32 min/max arithmetic; ties between equal scores go to the lower
index, as `jax.lax.top_k` and `argmax` order them.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle of radius 3: 16 (dy, dx) offsets in ring order
RING = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)


def _ring_stack(img: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (16, H, W): ring pixel values at each position (zero-padded
    borders; border pixels are masked out by callers)."""
    padded = F.pad(img, (3, 3, 3, 3))
    h, w = img.shape
    return torch.stack(
        [padded[3 + dy: 3 + dy + h, 3 + dx: 3 + dx + w] for dy, dx in RING.tolist()]
    )


def fast_score(img: torch.Tensor, threshold: float, arc_len: int = 9):
    """Dense FAST: returns (score (H, W) float32, is_corner (H, W) bool).

    A pixel is a corner if some `arc_len` contiguous ring pixels are all
    brighter than center+t or all darker than center−t.  Score is the
    largest t' for which the test still passes (0 when not a corner).
    """
    d = _ring_stack(img) - img[None]  # signed differences
    # contiguous arcs over the circular ring axis: a sliding window view
    d2 = torch.cat([d, d[: arc_len - 1]], dim=0)  # (16+8, H, W)
    arcs = d2.unfold(0, arc_len, 1)               # (16, H, W, arc_len)
    score_bright = arcs.amin(-1).amax(0)
    score_dark = (-arcs.amax(-1)).amax(0)
    score = torch.maximum(score_bright, score_dark)
    is_corner = score > threshold

    # exclude 3px border
    h, w = img.shape
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    interior = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    return torch.where(interior, score, 0.0), is_corner & interior


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression mask (−inf outside the image)."""
    neigh = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return score >= neigh


def top_k_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis, equal
    values in index order (the order `jax.lax.top_k` gives; `torch.topk`
    promises none)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def detect(img: torch.Tensor, max_kp: int, cell: int = 16,
           threshold: float = 20.0, min_threshold: float = 7.0):
    """Detect up to max_kp corners: per-cell best (two-threshold fallback à
    la the reference's ini/min FAST thresholds) then global top-K.

    Returns (xy (K, 2) float32 [x, y], score (K,), valid (K,) bool).
    """
    h, w = img.shape
    # the score is threshold-independent, so one dense pass serves both
    score_lo, corner_lo = fast_score(img, min_threshold)
    corner_hi = score_lo > threshold
    keep = nms3(score_lo)

    ch, cw = -(-h // cell), -(-w // cell)
    ph, pw = ch * cell - h, cw * cell - w

    def cellify(a):
        a = F.pad(a, (0, pw, 0, ph))
        return a.reshape(ch, cell, cw, cell).permute(0, 2, 1, 3).reshape(
            ch * cw, cell * cell)

    s_hi = cellify(torch.where(corner_hi & keep, score_lo, 0.0))
    s_lo = cellify(torch.where(corner_lo & keep, score_lo, 0.0))
    # low-threshold corners only in cells where no high-threshold one survived
    cell_has_hi = torch.any(s_hi > 0.0, dim=1, keepdim=True)
    s = torch.where(cell_has_hi, s_hi, s_lo)

    best_in_cell = torch.argmax(s, dim=1)  # first maximum
    best_score = torch.gather(s, 1, best_in_cell[:, None])[:, 0]

    k = min(max_kp, s.shape[0])
    top_score, top_cell = top_k_stable(best_score, k)
    valid = top_score > 0.0

    cy = top_cell // cw
    cx = top_cell % cw
    iy = best_in_cell[top_cell] // cell
    ix = best_in_cell[top_cell] % cell
    # integer positions, like the reference's cv::FAST
    y = (cy * cell + iy).float()
    x = (cx * cell + ix).float()
    xy = torch.stack([x, y], dim=-1)

    if k < max_kp:
        pad = max_kp - k
        xy = torch.cat([xy, xy.new_zeros(pad, 2)], dim=0)
        top_score = torch.cat([top_score, top_score.new_zeros(pad)], dim=0)
        valid = torch.cat([valid, valid.new_zeros(pad)], dim=0)
    return xy, top_score, valid
