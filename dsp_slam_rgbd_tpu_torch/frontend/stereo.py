"""Stereo matching and RGB-D depth synthesis.

Counterpart of `dsp_slam_rgbd_tpu/frontend/stereo.py` (reference
`Frame::ComputeStereoMatches`, `src/Frame.cc:467-620`, and
`ComputeStereoFromRGBD`): a row-band mask over the dense Hamming matrix,
subpixel refinement by a sliding-window SAD parabola over gathered
(K, 2w+1, 2w+1+2L) strips, and the median-SAD outlier gate.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from dsp_slam_rgbd_tpu_torch.frontend import matcher
from dsp_slam_rgbd_tpu_torch.ops.camera import rdiv


class StereoMatches(NamedTuple):
    u_right: torch.Tensor  # (N,) right x-coordinate (subpixel), −1 if none
    depth: torch.Tensor    # (N,) z = bf / disparity, −1 if none
    valid: torch.Tensor    # (N,) bool


def _windows(img: torch.Tensor, y0, x0, h: int, w: int) -> torch.Tensor:
    """(K, h, w) windows of `img` at top-left (y0, x0), starts clamped into
    the image like `lax.dynamic_slice`."""
    H, W = img.shape
    y0 = torch.clamp(y0, 0, H - h)
    x0 = torch.clamp(x0, 0, W - w)
    oy = torch.arange(h, device=img.device)
    ox = torch.arange(w, device=img.device)
    return img[(y0[:, None] + oy)[:, :, None], (x0[:, None] + ox)[:, None, :]]


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """`jnp.nanmedian` of a 1-d tensor, on the device: the two middle values
    of the sorted non-NaN entries weighted as JAX's linear quantile does (an
    even count gives their mean; `torch.nanmedian` gives the lower one).
    NaN when every entry is NaN."""
    s = torch.sort(x).values   # NaNs sort last
    n = torch.sum(~torch.isnan(x)).float()
    q = 0.5 * (n - 1.0)
    low, high = torch.floor(q), torch.ceil(q)
    hw = q - low
    lw = 1.0 - hw
    low = torch.clamp(torch.minimum(low, n - 1), min=0).long()
    high = torch.clamp(torch.minimum(high, n - 1), min=0).long()
    # gathers: a 0-d index tensor would be read on the host
    return s.gather(0, low[None])[0] * lw + s.gather(0, high[None])[0] * hw


def match_stereo(feats_l, feats_r, img_l, img_r, bf: float,
                 min_z: float, row_band: float = 2.0, max_disp: float = None,
                 sad_win: int = 5, sad_search: int = 5) -> StereoMatches:
    """Match left keypoints to right keypoints along epipolar rows.

    min_z: minimum depth (= baseline in the reference, `Frame.cc:487`);
    max_disp = bf / min_z.
    """
    if max_disp is None:
        max_disp = bf / min_z
    xl, yl = feats_l.xy[:, 0], feats_l.xy[:, 1]
    xr, yr = feats_r.xy[:, 0], feats_r.xy[:, 1]

    # row band scales with octave (reference: 2 * scale of right kp)
    scale_r = 1.2 ** feats_r.level.float()
    band = row_band * scale_r[None, :]
    row_ok = torch.abs(yl[:, None] - yr[None, :]) <= band
    disp = xl[:, None] - xr[None, :]
    disp_ok = (disp >= -1.0) & (disp <= max_disp)
    lvl_ok = matcher.level_band_mask(feats_l.level, feats_r.level, 1)

    # (TH_HIGH+TH_LOW)/2 is the reference's thOrbDist (`Frame.cc:509`)
    m = matcher.match(
        feats_l.desc, feats_l.valid, feats_r.desc, feats_r.valid,
        mask=row_ok & disp_ok & lvl_ok,
        max_dist=(matcher.TH_HIGH + matcher.TH_LOW) // 2,
        ratio=0.9, mutual=True,
    )

    # ---- subpixel refinement by SAD parabola (reference :530-590) ----
    w = sad_win
    L = sad_search
    pad = w + L + 1
    pl = F.pad(img_l, (pad,) * 4)
    pr = F.pad(img_r, (pad,) * 4)

    x_r0 = torch.where(m.valid, xr[torch.clamp(m.idx, min=0)], 0.0)
    yi = torch.round(yl).long() + pad
    xi_l = torch.round(xl).long() + pad
    xi_r = torch.round(x_r0).long() + pad
    patch_l = _windows(pl, yi - w, xi_l - w, 2 * w + 1, 2 * w + 1)
    patch_l = patch_l - patch_l[:, w:w + 1, w:w + 1]
    strip_r = _windows(pr, yi - w, xi_r - w - L, 2 * w + 1, 2 * w + 1 + 2 * L)
    wins = strip_r.unfold(2, 2 * w + 1, 1)           # (K, rows, 2L+1, cols)
    wins = wins - wins[:, w:w + 1, :, w:w + 1]
    sads = torch.sum(torch.abs(patch_l[:, :, None, :] - wins), dim=(1, 3))

    k = torch.argmin(sads, dim=1)
    ref_ok = (k > 0) & (k < 2 * L)
    km = torch.clamp(k, 1, 2 * L - 1)
    d1 = torch.gather(sads, 1, (km - 1)[:, None])[:, 0]
    d0 = torch.gather(sads, 1, km[:, None])[:, 0]
    d2 = torch.gather(sads, 1, (km + 1)[:, None])[:, 0]
    denom = torch.clamp_min(d1 + d2 - 2.0 * d0, 1e-6)
    delta = torch.clamp((d1 - d2) / (2.0 * denom), -1.0, 1.0)
    u_r = x_r0 + (km.float() - L) + delta

    disparity = xl - u_r
    ok = m.valid & ref_ok & (disparity > 0.0) & (disparity <= max_disp)
    # median-SAD outlier rejection (reference `Frame.cc:595-620`)
    med = nanmedian(torch.where(ok, d0, torch.nan))
    ok = ok & torch.where(torch.isfinite(med), d0 <= 1.5 * 1.4 * med, True)
    u_r = torch.where(ok, u_r, -1.0)
    depth = torch.where(ok, rdiv(bf, torch.clamp_min(disparity, 1e-6)), -1.0)
    return StereoMatches(u_r, depth, ok)


def depth_to_stereo(feats, depth_map: torch.Tensor, bf: float,
                    depth_scale: float = 1.0) -> StereoMatches:
    """RGB-D: read z at each keypoint; uR = u − bf/z (reference
    `ComputeStereoFromRGBD`)."""
    x = torch.clamp(torch.round(feats.xy[:, 0]).long(), 0, depth_map.shape[1] - 1)
    y = torch.clamp(torch.round(feats.xy[:, 1]).long(), 0, depth_map.shape[0] - 1)
    z = depth_map[y, x] * depth_scale
    ok = feats.valid & (z > 0.0)
    u_r = torch.where(ok, feats.xy[:, 0] - rdiv(bf, torch.clamp_min(z, 1e-6)), -1.0)
    return StereoMatches(u_r, torch.where(ok, z, -1.0), ok)
