"""Oriented BRIEF descriptors + the full ORB extraction pipeline.

Counterpart of `dsp_slam_rgbd_tpu/frontend/orb.py` (reference
`ORBextractor`, `src/ORBextractor.cc`): intensity-centroid orientation
over the circular 31x31 patch (`IC_Angle` :78), 256-bit rotated BRIEF on
the JAX package's seeded Gaussian pattern (`computeOrbDescriptor` :109),
and the per-level pipeline pyramid -> FAST -> orientation -> blur ->
descriptors of `operator()` :1044-1118, keypoints scaled to level 0.

Descriptors are (N, 8) int32 tensors holding the bits of the JAX
package's uint32 words (torch's uint32 has almost no CUDA ops).

Two numeric choices keep the card and the CPU on the same bits:
  * the orientation moments sum in f64 over the gathered patch and the
    angle rounds once to f32 (the JAX package's integral-image sums are
    f32 and agree with it to ~1e-6 rad);
  * each keypoint's cos and sin are taken in f64 and rounded once to f32,
    then the pattern rotates in f32 one operation at a time, as the JAX
    package does.  A rotated offset that lands near a half pixel would
    round to another sample on a 1-ulp cos.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from dsp_slam_rgbd_tpu_torch import device as device_mod
from dsp_slam_rgbd_tpu_torch.frontend import fast, pyramid

PATCH_R = 15  # half-size of the orientation/descriptor patch (31x31)
N_BITS = 256


def _circular_mask_and_coords():
    y, x = np.mgrid[-PATCH_R: PATCH_R + 1, -PATCH_R: PATCH_R + 1]
    mask = (x * x + y * y) <= PATCH_R * PATCH_R
    return mask.astype(np.float32), x.astype(np.float32), y.astype(np.float32)


_MASK, _XC, _YC = _circular_mask_and_coords()


def make_brief_pattern(seed: int = 7, n_bits: int = N_BITS, sigma: float = 6.2,
                       r_max: float = 13.0) -> np.ndarray:
    """(n_bits, 4) int offsets (y1, x1, y2, x2), Gaussian-sampled and clipped
    to radius r_max so any in-plane rotation stays inside the 31x31 patch."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, sigma, size=(n_bits, 2, 2))
    norm = np.linalg.norm(pts, axis=-1, keepdims=True)
    pts = np.where(norm > r_max, pts * (r_max / norm), pts)
    return np.round(pts.reshape(n_bits, 4)).astype(np.float32)


_PATTERN = make_brief_pattern()  # (256, 4) as (y1, x1, y2, x2)


@functools.lru_cache(maxsize=None)
def _device_consts(device: torch.device):
    """(pattern, x·mask, y·mask) on `device`, copied there once: a copy
    from host memory per call would block the host each time."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in (_PATTERN, _XC * _MASK, _YC * _MASK))


def _round_xy(xy: torch.Tensor):
    return (torch.round(xy[:, 0]).to(torch.int64),
            torch.round(xy[:, 1]).to(torch.int64))


def gather_patches(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Extract (K, 31, 31) patches centered at integer keypoint coords
    (zero outside the image; starts clamped like `lax.dynamic_slice`)."""
    size = 2 * PATCH_R + 1
    padded = torch.nn.functional.pad(img, (PATCH_R,) * 4)
    hp, wp = padded.shape
    x, y = _round_xy(xy)
    off = torch.arange(size, device=img.device)
    y0 = torch.clamp(y, 0, hp - size)
    x0 = torch.clamp(x, 0, wp - size)
    return padded[(y0[:, None] + off)[:, :, None], (x0[:, None] + off)[:, None, :]]


def orientations(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle per patch (radians), reference `IC_Angle`."""
    _, xm, ym = _device_consts(patches.device)
    xm, ym = xm.to(patches.dtype), ym.to(patches.dtype)
    m10 = torch.sum(patches * xm, dim=(-2, -1))
    m01 = torch.sum(patches * ym, dim=(-2, -1))
    return torch.atan2(m01, m10)


def _rotated_pattern(angles: torch.Tensor):
    """Pattern offsets rotated by each angle (x' = x cosθ − y sinθ,
    y' = x sinθ + y cosθ, reference :109), nearest sample: four (K, 256)
    int64 tensors ry1, rx1, ry2, rx2."""
    a = angles.double()
    c, s = torch.cos(a).float()[:, None], torch.sin(a).float()[:, None]
    pat = _device_consts(angles.device)[0]
    out = []
    for yo, xo in ((pat[:, 0], pat[:, 1]), (pat[:, 2], pat[:, 3])):
        xr = torch.round(xo[None, :] * c - yo[None, :] * s)
        yr = torch.round(xo[None, :] * s + yo[None, :] * c)
        out += [yr.to(torch.int64), xr.to(torch.int64)]
    return out


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(K, 256) bool -> (K, 8) int32 words, bit i of word j = bit 32j+i
    (the bits of the JAX package's uint32 words)."""
    words = bits.reshape(-1, 8, 32).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) \
        << torch.arange(32, device=bits.device)
    v = torch.sum(words * weights, dim=-1)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def descriptors(patches: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotated BRIEF: (K, 31, 31) patches + (K,) angles -> (K, 8) int32."""
    ry1, rx1, ry2, rx2 = _rotated_pattern(angles)
    k = torch.arange(patches.shape[0], device=patches.device)[:, None]
    i1 = patches[k, ry1 + PATCH_R, rx1 + PATCH_R]
    i2 = patches[k, ry2 + PATCH_R, rx2 + PATCH_R]
    return _pack_bits(i1 < i2)


def moment_angles(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angles at keypoints: `orientations` of the
    gathered patches with the moments summed in f64 (see the module
    docstring), rounded once to f32."""
    return orientations(gather_patches(img, xy).double()).float()


def descriptors_flat(img: torch.Tensor, xy: torch.Tensor,
                     angles: torch.Tensor) -> torch.Tensor:
    """Rotated BRIEF straight from the (blurred) image: one flat gather of
    the 512 pattern samples per keypoint instead of 31x31 patches (equal
    to `descriptors(gather_patches(img, xy), angles)` for in-image
    keypoints; zero padding outside, flat indices clipped)."""
    ry1, rx1, ry2, rx2 = _rotated_pattern(angles)
    padded = torch.nn.functional.pad(img, (PATCH_R,) * 4)
    w_pad = padded.shape[1]
    flat = padded.reshape(-1)
    x, y = _round_xy(xy)
    x0 = x[:, None] + PATCH_R
    y0 = y[:, None] + PATCH_R
    hi = flat.numel() - 1
    i1 = flat[torch.clamp((y0 + ry1) * w_pad + (x0 + rx1), 0, hi)]
    i2 = flat[torch.clamp((y0 + ry2) * w_pad + (x0 + rx2), 0, hi)]
    return _pack_bits(i1 < i2)


class Features(NamedTuple):
    xy: torch.Tensor      # (N, 2) level-0 pixel coords [x, y]
    level: torch.Tensor   # (N,) int32 pyramid level
    angle: torch.Tensor   # (N,) radians
    score: torch.Tensor   # (N,) FAST score
    desc: torch.Tensor    # (N, 8) int32 packed 256-bit descriptors
    valid: torch.Tensor   # (N,) bool

    @property
    def n(self):
        return self.xy.shape[0]


class OrbConfig(NamedTuple):
    n_features: int = 2000
    n_levels: int = 8
    scale: float = 1.2
    fast_threshold: float = 20.0
    fast_min_threshold: float = 7.0
    cell: int = 16


def upload(a, device) -> torch.Tensor:
    """A host array (or tensor) on `device`.  To the card it goes through
    pinned memory without blocking the host (a copy from pageable memory
    waits for the device)."""
    dev = device_mod.resolve(device)
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def to_image(img, device="cuda") -> torch.Tensor:
    """A (H, W) image as an f32 tensor.  Host arrays go to `device` in
    their own dtype (uint8 images move 1 byte a pixel) and are cast there;
    tensors stay where they are."""
    if not isinstance(img, torch.Tensor):
        img = upload(img, device)
    return img if img.dtype == torch.float32 else img.float()


def extract(img, cfg: OrbConfig = OrbConfig(), device="cuda") -> Features:
    """Full ORB extraction on a (H, W) [0, 255] image (see `to_image`)."""
    img = to_image(img, device)
    levels = pyramid.build_pyramid(img, cfg.n_levels, cfg.scale)
    alloc = pyramid.per_level_features(cfg.n_features, cfg.n_levels, cfg.scale)

    outs = []
    for l, (img_l, n_l) in enumerate(zip(levels, alloc)):
        if n_l <= 0:
            continue
        xy, score, valid = fast.detect(
            img_l, n_l, cfg.cell, cfg.fast_threshold, cfg.fast_min_threshold)
        blurred = pyramid.gaussian_blur(img_l)
        ang = moment_angles(img_l, xy)
        desc = descriptors_flat(blurred, xy, ang)
        s = cfg.scale ** l
        outs.append(Features(
            xy=xy * s,
            level=torch.full((n_l,), l, dtype=torch.int32, device=img.device),
            angle=ang, score=score, desc=desc, valid=valid))
    return Features(*[torch.cat([getattr(o, f) for o in outs], dim=0)
                      for f in Features._fields])


def extract_pair(img_a, img_b, cfg: OrbConfig = OrbConfig(), device="cuda"):
    """ORB extraction for a stereo pair (each image on its own)."""
    return extract(img_a, cfg, device), extract(img_b, cfg, device)
