"""Image pyramid + Gaussian blur.

Counterpart of `dsp_slam_rgbd_tpu/frontend/pyramid.py` (reference
`ORBextractor::ComputePyramid`, 8 levels at scale 1.2, and the 7x7
sigma=2 blur before descriptors).

Each level is the JAX package's `jax.image.resize(..., "linear")`, which
antialiases when it downscales: per axis a triangle kernel widened by
1/scale, normalized over the taps inside the image (`scale_and_translate`).
The weight matrices are built in f32 with JAX's own operation order, then
applied as two matmuls that accumulate in f64 and round once to f32.  The
single rounding makes a level the same on the card and on the CPU (an f32
matmul sums in another order on each, and a level that moves by 1e-5
shifts FAST scores and flips keypoint ties); it stays within 1e-5 of the
JAX package's f32 einsum.  FAST itself stays f32.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def level_shapes(h: int, w: int, n_levels: int = 8, scale: float = 1.2):
    """Static (h, w) per pyramid level."""
    shapes = []
    for l in range(n_levels):
        inv = 1.0 / (scale ** l)
        shapes.append((max(int(round(h * inv)), 16), max(int(round(w * inv)), 16)))
    return shapes


@functools.lru_cache(maxsize=None)
def _resize_matrix(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """`_resize_weights` in f64, built once per size and device."""
    return _resize_weights(n_in, n_out, device).double()


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) f32 weights of an antialiased linear resize, in the
    operation order of JAX's `compute_weight_mat`."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    f32 = torch.float32
    sample_f = (torch.arange(n_out, dtype=f32, device=device) + 0.5) * inv_scale - 0.5
    # a true division (on the card `tensor / scalar` multiplies by the
    # reciprocal, one rounding more than on the CPU)
    x = torch.abs(sample_f[None, :] - torch.arange(n_in, dtype=f32, device=device)[:, None])
    x = x / torch.full_like(x, kernel_scale)
    weights = torch.clamp_min(1.0 - torch.abs(x), 0.0)
    # the f64 sum of the few taps is exact, so the card and the CPU agree
    total = torch.sum(weights.double(), dim=0, keepdim=True).float()
    weights = torch.where(
        torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def resize_linear(img: torch.Tensor, shape) -> torch.Tensor:
    """(H, W) f32 -> `shape` by the antialiased linear resize above."""
    h, w = img.shape
    lh, lw = shape
    x = img.double()
    if lh != h:
        x = _resize_matrix(h, lh, img.device).T @ x
    if lw != w:
        x = x @ _resize_matrix(w, lw, img.device)
    return x.float()


def build_pyramid(img: torch.Tensor, n_levels: int = 8, scale: float = 1.2):
    """img (H, W) float32 -> list of (h_l, w_l) tensors."""
    h, w = img.shape
    out = [img]
    for shape in level_shapes(h, w, n_levels, scale)[1:]:
        out.append(resize_linear(img, shape))
    return out


def gaussian_kernel(size: int = 7, sigma: float = 2.0) -> np.ndarray:
    x = np.arange(size) - (size - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _reflect_pad(x: torch.Tensor, pad: int, dim: int) -> torch.Tensor:
    """numpy "reflect" (cv BORDER_REFLECT_101) padding along one axis."""
    n = x.shape[dim]
    idx = torch.arange(-pad, n + pad, device=x.device).abs()
    idx = torch.where(idx >= n, 2 * (n - 1) - idx, idx)
    return x.index_select(dim, idx)


def gaussian_blur(img: torch.Tensor, size: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur with reflect padding (cv::GaussianBlur
    BORDER_REFLECT_101 role).  Each axis is a sum of shifted copies, one
    f32 multiply and add per tap in a fixed order: the same bits on the
    card and on the CPU."""
    k = gaussian_kernel(size, sigma)
    pad = size // 2
    h, w = img.shape
    x = _reflect_pad(img, pad, 0)
    acc = x[0:h] * float(k[size - 1])
    for i in range(1, size):
        acc = acc + x[i:i + h] * float(k[size - 1 - i])
    x = _reflect_pad(acc, pad, 1)
    acc = x[:, 0:w] * float(k[size - 1])
    for i in range(1, size):
        acc = acc + x[:, i:i + w] * float(k[size - 1 - i])
    return acc


def per_level_features(n_features: int, n_levels: int = 8, scale: float = 1.2):
    """Split a feature budget over levels with the reference's geometric
    allocation (`ORBextractor.cc` constructor: nDesired·(1−1/s)/(1−(1/s)^L)
    per level, remainder to the top level)."""
    factor = 1.0 / scale
    n_first = n_features * (1 - factor) / (1 - factor ** n_levels)
    alloc = []
    acc = 0
    for l in range(n_levels - 1):
        n = int(round(n_first * factor ** l))
        alloc.append(n)
        acc += n
    alloc.append(max(n_features - acc, 0))
    return alloc
