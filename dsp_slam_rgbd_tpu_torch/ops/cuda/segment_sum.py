"""The fixed-order scatter-add kernel (`csrc/segment_sum.cu`) and its plain
version.

It replaces no TPU kernel: it makes the card's scatter-adds sum in the
CPU's order, so that the port's SLAM loop gives the same bits on every
run, as the JAX package's does.  `ops/scatter.py` builds the sorted
permutation and the segment offsets it reads, and routes the CPU to
`index_add_`.

Routing: `launch` takes CUDA tensors only and raises on a failed launch;
nothing falls back.  `segment_sum_plain` computes the kernel's sums in the
kernel's order with tensor ops on any device: the k-th row of every
segment is added in turn, onto `out`.
"""
from __future__ import annotations

import torch

from dsp_slam_rgbd_tpu_torch.ops.cuda import build

# launches since the last reset; the plain version counts none
LAUNCHES = {"segment_sum": 0}
_FN = {torch.float32: "segment_sum_f32", torch.float64: "segment_sum_f64"}


def reset_launch_counts() -> None:
    LAUNCHES["segment_sum"] = 0


def _check(out, perm, offsets, src):
    if out.dtype not in _FN or src.dtype != out.dtype:
        raise ValueError(f"segment_sum takes float32 or float64 out and src of one type; got "
                         f"{out.dtype}, {src.dtype}")
    if perm.dtype != torch.int64 or offsets.dtype != torch.int64:
        raise ValueError(f"perm and offsets must be int64; got {perm.dtype}, {offsets.dtype}")
    if src.shape[1:] != out.shape[1:] or perm.shape != src.shape[:1] \
            or offsets.shape != (out.shape[0] + 1,):
        raise ValueError(f"shapes do not match: out {tuple(out.shape)}, src {tuple(src.shape)}, "
                         f"perm {tuple(perm.shape)}, offsets {tuple(offsets.shape)}")
    if len({t.device for t in (out, perm, offsets, src)}) != 1:
        raise ValueError("out, src, perm and offsets must be on one device")
    if not all(t.is_contiguous() for t in (out, perm, offsets, src)):
        raise ValueError("out, src, perm and offsets must be contiguous")


def launch(out: torch.Tensor, perm: torch.Tensor, offsets: torch.Tensor,
           src: torch.Tensor) -> torch.Tensor:
    """out[t] += src[perm[offsets[t]:offsets[t+1]]] summed in that order, in
    place, by the kernel on the current stream.  CUDA tensors only."""
    _check(out, perm, offsets, src)
    if out.device.type != "cuda":
        raise ValueError(f"the segment_sum kernel takes CUDA tensors; got {out.device}")
    if src.shape[0] == 0 or out.numel() == 0:
        return out
    elems = out.numel() // out.shape[0]
    lib = build.load()
    err = getattr(lib, _FN[out.dtype])(out.data_ptr(), src.data_ptr(), perm.data_ptr(),
                                       offsets.data_ptr(), out.shape[0], elems,
                                       torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_sum launch failed: CUDA error {err} "
                           f"({lib.mlp_sdf_error_string(err).decode()})")
    LAUNCHES["segment_sum"] += 1
    return out


def segment_sum_plain(out: torch.Tensor, perm: torch.Tensor, offsets: torch.Tensor,
                      src: torch.Tensor) -> torch.Tensor:
    """The kernel's sums in the kernel's order, in place: for k = 0, 1, ...
    every segment longer than k adds its k-th row onto out (one target at
    most once a step, so each add is one rounding).  One host read."""
    _check(out, perm, offsets, src)
    counts = offsets[1:] - offsets[:-1]
    longest = int(counts.max()) if counts.numel() else 0
    targets = torch.arange(out.shape[0], device=out.device)
    for k in range(longest):
        t = targets[counts > k]
        out[t] = out[t] + src[perm[offsets[t] + k]]
    return out
