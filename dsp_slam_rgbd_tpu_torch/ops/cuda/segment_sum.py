"""The fixed-order scatter-add kernel (`csrc/segment_sum.cu`) and its plain
versions.

It replaces no TPU kernel: it makes the card's scatter-adds sum in the
CPU's order, so that the port's SLAM loop gives the same bits on every
run, as the JAX package's does.  `ops/scatter.py` builds the sorted
permutation and the segment offsets it reads (`segment_offsets`, a kernel
of the same source), checks each call site once, and routes the CPU to
`index_add_`.

A launch takes a table of up to MAX_TABLE scatters, each a tuple
`(out, perm, offsets, src, zero)`: out[t] += src[perm[offsets[t]:offsets[t+1]]]
in that order, starting from out's value, or from +0.0 where `zero` is set
(only an output's first scatter in the table may set it).  Scatters onto
one output are summed in table order, as the same calls in sequence would;
no src may be another scatter's out.

Routing: `launch_table` and `launch` take CUDA tensors only and raise on a
failed launch; nothing falls back.  The plain versions compute the same
sums in the same order with tensor ops on any device.
"""
from __future__ import annotations

import ctypes

import torch

from dsp_slam_rgbd_tpu_torch.ops.cuda import build

# launches since the last reset (the plain versions count none), and the
# scatters the segment-sum launches carried
LAUNCHES = {"segment_sum": 0, "segment_offsets": 0}
SCATTERS = {"segment_sum": 0}
MAX_TABLE = 16   # csrc/segment_sum.cu's kMaxDesc
_SUM = {torch.float32: "segment_sum_table_f32", torch.float64: "segment_sum_table_f64"}
_OFFSETS = {torch.int32: "segment_offsets_i32", torch.int64: "segment_offsets_i64"}
_fn: dict = {}   # the library's entry points, looked up at the first launch


def reset_launch_counts() -> None:
    for d in (LAUNCHES, SCATTERS):
        for k in d:
            d[k] = 0


def check(out, perm, offsets, src):
    """Raise unless (out, perm, offsets, src) is one scatter the kernel takes."""
    if out.dtype not in _SUM or src.dtype != out.dtype:
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


def _entry(name):
    fn = _fn.get(name)
    if fn is None:
        fn = _fn[name] = getattr(build.load(), name)
    return fn


def _raise(err, what):
    msg = _entry("mlp_sdf_error_string")(err).decode()
    raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def launch_table(table) -> None:
    """Run the scatters of `table` (tuples (out, perm, offsets, src, zero),
    each passed by `check`, all of one dtype, on one card) in one launch a
    MAX_TABLE of them, on the current stream.  Reads pointers and launches:
    the caller has checked the table."""
    out0 = table[0][0]
    stream = torch._C._cuda_getCurrentRawStream(out0.get_device())
    fn = _entry(_SUM[out0.dtype])
    for i in range(0, len(table), MAX_TABLE):
        part = table[i:i + MAX_TABLE]
        vals = []
        for out, perm, offsets, src, zero in part:
            n = out.shape[0]
            vals += (out.data_ptr(), src.data_ptr(), perm.data_ptr(), offsets.data_ptr(), n,
                     out.numel() // n if n else 0, int(zero), src.shape[0])
        err = fn((ctypes.c_int64 * len(vals))(*vals), len(part), stream)
        if err != 0:
            _raise(err, "segment_sum")
        LAUNCHES["segment_sum"] += 1
        SCATTERS["segment_sum"] += len(part)


def launch(out: torch.Tensor, perm: torch.Tensor, offsets: torch.Tensor,
           src: torch.Tensor, zero: bool = False) -> torch.Tensor:
    """out[t] += src[perm[offsets[t]:offsets[t+1]]] summed in that order (from
    +0.0 with `zero`), in place, by the kernel on the current stream.  CUDA
    tensors only."""
    check(out, perm, offsets, src)
    if out.device.type != "cuda":
        raise ValueError(f"the segment_sum kernel takes CUDA tensors; got {out.device}")
    launch_table([(out, perm, offsets, src, zero)])
    return out


def segment_sum_plain(out: torch.Tensor, perm: torch.Tensor, offsets: torch.Tensor,
                      src: torch.Tensor) -> torch.Tensor:
    """The kernel's sums in the kernel's order, in place: for k = 0, 1, ...
    every segment longer than k adds its k-th row onto out (one target at
    most once a step, so each add is one rounding).  One host read."""
    check(out, perm, offsets, src)
    counts = offsets[1:] - offsets[:-1]
    longest = int(counts.max()) if counts.numel() else 0
    targets = torch.arange(out.shape[0], device=out.device)
    for k in range(longest):
        t = targets[counts > k]
        out[t] = out[t] + src[perm[offsets[t] + k]]
    return out


def segment_sum_table_plain(table) -> None:
    """`launch_table`'s sums with `segment_sum_plain`, the scatters in table
    order, an output set to +0.0 before a scatter with `zero`."""
    for out, perm, offsets, src, zero in table:
        if zero:
            out.zero_()
        segment_sum_plain(out, perm, offsets, src)


def segment_offsets(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(n + 1,) int64: offsets[t] = the first position of the sorted `keys`
    (int32 or int64, ascending) holding a key >= t; keys >= n sort last and
    belong to no target.  A CPU tensor takes `segment_offsets_plain`; a CUDA
    tensor launches the kernel (or raises)."""
    if keys.device.type == "cpu":
        return segment_offsets_plain(keys, n)
    if keys.dtype not in _OFFSETS or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError(f"segment_offsets takes contiguous 1-d int32 or int64 keys; got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    offsets = torch.empty(n + 1, dtype=torch.int64, device=keys.device)
    err = _entry(_OFFSETS[keys.dtype])(keys.data_ptr(), keys.shape[0], n, offsets.data_ptr(),
                                        torch._C._cuda_getCurrentRawStream(keys.get_device()))
    if err != 0:
        _raise(err, "segment_offsets")
    LAUNCHES["segment_offsets"] += 1
    return offsets


def segment_offsets_plain(keys: torch.Tensor, n: int) -> torch.Tensor:
    """`segment_offsets` by a binary search of every target."""
    return torch.searchsorted(keys, torch.arange(n + 1, dtype=keys.dtype, device=keys.device))
