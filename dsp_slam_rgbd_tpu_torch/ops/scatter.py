"""Scatter-adds that sum in one fixed order on every device.

Every floating-point additive scatter of the port goes through `index_add`,
`scatter_add` or `scatter_adds`.  On the CPU they are
`out.index_add_(0, idx, src)` calls, which add the source rows in their
order.  On the card `index_add_` adds with atomics, in an order that
changes from run to run, so two runs of the SLAM loop on the same inputs
would drift apart; there the calls run `csrc/segment_sum.cu`, which adds
each target's rows in source order too, and gives the CPU's bits.
`scatter_adds` runs several scatters, onto one output or several, in one
launch (up to 16), summed as the same calls in sequence would be.

The kernel reads a `ScatterPlan`: the indices' stable sort and each
target's segment of it.  A plan depends only on the indices, so a loop
whose indices stay fixed (the LM and CG iterations of BA, the pose
graph's) builds it once, before the loop, and each scatter inside stays
one launch.  A plan may also leave out rows whose every contribution is
known to be zero (`keep`): the padding of a capacity bucket, or a dump
target nobody reads, which would otherwise make one long serial segment.
A plan checks its own tensors when it is built, and each (out, src) shape
it meets once (`seen`); after that a call reads pointers and launches.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from dsp_slam_rgbd_tpu_torch.ops.cuda import segment_sum


class ScatterPlan(NamedTuple):
    """Where each of the rows `idx` goes among `n` targets."""
    idx: torch.Tensor       # (N,) int64 target of each source row
    perm: torch.Tensor      # (N,) int64: the kept rows by target, in source order, then the rest
    offsets: torch.Tensor   # (n + 1,) int64: target t's rows are perm[offsets[t]:offsets[t+1]]
    n: int
    keep: torch.Tensor | None = None   # (N,) bool: the rows summed (None: all)
    seen: set | None = None            # the (out, src) signatures checked against the plan

    def to(self, device) -> "ScatterPlan":
        return ScatterPlan(*(t.to(device) if isinstance(t, torch.Tensor) else t
                             for t in self[:5]), seen=set())


def plan(idx: torch.Tensor, n: int, keep: torch.Tensor | None = None) -> ScatterPlan:
    """The plan of a scatter of len(idx) rows onto n targets (0 <= idx < n),
    summing only the rows where `keep` (default: all).  A stable sort of the
    targets (int32 keys where n + 1 < 2^31: half the radix passes of int64),
    then one launch that cuts the sorted keys into segments: exact, and no
    host read."""
    idx = idx.reshape(-1).long()
    key = idx if keep is None else torch.where(keep.reshape(-1), idx, n)   # left out: last
    if n + 1 < 2 ** 31:
        key = key.int()
    keys, perm = torch.sort(key, stable=True)
    offsets = segment_sum.segment_offsets(keys, n)
    if perm.shape != idx.shape or offsets.shape != (n + 1,) or perm.device != offsets.device:
        raise ValueError(f"a plan of {tuple(idx.shape)} rows onto {n} targets came out with "
                         f"perm {tuple(perm.shape)}, offsets {tuple(offsets.shape)}")
    return ScatterPlan(idx, perm, offsets, n, None if keep is None else keep.reshape(-1), set())


def _checked(out: torch.Tensor, p: ScatterPlan, src: torch.Tensor) -> torch.Tensor:
    """src, contiguous, once `segment_sum.check` has passed the call's
    shapes, types and devices against the plan (once a signature)."""
    src = src.contiguous()
    sig = (out.shape, out.dtype, src.shape, src.dtype, out.get_device(), src.get_device())
    if p.seen is None or sig not in p.seen:
        segment_sum.check(out, p.perm, p.offsets, src)
        if p.seen is not None:
            p.seen.add(sig)
    return src


def _index_add_cpu(out, p, src):
    if p.keep is None:
        return out.index_add_(0, p.idx, src)
    rows = p.keep.nonzero()[:, 0]
    return out.index_add_(0, p.idx[rows], src[rows])


def index_add(out: torch.Tensor, p: ScatterPlan, src: torch.Tensor) -> torch.Tensor:
    """out[idx[i]] += src[i] for every kept row i of the plan
    `p = plan(idx, out.shape[0], keep)`, in source order, in place; returns
    out.  A CPU tensor runs `index_add_`; a CUDA tensor launches the
    segment-sum kernel (or raises)."""
    if p.n != out.shape[0]:
        raise ValueError(f"the plan has {p.n} targets; out has {out.shape[0]} rows")
    if out.device.type == "cpu":
        return _index_add_cpu(out, p, src)
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    segment_sum.launch_table([(out, p.perm, p.offsets, _checked(out, p, src), False)])
    return out


def scatter_add(n: int, p: ScatterPlan, src: torch.Tensor) -> torch.Tensor:
    """(n, ...) zeros with src's rows added at their targets (`index_add`)."""
    return scatter_adds((n, (p, src)))[0]


def scatter_adds(*outputs) -> tuple[torch.Tensor, ...]:
    """New outputs, each `(n, (plan, src), (plan, src), ...)`: (n, ...) zeros
    with each src's kept rows added at their plan's targets, one scatter
    after the other, as `index_add` calls in that order would give.  On the
    card: one launch for the lot (one a 16 scatters); on the CPU: the
    `index_add_` calls in sequence."""
    outs, table = [], []
    src0 = outputs[0][1][1]
    for n, *adds in outputs:
        src = adds[0][1]
        if src.dtype != src0.dtype or src.device != src0.device:
            raise ValueError(f"scatter_adds takes sources of one dtype on one device; got "
                             f"{src0.dtype} on {src0.device} and {src.dtype} on {src.device}")
        out = torch.empty((n,) + tuple(src.shape[1:]), dtype=src.dtype, device=src.device)
        outs.append(out)
        for i, (p, src) in enumerate(adds):
            if p.n != n:
                raise ValueError(f"the plan has {p.n} targets; out has {n} rows")
            if out.device.type == "cpu":
                if i == 0:
                    out.zero_()
                _index_add_cpu(out, p, src)
            else:
                table.append((out, p.perm, p.offsets, _checked(out, p, src), i == 0))
    if table:
        segment_sum.launch_table(table)
    return tuple(outs)
