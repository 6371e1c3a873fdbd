"""Scatter-adds that sum in one fixed order on every device.

Every floating-point additive scatter of the port goes through
`index_add`.  On the CPU it is `out.index_add_(0, idx, src)`, which adds
the source rows in their order.  On the card `index_add_` adds with
atomics, in an order that changes from run to run, so two runs of the
SLAM loop on the same inputs would drift apart; there `index_add` runs
`csrc/segment_sum.cu`, which adds each target's rows in source order too,
and gives the CPU's bits.

The kernel reads a `ScatterPlan`: the indices' stable sort and each
target's segment of it.  A plan depends only on the indices, so a loop
whose indices stay fixed (the LM and CG iterations of BA, the pose
graph's) builds it once, before the loop, and each scatter inside stays
one launch.  A plan may also leave out rows whose every contribution is
known to be zero (`keep`): the padding of a capacity bucket, or a dump
target nobody reads, which would otherwise make one long serial segment.
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

    def to(self, device) -> "ScatterPlan":
        return ScatterPlan(*(t.to(device) if isinstance(t, torch.Tensor) else t for t in self))


def plan(idx: torch.Tensor, n: int, keep: torch.Tensor | None = None) -> ScatterPlan:
    """The plan of a scatter of len(idx) rows onto n targets (0 <= idx < n),
    summing only the rows where `keep` (default: all).  Integer sort,
    count and prefix sum: exact, and no host read."""
    idx = idx.reshape(-1).long()
    key = idx if keep is None else torch.where(keep.reshape(-1), idx, n)   # left out: last
    perm = torch.sort(key, stable=True).indices
    counts = torch.zeros(n + 2, dtype=torch.int64, device=idx.device)
    counts.index_add_(0, key + 1, torch.ones_like(key))
    return ScatterPlan(idx, perm, torch.cumsum(counts, 0)[:n + 1], n,
                       None if keep is None else keep.reshape(-1))


def index_add(out: torch.Tensor, p: ScatterPlan, src: torch.Tensor) -> torch.Tensor:
    """out[idx[i]] += src[i] for every kept row i of the plan
    `p = plan(idx, out.shape[0], keep)`, in source order, in place; returns
    out.  A CPU tensor runs `index_add_`; a CUDA tensor launches the
    segment-sum kernel (or raises)."""
    if p.n != out.shape[0]:
        raise ValueError(f"the plan has {p.n} targets; out has {out.shape[0]} rows")
    if out.device.type == "cpu":
        if p.keep is None:
            return out.index_add_(0, p.idx, src)
        rows = p.keep.nonzero()[:, 0]
        return out.index_add_(0, p.idx[rows], src[rows])
    return segment_sum.launch(out, p.perm, p.offsets, src.contiguous())


def scatter_add(n: int, p: ScatterPlan, src: torch.Tensor) -> torch.Tensor:
    """(n, ...) zeros with src's rows added at their targets (`index_add`)."""
    out = torch.zeros((n,) + tuple(src.shape[1:]), dtype=src.dtype, device=src.device)
    return index_add(out, p, src)
