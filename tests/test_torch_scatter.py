"""The fixed-order scatter-add (`ops/scatter.py`, `ops/cuda/segment_sum.py`).

  * `plan` against numpy's stable argsort and bincount offsets;
  * the kernel's order, emulated by `segment_sum_plain` (the k-th row of
    every segment added in turn onto out), equals the CPU's
    `index_add_` bit for bit: random duplicates at magnitudes 1e-3 to 1e3,
    trailing shapes (), (3,), (6, 3) and (6, 6), a dump row, an empty
    index, every row onto one target, a plan reused across calls, and a
    plan that keeps only some rows (against `index_add_` over those);
  * no floating-point additive scatter of local BA, `global_ba_pcg`,
    `correct_loop` (the pose graph), `update_point_geometry` or
    `bow_vector` bypasses `ops/scatter.py` (a `TorchFunctionMode` sweep).

The card's kernel itself is held to `index_add_` by chip_smoke.py.
"""
from __future__ import annotations

import os
import sys
import zlib

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from dsp_slam_rgbd_tpu_torch.loop import loop_closing, vocabulary
from dsp_slam_rgbd_tpu_torch.mapping import ba
from dsp_slam_rgbd_tpu_torch.mapping import local_mapping as lm
from dsp_slam_rgbd_tpu_torch.mapping import pose_graph
from dsp_slam_rgbd_tpu_torch.ops import camera as cam_ops
from dsp_slam_rgbd_tpu_torch.ops import scatter
from dsp_slam_rgbd_tpu_torch.ops.cuda import segment_sum
from dsp_slam_rgbd_tpu_torch.tools import corridor_map, revisit_map
from dsp_slam_rgbd_tpu_torch.weights import map_state_from_numpy

TRAILING = [(), (3,), (6, 3), (6, 6)]


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.numpy()
    return a.view(np.int64 if a.dtype == np.float64 else np.int32)


CASES = ["random", "dump_row", "empty", "one_target", "kept_rows"]


def _case(name: str, rng, trailing, dtype=torch.float32):
    """(n targets, idx, src, out, keep or None) of one named case."""
    n, rows = 40, 600
    keep = None
    if name == "random":
        idx = rng.integers(0, n, rows)
    elif name in ("dump_row", "kept_rows"):   # every row past the first 100 onto row n - 1
        idx = np.where(np.arange(rows) < 100, rng.integers(0, n - 1, rows), n - 1)
        if name == "kept_rows":   # the dump row's rows left out, and a fifth of the others
            keep = torch.from_numpy((idx < n - 1) & (rng.uniform(size=rows) > 0.2))
    elif name == "empty":
        idx = np.zeros(0, np.int64)
    elif name == "one_target":
        idx = np.full(rows, 7)
    else:
        raise ValueError(name)
    shape = (len(idx),) + tuple(trailing)
    # magnitudes 1e-3 .. 1e3 and both signs: sums whose order shows in the bits
    src = rng.standard_normal(shape) * 10.0 ** rng.uniform(-3, 3, shape)
    out = rng.standard_normal((n,) + tuple(trailing))
    return n, torch.from_numpy(idx), torch.from_numpy(src).to(dtype), \
        torch.from_numpy(out).to(dtype), keep


@pytest.mark.parametrize("name", CASES)
def test_plan_matches_numpy(name):
    rng = np.random.default_rng(0)
    n, idx, _, _, keep = _case(name, rng, ())
    p = scatter.plan(idx.to(torch.int32), n, keep)
    assert p.n == n and p.idx.dtype == p.perm.dtype == p.offsets.dtype == torch.int64
    i = idx.numpy()
    kept = np.ones(len(i), bool) if keep is None else keep.numpy()
    rows = np.nonzero(kept)[0]
    # the kept rows by target in source order, then the others in source order
    order = np.concatenate([rows[np.argsort(i[rows], kind="stable")], np.nonzero(~kept)[0]])
    np.testing.assert_array_equal(p.perm.numpy(), order)
    offsets = np.concatenate([[0], np.cumsum(np.bincount(i[rows], minlength=n))])
    np.testing.assert_array_equal(p.offsets.numpy(), offsets)


def _index_add(out, idx, src, keep):
    """The CPU's index_add_ over the kept rows, in source order."""
    rows = slice(None) if keep is None else keep.nonzero()[:, 0]
    return out.clone().index_add_(0, idx[rows], src[rows])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("trailing", TRAILING, ids=str)
@pytest.mark.parametrize("name", CASES)
def test_kernel_order_equals_index_add(name, trailing, dtype):
    rng = np.random.default_rng(zlib.crc32(repr((name, trailing)).encode()))
    n, idx, src, out, keep = _case(name, rng, trailing, dtype)
    want = _index_add(out, idx, src, keep)
    p = scatter.plan(idx, n, keep)
    got = segment_sum.segment_sum_plain(out.clone(), p.perm, p.offsets, src)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(scatter.index_add(out.clone(), p, src)), _bits(want))
    # the plan reused: new sources, and onto the first call's result
    src2 = torch.flip(src, [0]) * 3.0
    want2 = _index_add(want, idx, src2, keep)
    segment_sum.segment_sum_plain(got, p.perm, p.offsets, src2)
    np.testing.assert_array_equal(_bits(got), _bits(want2))
    np.testing.assert_array_equal(_bits(scatter.scatter_add(n, p, src2)),
                                  _bits(_index_add(torch.zeros_like(out), idx, src2, keep)))


def test_the_order_shows_in_the_bits():
    """The cases above would catch another order: summing each segment in
    reverse gives other bits."""
    rng = np.random.default_rng(1)
    n, idx, src, out, _ = _case("random", rng, (3,))
    p = scatter.plan(idx, n)
    rev = scatter.plan(torch.flip(idx, [0]), n)
    a = segment_sum.segment_sum_plain(out.clone(), p.perm, p.offsets, src)
    b = segment_sum.segment_sum_plain(out.clone(), rev.perm, rev.offsets, torch.flip(src, [0]))
    assert (_bits(a) != _bits(b)).any()


def test_wrong_inputs_raise():
    idx = torch.tensor([0, 2, 2])
    src = torch.ones(3, 2)
    p = scatter.plan(idx, 3)
    with pytest.raises(ValueError, match="targets"):
        scatter.index_add(torch.zeros(4, 2), p, src)
    with pytest.raises(ValueError, match="CUDA"):
        segment_sum.launch(torch.zeros(3, 2), p.perm, p.offsets, src)
    with pytest.raises(ValueError, match="float32 or float64"):
        segment_sum.launch(torch.zeros(3, 2, dtype=torch.int32), p.perm, p.offsets,
                           src.int())
    with pytest.raises(ValueError, match="shapes"):
        segment_sum.segment_sum_plain(torch.zeros(3, 3), p.perm, p.offsets, src)


# ----------------------------------------------------------------- the sweep
SCATTER_SRC = os.path.join("dsp_slam_rgbd_tpu_torch", "ops", "scatter.py")
ADDITIVE = {"index_add", "index_add_", "scatter_add", "scatter_add_", "put", "put_",
            "index_put", "index_put_", "scatter_reduce", "scatter_reduce_", "bincount",
            "histc"}


def _additive_float(name, args, kwargs):
    """Whether the call is a floating-point additive scatter."""
    def arg(i, key, default=None):
        return args[i] if len(args) > i else kwargs.get(key, default)

    if name in ("index_put", "index_put_", "put", "put_") and not arg(3, "accumulate", False):
        return False
    if name.startswith("scatter_reduce") and arg(3, "reduce") not in ("sum", "mean"):
        return False
    if name == "bincount":
        w = arg(1, "weights")
        return w is not None and w.is_floating_point()
    if name == "histc":
        return True
    target = args[0] if args else kwargs.get("input")
    return isinstance(target, torch.Tensor) and target.is_floating_point()


class _Sweep(TorchFunctionMode):
    """Records every floating-point additive scatter called from outside
    ops/scatter.py, with its caller."""

    def __init__(self):
        super().__init__()
        self.bypass, self.planned = [], 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in ADDITIVE and _additive_float(name, args, kwargs):
            caller = sys._getframe(1)
            where = f"{caller.f_code.co_filename}:{caller.f_lineno}"
            if caller.f_code.co_filename.endswith(SCATTER_SRC):
                self.planned += 1
            else:
                self.bypass.append(f"{name} at {where}")
        return func(*args, **kwargs)


def test_no_float_scatter_add_bypasses_ops_scatter():
    torch.manual_seed(0)
    fields, _, _ = corridor_map.build_corridor_map(n_kf=12, n_pts=600, feat_per_kf=60,
                                                   noise=0.2, max_kf=16, max_pts=1024)
    corridor = map_state_from_numpy(fields, "cpu")
    rv, _ = revisit_map.build_revisit_state(np.random.default_rng(0))
    revisit = map_state_from_numpy(rv, "cpu")
    rcam = cam_ops.Intrinsics(*revisit_map.SMALL_CAM, bf=40.0)
    word_ids = torch.tensor([3, 1, -1, 3, 0, 7], dtype=torch.int32)
    sweep = _Sweep()
    with sweep:
        # the catch itself: an unplanned float index_add_ is seen
        torch.zeros(2).index_add_(0, torch.tensor([1, 1]), torch.ones(2))
        assert len(sweep.bypass) == 1
        sweep.bypass.clear()
        prob, _ = lm.build_local_ba_problem(corridor, 6, 4)
        ba.local_ba(corridor_map.CAM, prob, stage1_iters=1, stage2_iters=1)
        gprob, _ = lm.build_local_ba_problem(corridor, 0, 0, global_window=True)
        ba.global_ba_pcg(corridor_map.CAM, gprob, n_iters=2, cg_iters=4)
        lm.local_ba_and_cull_step(corridor, corridor_map.CAM, 6, max_kfs=4)
        lm.update_point_geometry(revisit)
        loop_closing.correct_loop(revisit, rcam, 5, 0, torch.eye(4), pg_iters=2)
        K = 4
        pose_graph.optimize_pose_graph(
            torch.eye(4).repeat(K, 1, 1), torch.ones(K, dtype=torch.bool),
            torch.arange(K) == 0, torch.tensor([0, 1, 2]), torch.tensor([1, 2, 3]),
            torch.eye(4).repeat(3, 1, 1), torch.ones(3, dtype=torch.bool), n_iters=2)
        vocabulary.bow_vector(word_ids, 8)
    assert sweep.bypass == [], sweep.bypass
    assert sweep.planned > 0
