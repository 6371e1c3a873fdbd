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

  * several scatters in one call (`scatter_adds`, and the kernel's order
    for it, `segment_sum_table_plain`) equal the same `index_add_` calls in
    sequence, bit for bit: several scatters onto one output, several
    outputs, +0.0 starts with signed-zero sources, empty segments, kept
    rows and a 600-row segment, in f32 and f64;
  * the plan (int32 sort, `segment_offsets`) equals the old int64 sort,
    count and prefix sum.

The card's kernels are held to these on the card by the `-m cuda` test
here (`pytest --noconftest -m cuda tests/test_torch_scatter.py`) and to
`index_add_` by chip_smoke.py.
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


# ------------------------------------------------- several scatters a launch
TABLE_CASES = ["one_output", "outputs", "signed_zeros", "empty", "kept_rows", "long_segment"]


def _table_case(name: str, rng, dtype):
    """[(n, [(idx, keep, src), ...]), ...]: outputs, each with its scatters in
    table order."""
    def src(rows, trailing):
        shape = (rows,) + trailing
        return torch.from_numpy(rng.standard_normal(shape)
                                * 10.0 ** rng.uniform(-3, 3, shape)).to(dtype)

    def rand(n, rows, trailing, keep=None):
        return torch.from_numpy(rng.integers(0, n, rows)), keep, src(rows, trailing)

    if name == "one_output":   # three scatters onto one output, as the PCG's y_edge
        return [(40, [rand(40, 300, (6,)), rand(40, 20, (6,)), rand(40, 20, (6,))])]
    if name == "outputs":      # as the assembly: several outputs, one or more scatters each
        return [(12, [rand(12, 200, (6, 6)), rand(12, 9, (6, 6))]),
                (12, [rand(12, 200, (6,)), rand(12, 9, (6,))]),
                (30, [rand(30, 200, (3, 3))]), (360, [rand(360, 200, (6, 3))]),
                (17, [rand(17, 50, (7, 7)), rand(17, 50, (7, 7))]), (5, [rand(5, 8, ())])]
    if name == "signed_zeros":  # +0.0 start: -0.0 sources give +0.0, as onto zeros
        idx = torch.from_numpy(rng.integers(0, 6, 40))
        z = torch.zeros(40, 3, dtype=dtype)
        neg = -z
        mixed = torch.where(torch.from_numpy(rng.uniform(size=(40, 3)) < 0.5), z, neg)
        return [(6, [(idx, None, neg)]), (6, [(idx, None, mixed), (idx, None, neg)]),
                (6, [(idx, None, src(40, (3,)) * 0.0)])]
    if name == "empty":        # no rows at all, and targets without rows
        return [(8, [(torch.zeros(0, dtype=torch.int64), None, src(0, (3,)))]),
                (50, [(torch.from_numpy(rng.integers(0, 5, 30)), None, src(30, (3,))),
                      (torch.from_numpy(rng.integers(45, 50, 30)), None, src(30, (3,)))])]
    if name == "kept_rows":    # plans with `keep`: a dump row and a fifth of the rest left out
        idx = torch.from_numpy(np.where(np.arange(300) < 60, rng.integers(0, 19, 300), 19))
        keep = torch.from_numpy((idx.numpy() < 19) & (rng.uniform(size=300) > 0.2))
        return [(20, [(idx, keep, src(300, (6,))), rand(20, 40, (6,))])]
    if name == "long_segment":  # 600 rows onto one target, beside short ones
        idx = torch.from_numpy(np.where(rng.uniform(size=900) < 2 / 3, 3, rng.integers(0, 9, 900)))
        return [(9, [(idx, None, src(900, (6, 6))), rand(9, 40, (6, 6))]),
                (9, [(idx, None, src(900, ())), (idx, None, src(900, ()))])]
    raise ValueError(name)


def _sequence(outputs):
    """The CPU's index_add_ calls in table order, onto zeros."""
    outs = []
    for n, adds in outputs:
        out = torch.zeros((n,) + tuple(adds[0][2].shape[1:]), dtype=adds[0][2].dtype)
        for idx, keep, src in adds:
            out = _index_add(out, idx, src, keep)
        outs.append(out)
    return outs


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", TABLE_CASES)
def test_several_scatters_equal_index_add_in_sequence(name, dtype):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    outputs = _table_case(name, rng, dtype)
    want = _sequence(outputs)
    if name == "long_segment":
        assert max(int(torch.bincount(idx).max()) for _, adds in outputs
                   for idx, _, _ in adds) >= 600
    plans = [(n, [(scatter.plan(idx, n, keep), src) for idx, keep, src in adds])
             for n, adds in outputs]
    got = scatter.scatter_adds(*((n, *adds) for n, adds in plans))
    # the kernel's order: the plain table, each output's first scatter from +0.0
    outs = [torch.full((n,) + tuple(adds[0][1].shape[1:]), float("nan"), dtype=dtype)
            for n, adds in plans]
    segment_sum.segment_sum_table_plain(
        [(o, p.perm, p.offsets, s.contiguous(), i == 0)
         for o, (_, adds) in zip(outs, plans) for i, (p, s) in enumerate(adds)])
    for w, g, o in zip(want, got, outs):
        np.testing.assert_array_equal(_bits(g), _bits(w))
        np.testing.assert_array_equal(_bits(o), _bits(w))
    if name == "signed_zeros":
        assert not torch.signbit(torch.cat([w.reshape(-1) for w in want])).any()


def test_scatter_adds_takes_one_dtype():
    p = scatter.plan(torch.tensor([0, 1]), 2)
    with pytest.raises(ValueError, match="one dtype"):
        scatter.scatter_adds((2, (p, torch.ones(2))), (2, (p, torch.ones(2, dtype=torch.float64))))
    with pytest.raises(ValueError, match="targets"):
        scatter.scatter_adds((3, (p, torch.ones(2))))


def _old_plan(idx, n, keep):
    """The plan as it was built before: an int64 sort, a count by
    `index_add_` and its prefix sum."""
    idx = idx.reshape(-1).long()
    key = idx if keep is None else torch.where(keep.reshape(-1), idx, n)
    perm = torch.sort(key, stable=True).indices
    counts = torch.zeros(n + 2, dtype=torch.int64)
    counts.index_add_(0, key + 1, torch.ones_like(key))
    return perm, torch.cumsum(counts, 0)[:n + 1]


@pytest.mark.parametrize("kind", ["random", "heavy", "heavy_kept", "sparse_kept", "empty"])
def test_plan_equals_the_old_construction(kind):
    rng = np.random.default_rng(zlib.crc32(kind.encode()))
    n, rows, keep = 5000, 20000, None
    if kind == "random":
        idx = rng.integers(0, n, rows)
    elif kind.startswith("heavy"):   # most rows onto a few targets
        idx = np.where(rng.uniform(size=rows) < 0.9, rng.integers(0, 3, rows),
                       rng.integers(0, n, rows))
        if kind == "heavy_kept":
            keep = torch.from_numpy(rng.uniform(size=rows) < 0.5)
    elif kind == "sparse_kept":      # the normals' way: 54 rows of 20,000 kept
        idx = rng.integers(0, n, rows)
        keep = torch.zeros(rows, dtype=torch.bool)
        keep[torch.from_numpy(rng.choice(rows, 54, replace=False))] = True
    else:
        idx = np.zeros(0, np.int64)
    idx = torch.from_numpy(idx)
    p = scatter.plan(idx, n, keep)
    perm, offsets = _old_plan(idx, n, keep)
    np.testing.assert_array_equal(p.perm.numpy(), perm.numpy())
    np.testing.assert_array_equal(p.offsets.numpy(), offsets.numpy())
    # the offsets of int64 keys (n + 1 >= 2^31 sorts int64) are the same
    keys = torch.sort(torch.where(keep, idx, n) if keep is not None else idx).values
    np.testing.assert_array_equal(segment_sum.segment_offsets(keys, n).numpy(), offsets.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_equals_its_plain_version_on_the_card(dtype):
    """The segment-sum kernel (several scatters a target, targets across two
    blocks, hot targets; from +0.0 in one launch and in place from out's
    value) and the offsets kernel against the CPU's route, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    for name in TABLE_CASES + ["hot"]:
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        if name == "hot":   # 200,000 rows onto two targets, scalars and 3-vectors
            idx = torch.from_numpy(rng.integers(0, 2, 200_000))
            outputs = [(2, [(idx, None, torch.from_numpy(rng.standard_normal(200_000)).to(dtype))]),
                       (2, [(idx, None, torch.from_numpy(
                           rng.standard_normal((200_000, 3))).to(dtype))])]
        else:
            outputs = _table_case(name, rng, dtype)
        want = _sequence(outputs)
        plans = [(n, [(scatter.plan(idx.to(dev), n, None if keep is None else keep.to(dev)),
                       src.to(dev)) for idx, keep, src in adds]) for n, adds in outputs]
        for n, adds in plans:
            for p, _ in adds:
                ref = scatter.plan(p.idx.cpu(), n, None if p.keep is None else p.keep.cpu())
                assert torch.equal(p.perm.cpu(), ref.perm) and torch.equal(p.offsets.cpu(),
                                                                           ref.offsets)
        got = scatter.scatter_adds(*((n, *adds) for n, adds in plans))
        torch.cuda.synchronize()
        for w, g in zip(want, got):
            np.testing.assert_array_equal(_bits(g.cpu()), _bits(w))
        # in place, from out's value: one launch a scatter
        for (n, adds), (_, cpu_adds) in zip(plans, outputs):
            out0 = torch.from_numpy(rng.standard_normal(
                (n,) + tuple(adds[0][1].shape[1:]))).to(dtype)
            on_card, on_cpu = out0.to(dev), out0.clone()
            for (p, src), (idx, keep, src_cpu) in zip(adds, cpu_adds):
                scatter.index_add(on_card, p, src)
                on_cpu = _index_add(on_cpu, idx, src_cpu, keep)
            np.testing.assert_array_equal(_bits(on_card.cpu()), _bits(on_cpu))


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
