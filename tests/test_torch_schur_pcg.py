"""The global BA's CG loop (`ops/cuda/schur_pcg.py`, `csrc/schur_pcg.cu`).

On the CPU:
  * `_pcg_gn_step` through the wrapper (CPU tensors: the plain versions)
    equals, bit for bit, the op-by-op step that `mapping/ba.py` ran before
    its CG loop and edge sums moved into the wrapper (frozen below as
    `_parent_step`), on tests/test_torch_ba.py's 24-keyframe
    corridor and on that corridor with object edges, a fixed keyframe, an
    invalid object and dead points;
  * with a `group`, CPU tensors take the op-by-op path, all_reduces and all
    (`dist.psum` stubbed here: one process); the layout `edges` gives the
    blocks (by their device alone) is what routes every entry point;
  * `LAUNCHES` stays 0 on the CPU;
  * the wrapper raises on operands on another device, of another dtype
    or of another shape, and the edge sums on such a vector; float64 runs
    the plain version.

On the card (`pytest --noconftest -m cuda tests/test_torch_schur_pcg.py`;
this file imports no JAX): the kernels' `_pcg_gn_step` within 1e-4 of the
plain version's on the same card (poses and points; the cost, computed
before the loop, within 1e-5 relative: test_pcg_step_matches_jax's
tolerances), `global_ba_pcg` within 5e-3, two runs equal bit for bit, at
most 4 launches a CG step, the edge sums within 1e-5 of their plain
versions (relative to the largest), and float32 only; with a `group`
(`dist.psum` stubbed: one rank's sum is the identity) the kernels' host
loop, 1 + 4 launches a CG step with the point sums and then the pose
side's sums all-reduced, gives the group-less solve's bits, and so does
`_pcg_gn_step`.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from dsp_slam_rgbd_tpu_torch.mapping import ba
from dsp_slam_rgbd_tpu_torch.mapping import local_mapping as lm
from dsp_slam_rgbd_tpu_torch.ops import scatter
from dsp_slam_rgbd_tpu_torch.ops.cuda import schur_pcg
from dsp_slam_rgbd_tpu_torch.tools import corridor_map
from dsp_slam_rgbd_tpu_torch.weights import (ba_problem_from_numpy, ba_problem_to_numpy,
                                             map_state_from_numpy)

CAM = corridor_map.CAM


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rot(w):
    """Rodrigues: the rotation of the small axis-angle vector w."""
    th = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / max(th, 1e-12)
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


def _with_objects(fields):
    """The corridor problem with three objects observed by nearby keyframes
    (object 1 invalid), two object edges masked out, keyframe 5 fixed and
    every 37th point dead."""
    rng = np.random.default_rng(20)
    f = {k: np.array(v) for k, v in fields.items()}
    O, M = f["obj_pose"].shape[0], f["oobs_kf"].shape[0]
    assert O >= 3 and M >= 16
    centers = -np.einsum("kji,kj->ki", f["kf_pose"][:, :3, :3], f["kf_pose"][:, :3, 3])
    obj = np.tile(np.eye(4, dtype=np.float32), (O, 1, 1))
    seen = {0: range(3, 8), 1: range(9, 12), 2: range(14, 19)}
    for j, kfs in seen.items():
        obj[j, :3, :3] = _rot(0.3 * rng.standard_normal(3))
        obj[j, :3, 3] = centers[kfs[len(kfs) // 2]] + [1.5, 0.2, 4.0]
    edges = [(k, j) for j, kfs in seen.items() for k in kfs]
    edges += [(2, 0), (20, 2)]   # masked out below
    assert len(edges) <= M
    f["obj_pose"] = obj
    f["obj_valid"] = np.arange(O) < 3
    f["obj_valid"][1] = False
    oobs_kf, oobs_obj = np.zeros(M, np.int32), np.zeros(M, np.int32)
    t_co = np.tile(np.eye(4, dtype=np.float32), (M, 1, 1))
    mask = np.zeros(M, bool)
    for m, (k, j) in enumerate(edges):
        T = f["kf_pose"][k].astype(np.float64) @ obj[j].astype(np.float64)
        T[:3, :3] = _rot(0.02 * rng.standard_normal(3)) @ T[:3, :3]
        T[:3, 3] += 0.05 * rng.standard_normal(3)
        oobs_kf[m], oobs_obj[m], t_co[m], mask[m] = k, j, T, m < len(edges) - 2
    f.update(oobs_kf=oobs_kf, oobs_obj=oobs_obj, oobs_t_co=t_co, oobs_mask=mask)
    f["kf_fixed"][5] = True
    dead = np.unique(f["obs_pt"][f["obs_mask"]])[::37]
    f["pt_valid"][dead] = False
    return f


@pytest.fixture(scope="module")
def problems():
    """{name: numpy fields of a BA problem}: tests/test_torch_ba.py's
    corridor, and it with objects, a fixed keyframe and dead points."""
    fields, _, _ = corridor_map.build_corridor_map(n_kf=24, n_pts=2000, feat_per_kf=120,
                                                   noise=0.2, max_kf=32, max_pts=4096)
    prob, _ = lm.build_local_ba_problem(map_state_from_numpy(fields, "cpu"), 0, 0,
                                        global_window=True)
    base = ba_problem_to_numpy(prob)
    return {"corridor": base, "objects": _with_objects(base)}


def _parent_step(cam, prob, damping, cg_iters):
    """`mapping/ba.py::_pcg_gn_step` (without a group) as it ran before its
    CG loop and edge sums moved into `ops/cuda/schur_pcg.py`: op by op,
    with the module's unchanged helpers."""
    plans = ba._pcg_plans(prob)
    K, P, O = prob.kf_pose.shape[0], prob.pts.shape[0], prob.obj_pose.shape[0]
    B = K + O
    obs_kf, obs_pt = prob.obs_kf.long(), prob.obs_pt.long()
    res, Jc, Jp, _ = ba._reproj_terms(cam, prob)
    chi2, w = ba._edge_weights(prob, res)
    Ccc = torch.einsum("ndi,ndj,n->nij", Jc, Jc, w)
    Cpp = torch.einsum("ndi,ndj,n->nij", Jp, Jp, w)
    Ccp = torch.einsum("ndi,ndj,n->nij", Jc, Jp, w)
    gc = torch.einsum("ndi,nd,n->ni", Jc, res, w)
    gp = torch.einsum("ndi,nd,n->ni", Jp, res, w)
    okf, oobj = ba._object_index(prob)
    ko, chi2_o, onto_H, onto_b = ba._object_blocks(prob, plans)
    Hcc, bc, Hpp, bp = scatter.scatter_adds(
        (B, (plans.kf, Ccc), *onto_H), (B, (plans.kf, -gc), *onto_b),
        (P, (plans.pt, Cpp)), (P, (plans.pt, -gp)))
    pt_live = prob.pt_valid
    Hpp_inv = ba._hpp_inverse(Hpp, pt_live)
    hb = torch.einsum("pij,pj->pi", Hpp_inv, bp)
    contrib = torch.einsum("nij,njk,nlk->nil", Ccp, Hpp_inv[obs_pt], Ccp)
    corr_b, corr_S = scatter.scatter_adds(
        (B, (plans.kf, torch.einsum("nij,nj->ni", Ccp, hb[obs_pt]))), (B, (plans.kf, contrib)))
    bc_red = bc - corr_b
    free = ~ba._fixed_blocks(prob)
    Sdiag0 = Hcc - corr_S
    dvec = torch.clamp_min(torch.diagonal(Sdiag0, dim1=-2, dim2=-1), 1e-6)
    damp_vec = damping * dvec + 1e-4
    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    Sdiag = Sdiag0 + torch.diag_embed(damp_vec)
    Minv = torch.linalg.inv_ex(torch.where(free[:, None, None], Sdiag, eye6))[0]

    def matvec(x):
        x = torch.where(free[:, None], x, 0.0)
        y = torch.einsum("bij,bj->bi", Hcc, x)
        u = scatter.scatter_add(P, plans.pt, torch.einsum("nij,ni->nj", Ccp, x[obs_kf]))
        v = torch.einsum("pij,pj->pi", Hpp_inv, u)
        y_edge, = scatter.scatter_adds(
            (B, (plans.kf, -torch.einsum("nij,nj->ni", Ccp, v[obs_pt])),
             (plans.okf, torch.einsum("mij,mj->mi", ko, x[oobj])),
             (plans.oobj, torch.einsum("mij,mi->mj", ko, x[okf]))))
        y = y + y_edge + damp_vec * x
        return torch.where(free[:, None], y, 0.0)

    b = torch.where(free[:, None], bc_red, 0.0)
    x = torch.zeros_like(b)
    r = b
    z = torch.einsum("bij,bj->bi", Minv, b)
    p = z
    rz = torch.sum(b * z)
    for _ in range(cg_iters):
        Ap = matvec(p)
        alpha = rz / torch.clamp_min(torch.sum(p * Ap), 1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        z = torch.einsum("bij,bj->bi", Minv, r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.clamp_min(rz, 1e-20)
        p = z + beta * p
        rz = rz_new
    dx = torch.where(torch.isfinite(x), x, 0.0)
    u = scatter.scatter_add(P, plans.pt, torch.einsum("nij,ni->nj", Ccp, dx[obs_kf]))
    dp = ba._point_step(Hpp_inv, bp - u, pt_live)
    live = prob.obs_mask & prob.pt_valid[obs_pt] & prob.kf_valid[obs_kf]
    cost = torch.sum(torch.where(live, chi2, 0.0)) \
        + torch.sum(torch.where(prob.oobs_mask, chi2_o, 0.0))
    return ba._apply_step(prob, dx, dp), cost


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().numpy().view(np.int32)


def _capture_operands(monkeypatch, prob, steps=4):
    """The operands `_pcg_gn_step` hands the solve: (edges, Hcc, Hpp_inv,
    ko, damp_vec, free, Minv, b)."""
    seen = []
    real = schur_pcg.solve

    def spy(*args, **kwargs):
        seen.append((args, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(schur_pcg, "solve", spy)
    ba._pcg_gn_step(CAM, prob, 1e-3, steps)
    monkeypatch.setattr(schur_pcg, "solve", real)
    return seen[0][0][:8]


@pytest.mark.parametrize("name", ["corridor", "objects"])
def test_cpu_step_equals_the_op_by_op_step_bit_for_bit(problems, name):
    prob = ba_problem_from_numpy(problems[name], "cpu")
    if name == "objects":   # the case reaches the object couplings and the masks
        assert int(prob.oobs_mask.sum()) == 13 and not bool(prob.obj_valid[1])
        assert bool(prob.kf_fixed[5]) and not bool(prob.pt_valid.all())
    got, cost = ba._pcg_gn_step(CAM, prob, 1e-3, 16)
    want, want_cost = _parent_step(CAM, prob, 1e-3, 16)
    for k in ("kf_pose", "pts", "obj_pose"):
        np.testing.assert_array_equal(_bits(getattr(got, k)), _bits(getattr(want, k)), err_msg=k)
    assert _bits(cost) == _bits(want_cost)
    assert np.abs(got.kf_pose.numpy() - prob.kf_pose.numpy()).max() > 1e-3
    if name == "objects":
        assert np.abs(got.obj_pose.numpy()[[0, 2]] - prob.obj_pose.numpy()[[0, 2]]).max() > 1e-4
        np.testing.assert_array_equal(got.obj_pose.numpy()[1], prob.obj_pose.numpy()[1])
        np.testing.assert_array_equal(got.kf_pose.numpy()[5], prob.kf_pose.numpy()[5])


def test_a_group_takes_the_op_by_op_path(problems, monkeypatch):
    """With a group, CPU tensors run the plain version, whose every matvec
    all-reduces its point side and then its pose side; a one-rank sum
    changes nothing.  The route is the edges' layout, which follows their
    device alone."""
    group = object()
    ops = _capture_operands(monkeypatch, ba_problem_from_numpy(problems["objects"], "cpu"))
    e = ops[0]
    assert e.path == "ops" and schur_pcg.edges(e.plans, e.Ccp).path == "ops"
    with pytest.raises(ValueError, match="CPU or CUDA"):
        schur_pcg.edges(e.plans, e.Ccp.to("meta"))
    sums = []

    def psum(ts, g):
        assert g is group
        sums.append([tuple(t.shape) for t in ts])
        return ts

    monkeypatch.setattr(schur_pcg.dist, "psum", psum)
    schur_pcg.reset_launch_counts()
    want = schur_pcg.solve(*ops, 5)
    got = schur_pcg.solve(*ops, 5, group=group)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    B, P = ops[1].shape[0], ops[2].shape[0]
    assert sums == [[(P, 3)], [(B, 6)]] * 5
    assert schur_pcg.LAUNCHES == 0


def test_launches_stay_zero_on_the_cpu(problems):
    schur_pcg.reset_launch_counts()
    res = ba.global_ba_pcg(CAM, ba_problem_from_numpy(problems["objects"], "cpu"), n_iters=2,
                           cg_iters=8)
    assert bool(torch.isfinite(res.kf_pose).all())
    assert schur_pcg.LAUNCHES == 0


def _spoiled(ops, what):
    """The captured operands with one spoiled as `what` says."""
    e, Hcc, Hpp_inv, ko, damp_vec, free, Minv, b = ops
    plans, Ccp = e.plans, e.Ccp
    if what == "device":      # one operand elsewhere
        Hpp_inv = Hpp_inv.to("meta")
    elif what == "plan_device":
        plans = plans._replace(pt=plans.pt._replace(offsets=plans.pt.offsets.to("meta")))
    elif what == "all_meta":  # every operand on a device the solve does not take
        Hcc, Ccp, Hpp_inv, ko, damp_vec, free, Minv, b = (
            t.to("meta") for t in (Hcc, Ccp, Hpp_inv, ko, damp_vec, free, Minv, b))
        plans = type(plans)(*(p._replace(idx=p.idx.to("meta"), perm=p.perm.to("meta"),
                                         offsets=p.offsets.to("meta")) for p in plans[:4]))
    elif what == "dtype":     # one operand in f64
        Minv = Minv.double()
    elif what == "int_dtype":
        b = b.int()
    elif what == "free_dtype":
        free = free.float()
    elif what == "shape":     # 6x6 edge blocks where 6x3 belong
        Ccp = torch.zeros(Ccp.shape[0], 6, 6)
    elif what == "points":    # Hpp⁻¹ of one point fewer than the plan's targets
        Hpp_inv = Hpp_inv[:-1]
    elif what == "edges":     # one edge fewer than the plans' rows
        Ccp = Ccp[:-1]
    elif what == "blocks":
        damp_vec = damp_vec[:-1]
    elif what == "layout":    # laid out for the kernels, on the CPU
        e = e._replace(ccp_pt=Ccp)
    return e._replace(plans=plans, Ccp=Ccp), Hcc, Hpp_inv, ko, damp_vec, free, Minv, b


@pytest.mark.parametrize("what", ["device", "plan_device", "all_meta", "dtype", "int_dtype",
                                  "free_dtype", "shape", "points", "edges", "blocks",
                                  "layout"])
def test_the_wrapper_raises_on_a_wrong_operand(problems, monkeypatch, what):
    ops = _capture_operands(monkeypatch, ba_problem_from_numpy(problems["objects"], "cpu"))
    assert schur_pcg.solve(*ops, 2).shape == ops[7].shape   # the captured call runs
    with pytest.raises(ValueError):
        schur_pcg.solve(*_spoiled(ops, what), 2)


def test_float64_runs_the_plain_version(problems, monkeypatch):
    ops = _capture_operands(monkeypatch, ba_problem_from_numpy(problems["objects"], "cpu"))
    e = ops[0]
    f64 = [e._replace(Ccp=e.Ccp.double())] + [t.double() if t.is_floating_point() else t
                                              for t in ops[1:]]
    want = schur_pcg.solve(*ops, 4)
    got = schur_pcg.solve(*f64, 4)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("what", ["shape", "dtype", "device", "layout"])
def test_the_edge_sums_raise_on_a_wrong_vector(problems, monkeypatch, what):
    e = _capture_operands(monkeypatch, ba_problem_from_numpy(problems["objects"], "cpu"))[0]
    B, P = e.plans.kf.n, e.plans.pt.n
    x, v = torch.zeros(B, 6), torch.zeros(P, 3)
    assert schur_pcg.point_sums(e, x).shape == (P, 3)
    assert schur_pcg.pose_sums(e, v).shape == (B, 6)
    spoil = {"shape": lambda t: t[:-1], "dtype": lambda t: t.double(),
             "device": lambda t: t.to("meta"), "layout": lambda t: t}[what]
    if what == "layout":   # laid out for the kernels, on the CPU
        e = e._replace(ccp_pt=e.Ccp, kf_pt=e.plans.kf.idx.int(), ccp_kf=e.Ccp,
                       pt_kf=e.plans.pt.idx.int())
    with pytest.raises(ValueError):
        schur_pcg.point_sums(e, spoil(x))
    with pytest.raises(ValueError):
        schur_pcg.pose_sums(e, spoil(v))


def _plain_edges(plans, Ccp):
    return schur_pcg.Edges(plans, Ccp)


@pytest.mark.cuda
def test_kernels_hold_to_the_plain_path_on_the_card(problems, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prob = ba_problem_from_numpy(problems["objects"], "cuda")
    schur_pcg.reset_launch_counts()
    got, cost = ba._pcg_gn_step(CAM, prob, 1e-3, 16)
    torch.cuda.synchronize()
    assert 0 < schur_pcg.LAUNCHES <= 4 * 16
    again, cost2 = ba._pcg_gn_step(CAM, prob, 1e-3, 16)
    glob = ba.global_ba_pcg(CAM, prob, n_iters=4)
    glob2 = ba.global_ba_pcg(CAM, prob, n_iters=4)
    with monkeypatch.context() as m:   # the same steps op by op on the card
        m.setattr(schur_pcg, "edges", _plain_edges)
        schur_pcg.reset_launch_counts()
        want, want_cost = ba._pcg_gn_step(CAM, prob, 1e-3, 16)
        glob_plain = ba.global_ba_pcg(CAM, prob, n_iters=4)
        assert schur_pcg.LAUNCHES == 0
    for k in ("kf_pose", "pts", "obj_pose"):
        np.testing.assert_allclose(getattr(got, k).cpu().numpy(), getattr(want, k).cpu().numpy(),
                                   atol=1e-4, rtol=0, err_msg=k)
        np.testing.assert_array_equal(_bits(getattr(got, k)), _bits(getattr(again, k)))
    np.testing.assert_allclose(float(cost), float(want_cost), rtol=1e-5)
    assert _bits(cost) == _bits(cost2)
    assert np.abs(got.kf_pose.cpu().numpy() - prob.kf_pose.cpu().numpy()).max() > 1e-3
    np.testing.assert_allclose(glob.kf_pose.cpu().numpy(), glob_plain.kf_pose.cpu().numpy(),
                               atol=5e-3, rtol=0)
    for k in ("kf_pose", "pts", "obj_pose", "cost"):
        np.testing.assert_array_equal(_bits(getattr(glob, k)), _bits(getattr(glob2, k)))

    # a solve of the global BA's depth: 1 + 3 launches a step; the edge sums
    # against their plain versions; float32 only
    ops = _capture_operands(monkeypatch, prob)
    e = ops[0]
    assert e.ccp_pt is not None
    schur_pcg.reset_launch_counts()
    assert bool(torch.isfinite(schur_pcg.solve(*ops, 48)).all())
    assert schur_pcg.LAUNCHES == 1 + 3 * 48
    plain = e._replace(ccp_pt=None, kf_pt=None, ccp_kf=None, pt_kf=None)
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(e.plans.kf.n, 6, generator=gen).cuda()
    v = torch.randn(e.plans.pt.n, 3, generator=gen).cuda()
    for fn, arg in ((schur_pcg.point_sums, x), (schur_pcg.pose_sums, v)):
        a, b = fn(e, arg), fn(plain, arg)
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()), fn.__name__
        assert np.array_equal(_bits(fn(e, arg)), _bits(a)), fn.__name__   # repeats
    with pytest.raises(ValueError, match="float32"):
        schur_pcg.edges(e.plans, e.Ccp.double())


@pytest.mark.cuda
def test_the_group_route_runs_the_kernels_on_the_card(problems, monkeypatch):
    """A group on the card: the host loop of single launches, each side's
    sums all-reduced between them; with one rank's identity sum, the
    group-less solve's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prob = ba_problem_from_numpy(problems["objects"], "cuda")
    ops = _capture_operands(monkeypatch, prob)
    B, P = ops[1].shape[0], ops[2].shape[0]
    group, sums = object(), []

    def psum(ts, g):
        assert g is group and all(t.is_cuda for t in ts)
        sums.append([tuple(t.shape) for t in ts])
        return [t.clone() for t in ts]

    monkeypatch.setattr(schur_pcg.dist, "psum", psum)
    want = schur_pcg.solve(*ops, 24)
    schur_pcg.reset_launch_counts()
    got = schur_pcg.solve(*ops, 24, group=group)
    assert schur_pcg.LAUNCHES == 1 + 4 * 24
    assert sums == [[(P, 3)], [(B, 6)]] * 24
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert float(want.abs().max()) > 0
    # the whole GN step (`ba.dist` is the same module): its other edge sums
    # through the kernels too, each all-reduced by `_pcg_gn_step` itself
    step, cost = ba._pcg_gn_step(CAM, prob, 1e-3, 16)
    step_g, cost_g = ba._pcg_gn_step(CAM, prob, 1e-3, 16, group=group)
    for k in ("kf_pose", "pts", "obj_pose"):
        np.testing.assert_array_equal(_bits(getattr(step_g, k)), _bits(getattr(step, k)))
    assert _bits(cost_g) == _bits(cost)
