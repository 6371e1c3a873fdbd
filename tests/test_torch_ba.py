"""The port's bundle adjustment (`mapping/ba.py`) and BA problem assembly
(`mapping/local_mapping.py`) against the JAX package's, on the CPU, on
the same seeded inputs: tests/test_mapping.py's synthetic problems
(rebuilt from its seeds) and the corridor map of tests/test_ba_scale.py
(`tools/corridor_map.py`).

Tolerances: `_reproj_terms`/`_object_terms` 1e-5; one `_assemble_and_solve`
step (mono, stereo, with object edges) poses and points 1e-4; `local_ba`
and `global_ba` final cost within 1e-3 relative, both packages under
tests/test_mapping.py's error bounds; `_gate` masks equal; `global_ba_pcg`
vs the dense solver on the 24-KF corridor both < 0.03 m, poses within
5e-3, and within 5e-3 of the JAX package's PCG; `local_ba_step` the map
within 1e-4 (points 1e-4 relative); `build_local_ba_problem` the same `LocalIndex` and problem (indices
and masks equal, floats 1e-6); the bucket-overflow redo equal to a solve
with exact buckets (1e-6); `local_ba_and_cull_step` the same culled list
and the state within 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_slam_rgbd_tpu.mapping import ba as jba
from dsp_slam_rgbd_tpu.mapping import local_mapping as jlm
from dsp_slam_rgbd_tpu_torch.mapping import ba as tba
from dsp_slam_rgbd_tpu_torch.mapping import local_mapping as tlm
from dsp_slam_rgbd_tpu_torch.ops import camera as tcam
from dsp_slam_rgbd_tpu_torch.tools import corridor_map
from dsp_slam_rgbd_tpu_torch.weights import (ba_problem_from_numpy, ba_problem_to_numpy,
                                             ba_result_to_numpy, map_state_from_numpy)
from test_ba_scale import CAM as JCAM_CORRIDOR
from test_ba_scale import build_corridor_map
from test_mapping import CAM as JCAM
from test_mapping import pose_errors, sim_ba_problem

TCAM = tcam.Intrinsics(*JCAM)
TCAM_CORRIDOR = tcam.Intrinsics(*JCAM_CORRIDOR)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(tree) -> dict:
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


def _problem(case):
    """(JAX BAProblem, the port's, truth) for one of test_mapping's cases."""
    seed, kw = {"mono": (0, {}), "stereo": (1, {"stereo": True}),
                "objects": (2, {"with_objects": True})}[case]
    prob, kf_true, pts_true, obj_true = sim_ba_problem(np.random.default_rng(seed), **kw)
    return prob, ba_problem_from_numpy(_np(prob), "cpu"), (kf_true, pts_true, obj_true)


def _assert_tree(t, j, atol, skip=()):
    """Port NamedTuple vs JAX NamedTuple: integer and bool fields equal,
    float fields within atol."""
    for k, v in j._asdict().items():
        if k in skip:
            continue
        a, b = getattr(t, k).numpy(), np.asarray(v)
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=k)


def test_ba_problem_round_trip_is_exact():
    jp, tp, _ = _problem("objects")
    back = ba_problem_to_numpy(tp)
    for k, v in _np(jp).items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("case", ["mono", "stereo", "objects"])
def test_residual_terms_match_jax(case):
    """Each term within 1e-5 of its largest entry (the residuals are
    differences of ~500 px coordinates, where one f32 step is 3e-5 px)."""
    jp, tp, _ = _problem(case)
    pairs = list(zip(tba._reproj_terms(TCAM, tp), jba._reproj_terms(JCAM, jp))) \
        + list(zip(tba._object_terms(tp), jba._object_terms(jp)))
    for a, b in pairs:
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5 * max(np.abs(b).max(), 1.0), rtol=0)


def _f64(prob):
    return tba.BAProblem(*[v.double() if v.is_floating_point() else v for v in prob])


@pytest.mark.parametrize("case", ["mono", "stereo", "objects"])
def test_one_gn_step_matches_jax(case):
    """One LM step, both packages in f32 against the port's step in f64
    on the same problem: each within 1e-4 (poses and points), so the two
    within 2e-4.  The mono cases leave the scale to the damping, and
    there the two f32 steps sit ~8e-5 from the f64 one in different
    directions (1.0e-4 apart in the case with objects)."""
    jp, tp, _ = _problem(case)
    pj, cj = jba._assemble_and_solve(JCAM, jp, 1e-3)
    pt, ct = tba._assemble_and_solve(TCAM, tp, 1e-3)
    p64, c64 = tba._assemble_and_solve(TCAM, _f64(tp), 1e-3)
    for k in ("kf_pose", "pts", "obj_pose"):
        exact = getattr(p64, k).numpy()
        np.testing.assert_allclose(getattr(pt, k).numpy(), exact, atol=1e-4, rtol=0, err_msg=k)
        np.testing.assert_allclose(np.asarray(getattr(pj, k)), exact, atol=1e-4, rtol=0, err_msg=k)
        np.testing.assert_allclose(getattr(pt, k).numpy(), np.asarray(getattr(pj, k)),
                                   atol=2e-4, rtol=0, err_msg=k)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-5)
    np.testing.assert_allclose(float(ct), float(c64), rtol=1e-5)
    # the step did something
    assert np.abs(pt.kf_pose.numpy() - tp.kf_pose.numpy()).max() > 1e-3


@pytest.mark.parametrize("case", ["mono", "stereo", "objects"])
def test_local_ba_converges_like_jax(case):
    """A whole two-stage LM run: final cost within 1e-3 relative, and both
    packages inside tests/test_mapping.py's bounds for the case."""
    jp, tp, (kf_true, pts_true, obj_true) = _problem(case)
    rj = jba.local_ba(JCAM, jp)
    rt = tba.local_ba(TCAM, tp)
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-3)
    err0 = pose_errors(np.asarray(jp.kf_pose), kf_true)
    for res in (ba_result_to_numpy(rt), _np(rj)):
        err1 = pose_errors(res["kf_pose"], kf_true)
        if case == "mono":
            assert err1.mean() < 0.25 * err0.mean()
            pe0 = np.linalg.norm(np.asarray(jp.pts) - pts_true, axis=1).mean()
            pe1 = np.linalg.norm(res["pts"] - pts_true, axis=1).mean()
            assert pe1 < 0.7 * pe0 and pe1 < 0.06
            assert res["obs_mask"].mean() > 0.9
        elif case == "stereo":
            assert err1.mean() < 0.02
        else:
            assert pose_errors(res["obj_pose"], obj_true).max() < 0.05
            assert res["oobs_mask"].mean() > 0.9


def test_global_ba_matches_jax():
    jp, tp, (kf_true, _, _) = _problem("stereo")
    rj = jba.global_ba(JCAM, jp, n_iters=8)
    rt = tba.global_ba(TCAM, tp, n_iters=8)
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-3)
    for res in (ba_result_to_numpy(rt), _np(rj)):
        assert pose_errors(res["kf_pose"], kf_true).mean() < 0.02


def test_gate_matches_jax():
    """tests/test_mapping.py's outlier case: 30 corrupted observations."""
    prob, *_ = sim_ba_problem(np.random.default_rng(4), noise_pose=0.01, noise_pt=0.01)
    uv = np.asarray(prob.obs_uv).copy()
    uv[:30, :2] += 50.0
    jp = prob._replace(obs_uv=jnp.asarray(uv))
    tp = ba_problem_from_numpy(_np(jp), "cpu")
    gj, gt = jba._gate(JCAM, jp), tba._gate(TCAM, tp)
    np.testing.assert_array_equal(gt.obs_mask.numpy(), np.asarray(gj.obs_mask))
    np.testing.assert_array_equal(gt.oobs_mask.numpy(), np.asarray(gj.oobs_mask))
    assert not gt.obs_mask.numpy()[:30].any()
    np.testing.assert_allclose(float(tba._robust_cost(TCAM, tp)),
                               float(jba._robust_cost(JCAM, jp)), rtol=1e-5)
    rt = tba.local_ba(TCAM, tp)
    assert rt.obs_mask.numpy()[:30].sum() == 0 and rt.obs_mask.numpy()[30:].mean() > 0.9


# ------------------------------------------------------------ the corridor
@pytest.fixture(scope="module")
def corridor():
    """test_global_pcg_matches_dense's map in both packages."""
    kw = dict(n_kf=24, n_pts=2000, feat_per_kf=120, noise=0.2, max_kf=32, max_pts=4096)
    js, pt_gt, centers = build_corridor_map(**kw)
    fields, pt_gt_t, centers_t = corridor_map.build_corridor_map(**kw)
    return js, map_state_from_numpy(fields, "cpu"), fields, pt_gt, centers, (pt_gt_t, centers_t)


def test_corridor_map_is_the_jax_tests_map(corridor):
    js, _, fields, pt_gt, centers, (pt_gt_t, centers_t) = corridor
    for k, v in _np(js).items():
        assert fields[k].dtype == v.dtype, k
        np.testing.assert_array_equal(fields[k], v, err_msg=k)
    np.testing.assert_array_equal(pt_gt_t, pt_gt)
    np.testing.assert_array_equal(centers_t, centers)


@pytest.mark.parametrize("center,global_window", [(12, False), (0, True)])
def test_build_local_ba_problem_matches_jax(corridor, center, global_window):
    js, ts = corridor[:2]
    pj, ij = jlm.build_local_ba_problem(js, center, 6, global_window=global_window)
    pt, it = tlm.build_local_ba_problem(ts, center, 6, global_window=global_window)
    _assert_tree(pt, pj, 1e-6)
    _assert_tree(it, ij, 0)
    assert int(pt.obs_mask.sum()) > 500
    # apply: the same map after scattering a result back
    rj = jba.local_ba(JCAM_CORRIDOR, pj, stage1_iters=1, stage2_iters=1)
    res_t = tba.BAResult(*[torch.from_numpy(np.array(np.asarray(v))) for v in rj])
    aj, at = jlm.apply_ba_result(js, ij, rj), tlm.apply_ba_result(ts, it, res_t)
    _assert_tree(at, aj, 1e-6)


def test_global_pcg_matches_dense(corridor):
    """Port PCG vs port dense on the corridor, as test_global_pcg_matches_dense
    does for the JAX package: both < 0.03 m from the truth, poses within
    5e-3; and the port's PCG within 5e-3 of the JAX package's."""
    js, ts, centers = corridor[0], corridor[1], corridor[4]
    prob, idx = tlm.build_local_ba_problem(ts, 0, 0, global_window=True)
    res_d = tba.global_ba(TCAM_CORRIDOR, prob, n_iters=10)
    res_p = tba.global_ba_pcg(TCAM_CORRIDOR, prob, n_iters=10, cg_iters=64, damping=1e-3)
    kf_ok = idx.kf_idx.numpy() >= 0
    gt_c = centers[idx.kf_idx.numpy()[kf_ok]]
    for name, res in (("dense", res_d), ("pcg", res_p)):
        err = np.linalg.norm(-res.kf_pose.numpy()[kf_ok][:, :3, 3] - gt_c, axis=-1)
        assert err.max() < 0.03, (name, err.max())
    d = np.abs(res_d.kf_pose.numpy()[kf_ok] - res_p.kf_pose.numpy()[kf_ok]).max()
    assert d < 5e-3, d
    pj, _ = jlm.build_local_ba_problem(js, 0, 0, global_window=True)
    rj = jba.global_ba_pcg(JCAM_CORRIDOR, pj, n_iters=10, cg_iters=64, damping=1e-3)
    np.testing.assert_allclose(res_p.kf_pose.numpy(), np.asarray(rj.kf_pose), atol=5e-3)


def test_pcg_step_matches_jax(corridor):
    js, ts = corridor[:2]
    pj, _ = jlm.build_local_ba_problem(js, 0, 0, global_window=True)
    pt, _ = tlm.build_local_ba_problem(ts, 0, 0, global_window=True)
    sj, cj = jba._pcg_gn_step(JCAM_CORRIDOR, pj, 1e-3, 16)
    st, ct = tba._pcg_gn_step(TCAM_CORRIDOR, pt, 1e-3, 16)
    np.testing.assert_allclose(st.kf_pose.numpy(), np.asarray(sj.kf_pose), atol=1e-4, rtol=0)
    np.testing.assert_allclose(st.pts.numpy(), np.asarray(sj.pts), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-5)


def test_overflow_redo_equals_exact_buckets(corridor):
    """Buckets seeded too small for the window: `ba_cull_read` finds the
    overflow, solves again from the pre-BA state with grown buckets, and
    lands where a solve with exact buckets does."""
    ts = corridor[1]
    exact, culled_exact = tlm.local_ba_and_cull_step(ts, TCAM_CORRIDOR, 12, max_kfs=6)
    key = tlm._shapes(ts) + (6, False)
    tlm._bucket_memo[key] = (2, 64, 1, 256, 16)
    pend = tlm.ba_cull_dispatch(ts, TCAM_CORRIDOR, 12, max_kfs=6)
    fit, culled, redo = tlm.ba_cull_read(pend)
    assert not fit and redo is not None
    assert tlm._bucket_memo[key][0] > 2
    assert culled == culled_exact
    for k in ("kf_pose", "pt_pos", "kf_valid", "kf_feat_pt", "pt_ref_kf"):
        np.testing.assert_allclose(getattr(redo, k).numpy(), getattr(exact, k).numpy(),
                                   atol=1e-6, rtol=0, err_msg=k)
    # and the optimistic path with memoized buckets (no overflow) is exact too
    tlm._bucket_memo[key] = (2, 64, 1, 256, 16)
    via_opt = tlm._solve_ba_optimistic(ts, TCAM_CORRIDOR, 12, 6, False,
                                       lambda p: tba.local_ba(TCAM_CORRIDOR, p))
    prob, idx = tlm.build_local_ba_problem(ts, 12, 6)
    direct = tlm.apply_ba_result(ts, idx, tba.local_ba(TCAM_CORRIDOR, prob))
    np.testing.assert_allclose(via_opt.kf_pose.numpy(), direct.kf_pose.numpy(), atol=1e-6)


def test_local_ba_and_cull_step_matches_jax(corridor):
    js, ts = corridor[:2]
    sj, cj = jlm.local_ba_and_cull_step(js, JCAM_CORRIDOR, 12, max_kfs=6)
    st, ct = tlm.local_ba_and_cull_step(ts, TCAM_CORRIDOR, 12, max_kfs=6)
    assert ct == cj and len(ct) >= 1
    _assert_tree(st, sj, 1e-4)


def test_local_ba_step_matches_jax(corridor):
    """`local_ba_step` (assemble, solve and apply through the memoized
    buckets, 15 LM steps) on the corridor's middle: the same map within
    1e-4, points within 1e-4 relative (one of 4,096 differs by 1.9e-4 at
    14 m after the 15 f32 steps)."""
    js, ts = corridor[:2]
    sj = jlm.local_ba_step(js, JCAM_CORRIDOR, 12)
    st = tlm.local_ba_step(ts, TCAM_CORRIDOR, 12)
    _assert_tree(st, sj, 1e-4, skip=("pt_pos",))
    np.testing.assert_allclose(st.pt_pos.numpy(), np.asarray(sj.pt_pos), atol=1e-4, rtol=1e-4)
    assert np.abs(st.kf_pose.numpy() - ts.kf_pose.numpy()).max() > 1e-3


def test_global_ba_step_switches_to_pcg(corridor):
    """`global_ba_step` takes the dense path up to `dense_limit` pose
    blocks and PCG past it; both reduce the corridor's error."""
    ts, centers = corridor[1], corridor[4]
    for limit in (96, 8):
        st = tlm.global_ba_step(ts, TCAM_CORRIDOR, n_iters=6, dense_limit=limit)
        c = -st.kf_pose.numpy()[:24, :3, 3]
        c0 = -ts.kf_pose.numpy()[:24, :3, 3]
        err, err0 = np.linalg.norm(c - centers, axis=1), np.linalg.norm(c0 - centers, axis=1)
        assert err.mean() < 0.5 * err0.mean(), (limit, err.mean(), err0.mean())
    js = corridor[0]
    np.testing.assert_allclose(
        tlm.global_ba_step(ts, TCAM_CORRIDOR, n_iters=4).kf_pose.numpy(),
        np.asarray(jlm.global_ba_step(js, JCAM_CORRIDOR, n_iters=4).kf_pose), atol=1e-3)
