"""The port's monocular initializer (`solvers/initializer.py`) and Sim(3)
solvers (`solvers/sim3.py`) against the JAX package's, on the CPU, on the
same seeded numpy inputs: the initializer and Sim(3) cases of
tests/test_solvers.py.

The two packages draw their RANSAC samples from different streams, so the
port's evaluation is held to the JAX package's own index arrays: each test
draws them with `jax.random.choice` on the key and `p` the JAX function
uses, and feeds them to `initialize_from_indices` /
`solve_sim3_from_indices`.  Tolerances:
  * `horn_align`, `align_trajectories` within 1e-5;
  * the H fit of a fixed sample within 1e-4 up to scale and sign
    (eigenvectors' and singular vectors' signs are free); the F fit rank 2
    and meeting its sample's epipolar constraints within 2x the JAX fit's
    residual (the 8-point system's f32 normal matrix squares its condition
    number, and XLA's and LAPACK's eigensolvers part there: up to 1.3e-2
    between the normalized F's on these samples); the four F and the four
    H motions of one model pair within 1e-4 as sets;
  * the RANSAC evaluations given the JAX index arrays: verdict and model
    choice equal; on the homography path (the planar scene) the chosen
    motion and the points within 1e-4 (points 1e-4 relative) and the
    `good` mask equal.  On the fundamental path (the general scene) the
    motion is ill-conditioned in f32 within the JAX package itself: its
    jit-compiled `initialize` and the same function run op by op
    (`jax.disable_jit`) pick the same trial and part by 8.35e-3 rad.  The
    port picks that trial too (its F within 3.6e-6 of JAX's, up to scale
    and sign) and is held to both: to the op-by-op result within 1e-4 rad
    in rotation and 2.5e-3 in the unit translation (measured 7.1e-5 rad
    and 1.9e-3; with the port's eigensolve in f32 instead of f64, 4.7e-5
    rad and 1.3e-3), and to the compiled result within 0.015 rad and 0.05
    (measured 8.39e-3 rad and 0.0234; in f32, 8.38e-3 rad and 0.0233: the
    precision of the port's eigensolve is not what parts them), the `good`
    masks agreeing on >= 99% (99.67% for both);
  * `refine_sim3_gn` one iteration within 1e-5, 20 within 1e-3;
  * the ends of each JAX test (ok, motion error bars) for the port's own
    draws (`draw_indices` from a CPU generator).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_slam_rgbd_tpu.ops import camera as jcam
from dsp_slam_rgbd_tpu.ops import lie as jlie
from dsp_slam_rgbd_tpu.solvers import initializer as jinit
from dsp_slam_rgbd_tpu.solvers import sim3 as jsim3
from dsp_slam_rgbd_tpu_torch.ops import camera as tcam
from dsp_slam_rgbd_tpu_torch.ops import lie as tlie
from dsp_slam_rgbd_tpu_torch.solvers import initializer as tinit
from dsp_slam_rgbd_tpu_torch.solvers import sim3 as tsim3

JCAM = jcam.Intrinsics(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0)
TCAM = tcam.Intrinsics(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0)


def t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def jax_indices(key, valid, n_trials, k):
    """The sample indices the JAX RANSACs draw for `key`."""
    p = jnp.asarray(valid, jnp.float32)
    p = p / jnp.maximum(p.sum(), 1.0)
    return np.asarray(jax.random.choice(key, len(valid), shape=(n_trials, k),
                                        replace=True, p=p))


def scene(rng, n=200, spread=4.0, depth=8.0):
    return np.stack([rng.uniform(-spread, spread, n), rng.uniform(-spread * 0.6, spread * 0.6, n),
                     rng.uniform(depth * 0.5, depth * 1.5, n)], axis=-1).astype(np.float32)


def make_pose(rng, rot=0.1, trans=0.5):
    x = np.concatenate([rng.standard_normal(3) * trans, rng.standard_normal(3) * rot])
    return np.asarray(jlie.exp_se3(jnp.asarray(x.astype(np.float32))))


def rel_rot_err(Ra, Rb):
    return float(np.linalg.norm(np.asarray(jlie.log_so3(jnp.asarray(Ra @ Rb.T)))))


# ----------------------------------------------------------------- Sim(3)
def test_horn_alignment_exact():
    rng = np.random.default_rng(5)
    p1 = rng.standard_normal((50, 3)).astype(np.float32)
    x = np.concatenate([rng.standard_normal(3), rng.standard_normal(3) * 0.4, [0.3]])
    T_true = np.asarray(jlie.exp_sim3(jnp.asarray(x, jnp.float32)))
    p2 = np.asarray(jlie.transform_points(jnp.asarray(T_true), jnp.asarray(p1)))
    w = rng.uniform(0.2, 1.0, 50).astype(np.float32)
    for fix, weights in ((False, None), (True, None), (False, w)):
        J = np.asarray(jsim3.horn_align(jnp.asarray(p1), jnp.asarray(p2), fix_scale=fix,
                                        weights=None if weights is None else jnp.asarray(weights)))
        T = tsim3.horn_align(t(p1), t(p2), fix_scale=fix,
                             weights=None if weights is None else t(weights)).numpy()
        np.testing.assert_allclose(T, J, atol=1e-5)
    np.testing.assert_allclose(tsim3.horn_align(t(p1), t(p2)).numpy(), T_true, atol=1e-3)
    # batched over trials: each sample's alignment as alone
    idx = rng.integers(0, 50, (7, 3))
    Tb = tsim3.horn_align(t(p1)[t(idx)], t(p2)[t(idx)]).numpy()
    for i in range(7):
        np.testing.assert_allclose(Tb[i], np.asarray(jsim3.horn_align(
            jnp.asarray(p1[idx[i]]), jnp.asarray(p2[idx[i]]))), atol=1e-4)


def _sim3_case():
    rng = np.random.default_rng(7)
    pts1 = scene(rng, n=80)
    T_true = make_pose(rng, rot=0.3, trans=2.0)
    pts2 = np.asarray(jlie.transform_points(jnp.asarray(T_true), jnp.asarray(pts1))).copy()
    pts2[:20] += rng.uniform(1, 3, (20, 3))          # corrupt 20 correspondences
    uv1 = np.asarray(jcam.project(JCAM, jnp.asarray(pts1)))
    uv2_true = np.asarray(jcam.project(JCAM, jlie.transform_points(jnp.asarray(T_true),
                                                                   jnp.asarray(pts1))))
    return pts1, pts2, uv1, uv2_true, T_true


def test_sim3_ransac():
    pts1, pts2, uv1, uv2, T_true = _sim3_case()
    ones, valid = np.ones(80, np.float32), np.ones(80, bool)
    key = jax.random.PRNGKey(1)
    J = jsim3.solve_sim3_ransac(JCAM, JCAM, *map(jnp.asarray, (pts1, pts2, uv1, uv2, ones, ones,
                                                                valid)), key)
    idx = jax_indices(key, valid, 64, 3)
    T = tsim3.solve_sim3_from_indices(TCAM, TCAM, *map(t, (pts1, pts2, uv1, uv2, ones, ones,
                                                          valid)), t(idx))
    assert bool(T.ok) == bool(J.ok) and int(T.n_inliers) == int(J.n_inliers)
    np.testing.assert_array_equal(T.inliers.numpy(), np.asarray(J.inliers))
    np.testing.assert_allclose(T.t_21.numpy(), np.asarray(J.t_21), atol=1e-4)
    # the port's own draws reach the JAX test's bar
    R = tsim3.solve_sim3_ransac(TCAM, TCAM, *map(t, (pts1, pts2, uv1, uv2, ones, ones, valid)),
                                torch.Generator().manual_seed(1))
    assert bool(R.ok)
    err = tlie.log_se3(R.t_21 @ tlie.inv_se3(t(T_true))).numpy()
    assert np.linalg.norm(err) < 0.05


@pytest.mark.parametrize("iters,tol", [(1, 1e-5), (20, 1e-3)])
def test_refine_sim3_gn(iters, tol):
    """`refine_sim3_gn` (the JAX `jacfwd` Jacobian as `torch.func.jacfwd`)
    on test_loop.py's noisy pairs with 8 gross outliers."""
    rng = np.random.default_rng(7)
    N = 40
    p1 = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N),
                   rng.uniform(5, 9, N)], -1).astype(np.float32)
    T_true = np.asarray(jlie.exp_se3(jnp.asarray([0.4, -0.2, 0.1, 0.03, -0.05, 0.02])))
    p2 = (p1 @ T_true[:3, :3].T + T_true[:3, 3]).astype(np.float32)
    uv1 = np.array(jcam.project(JCAM, jnp.asarray(p1))) + rng.normal(0, 0.3, (N, 2))
    uv2 = np.array(jcam.project(JCAM, jnp.asarray(p2))) + rng.normal(0, 0.3, (N, 2))
    uv2[:8] += rng.uniform(40, 80, (8, 2))
    uv1, uv2 = uv1.astype(np.float32), uv2.astype(np.float32)
    T0 = np.asarray(jlie.exp_se3(jnp.asarray([0.06, -0.04, 0.05, 0.01, 0.008, -0.012]))) @ T_true
    valid = np.ones(N, bool)
    for fix in (True, False):
        Tj, inj, nj = jsim3.refine_sim3_gn(JCAM, JCAM, *map(jnp.asarray, (T0, p1, p2, uv1, uv2,
                                                                           valid)),
                                           fix_scale=fix, n_iters=iters)
        Tt, intt, nt = tsim3.refine_sim3_gn(TCAM, TCAM, *map(t, (T0, p1, p2, uv1, uv2, valid)),
                                            fix_scale=fix, n_iters=iters)
        np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=tol)
        np.testing.assert_array_equal(intt.numpy(), np.asarray(inj))
        assert int(nt) == int(nj)
        if iters == 20 and fix:
            assert not intt[:8].any() and int(nt) >= 28


def test_ate_alignment():
    rng = np.random.default_rng(8)
    traj = np.cumsum(rng.standard_normal((100, 3)), 0).astype(np.float32)
    T = jlie.exp_se3(jnp.asarray([1.0, -2.0, 0.5, 0.1, 0.2, -0.1]))
    est = np.asarray(jlie.transform_points(jlie.inv_se3(T), jnp.asarray(traj)))
    Tj, ate_j = jsim3.align_trajectories(jnp.asarray(est), jnp.asarray(traj))
    Tt, ate_t = tsim3.align_trajectories(t(est), t(traj))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-5)
    assert float(ate_t) < 1e-3 and abs(float(ate_t) - float(ate_j)) < 1e-5


# ------------------------------------------------------------ initializer
def _init_case(rng, planar: bool):
    n = 300
    if planar:
        pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                        8.0 + 0.6 * rng.uniform(-4, 4, n)], -1)
        pts[:, 2] = 8.0 + 0.4 * pts[:, 0] + 0.2 * pts[:, 1]
    else:
        pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(5, 14, n)], -1)
    pts = jnp.asarray(pts.astype(np.float32))
    T2 = jlie.exp_se3(jnp.asarray([0.8, 0.05, 0.1, 0.02, -0.06, 0.01]))
    uv1 = jcam.project(JCAM, pts)
    uv2 = jcam.project(JCAM, jlie.transform_points(T2, pts))
    noise = lambda: rng.normal(0, 0.4, (n, 2)).astype(np.float32)  # noqa: E731
    return np.asarray(T2), np.asarray(uv1 + noise()), np.asarray(uv2 + noise())


def _up_to_sign_and_scale(a, b):
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    return min(np.abs(a - b).max(), np.abs(a + b).max())


def _motion_sets_match(A, B, tol):
    """Each (R, t) of A has one within tol in B."""
    for Ra, ta in A:
        assert min(max(np.abs(Ra - Rb).max(), np.abs(ta - tb).max()) for Rb, tb in B) < tol


def test_model_fits_and_motion_candidates():
    """`_fit_homography`, `_fit_fundamental` on one fixed 8-point sample,
    batched like the trials, and the F and H motion hypotheses of the
    best models, all against the JAX package's."""
    rng = np.random.default_rng(9)
    for planar in (False, True):
        _, uv1, uv2 = _init_case(rng, planar)
        valid = np.ones(len(uv1), bool)
        x1j, _ = jinit._normalize(jnp.asarray(uv1), jnp.asarray(valid))
        x2j, _ = jinit._normalize(jnp.asarray(uv2), jnp.asarray(valid))
        x1t, _ = tinit._normalize(t(uv1), t(valid))
        x2t, _ = tinit._normalize(t(uv2), t(valid))
        np.testing.assert_allclose(x1t.numpy(), np.asarray(x1j), atol=1e-5)
        ids = rng.integers(0, len(uv1), (3, 8))
        Ht = tinit._fit_homography(x1t[t(ids)], x2t[t(ids)]).numpy()
        Ft = tinit._fit_fundamental(x1t[t(ids)], x2t[t(ids)]).numpy()
        for i in range(3):
            Hj = np.asarray(jinit._fit_homography(x1j[ids[i]], x2j[ids[i]]))
            Fj = np.asarray(jinit._fit_fundamental(x1j[ids[i]], x2j[ids[i]]))
            assert _up_to_sign_and_scale(Ht[i], Hj) < 1e-4
            # F: rank 2 and the sample's epipolar constraints met as well
            # as the JAX fit meets them (normalized coordinates)
            assert np.linalg.svd(Ft[i], compute_uv=False)[2] < 1e-6
            h1 = np.concatenate([np.asarray(x1j[ids[i]]), np.ones((8, 1))], 1)
            h2 = np.concatenate([np.asarray(x2j[ids[i]]), np.ones((8, 1))], 1)
            res_t = np.abs(np.einsum("ni,ij,nj->n", h2, Ft[i] / np.linalg.norm(Ft[i]), h1)).max()
            res_j = np.abs(np.einsum("ni,ij,nj->n", h2, Fj / np.linalg.norm(Fj), h1)).max()
            assert res_t <= 2 * res_j + 1e-4
        # the E and H decompositions of one model pair, as sets
        K = np.asarray(JCAM.K)
        H, F = Hj / np.linalg.norm(Hj), Fj / np.linalg.norm(Fj)
        cands = tinit._candidates(t(K), t(np.asarray(JCAM.K_inv)), t(F), t(H))
        tf, th = cands[:4], cands[4:]
        jf, jh = _jax_candidates(K, np.asarray(JCAM.K_inv), F, H)
        _motion_sets_match([(R.numpy(), v.numpy()) for R, v in tf], jf, 1e-4)
        _motion_sets_match([(R.numpy(), v.numpy()) for R, v in th], jh, 1e-4)


def _jax_candidates(K, Kinv, F, H):
    """The JAX `initialize`'s eight (R, t) hypotheses (its :167-206) for
    given F and H, in numpy from JAX's own SVDs."""
    E = K.T @ F @ K
    U, _, Vt = (np.asarray(a) for a in jnp.linalg.svd(jnp.asarray(E)))
    W = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], np.float32)
    R1, R2 = U @ W @ Vt, U @ W.T @ Vt
    R1, R2 = R1 * np.sign(np.linalg.det(R1)), R2 * np.sign(np.linalg.det(R2))
    tu = U[:, 2] / np.linalg.norm(U[:, 2])
    f = [(R1, tu), (R1, -tu), (R2, tu), (R2, -tu)]
    Ua, Sa, Vat = (np.asarray(a) for a in jnp.linalg.svd(jnp.asarray(Kinv @ H @ K)))
    d1, d2, d3 = Sa
    s = np.linalg.det(Ua) * np.linalg.det(Vat)
    x1c = np.sqrt(max((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3), 0.0))
    x3c = np.sqrt(max((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3), 0.0))
    h = []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            x1s, x3s = x1c * e1, x3c * e3
            st, ct = (d1 - d3) * x1s * x3s / d2, (d1 * x3s * x3s + d3 * x1s * x1s) / d2
            Rp = np.array([[ct, 0.0, -st], [0.0, 1.0, 0.0], [st, 0.0, ct]])
            tv = Ua @ np.array([(d1 - d3) * x1s, 0.0, -(d1 - d3) * x3s])
            h.append((s * Ua @ Rp @ Vat, tv / np.linalg.norm(tv)))
    return f, h


@pytest.mark.parametrize("planar,seed,key", [(False, 9, 2), (True, 10, 3)])
def test_mono_init(planar, seed, key):
    """tests/test_solvers.py's general and planar initializations: the
    port's evaluation of the JAX index array against the JAX result, then
    the JAX test's bars for the port's own draws."""
    rng = np.random.default_rng(seed)
    T2, uv1, uv2 = _init_case(rng, planar)
    valid = np.ones(len(uv1), bool)
    k = jax.random.PRNGKey(key)
    J = jinit.initialize(JCAM, jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(valid), k)
    idx = jax_indices(k, valid, 200, 8)
    T = tinit.initialize_from_indices(TCAM, t(uv1), t(uv2), t(valid), t(idx))
    assert bool(T.ok) == bool(J.ok) and bool(T.is_homography) == bool(J.is_homography)
    Tt, Tj = T.t_21.numpy(), np.asarray(J.t_21)
    if planar:
        np.testing.assert_array_equal(T.good.numpy(), np.asarray(J.good))
        np.testing.assert_allclose(Tt, Tj, atol=1e-4)
        g = T.good.numpy()
        pj = np.asarray(J.pts_w)[g]
        np.testing.assert_allclose(T.pts_w.numpy()[g], pj, atol=1e-4 * np.abs(pj).max())
    else:
        assert rel_rot_err(Tt[:3, :3], Tj[:3, :3]) < 0.015
        assert np.abs(Tt[:3, 3] - Tj[:3, 3]).max() < 0.05
        assert (T.good.numpy() == np.asarray(J.good)).mean() >= 0.99
        with jax.disable_jit():
            O = jinit.initialize(JCAM, jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(valid), k)
        To = np.asarray(O.t_21)
        assert bool(O.ok) and not bool(O.is_homography)
        assert rel_rot_err(Tt[:3, :3], To[:3, :3]) < 1e-4
        assert np.abs(Tt[:3, 3] - To[:3, 3]).max() < 2.5e-3
        assert (T.good.numpy() == np.asarray(O.good)).mean() >= 0.99

    R = tinit.initialize(TCAM, t(uv1), t(uv2), t(valid), torch.Generator().manual_seed(key))
    assert bool(R.ok) and bool(R.is_homography) == planar
    t_est, t_true = R.t_21.numpy()[:3, 3], T2[:3, 3]
    cos = np.dot(t_est, t_true) / (np.linalg.norm(t_est) * np.linalg.norm(t_true))
    assert cos > (0.98 if planar else 0.99)
    assert rel_rot_err(R.t_21.numpy()[:3, :3], T2[:3, :3]) < (0.02 if planar else 0.01)
    if not planar:
        assert int(R.good.sum()) > 150


def test_draw_indices():
    """The draw picks only valid entries, uniformly, and the same indices
    for the same generator state on any device."""
    valid = torch.zeros(1000, dtype=torch.bool)
    valid[::3] = True
    idx = tinit.draw_indices(valid, 4000, 8, torch.Generator().manual_seed(0))
    assert idx.shape == (4000, 8) and bool(valid[idx].all())
    counts = torch.bincount(idx.reshape(-1), minlength=1000)[valid]
    assert counts.float().std() / counts.float().mean() < 0.15   # ~32 draws each
    again = tinit.draw_indices(valid, 4000, 8, torch.Generator().manual_seed(0))
    assert torch.equal(idx, again)
    none = tinit.draw_indices(torch.zeros(5, dtype=torch.bool), 3, 2, torch.Generator())
    assert none.shape == (3, 2) and bool(((none >= 0) & (none < 5)).all())


def test_kitti_floor_world_is_consistent():
    """`plane_world.KITTI_FLOOR`, the monocular chip phase's world: the rows
    below the wall's foot see the floor at depth floor/dy, and every pixel
    of frame 0 reappears in frame 1 where its depth projects it (the
    renderer and the depth map describe one scene); the other presets are
    unchanged by the floor."""
    from scipy.ndimage import map_coordinates

    from dsp_slam_rgbd_tpu_torch.tools import plane_world as pw

    w = pw.KITTI_FLOOR
    tex = pw.make_texture(w)
    d0 = pw.depth_map(w, 0.0).astype(np.float64)
    u = np.arange(w.w)[None, :] * np.ones((w.h, 1))
    v = np.arange(w.h)[:, None] * np.ones((1, w.w))
    dx, dy = (u - w.cx) / w.fx, (v - w.cy) / w.fx
    wall = w.plane_z / (1.0 - w.tilt * dx)
    floor = np.where(dy > 0, w.floor / np.maximum(dy, 1e-9), np.inf)
    np.testing.assert_allclose(d0, np.minimum(wall, floor), rtol=1e-6)
    assert 0.25 < (floor < wall).mean() < 0.5 and d0.min() > 6.0 and d0.max() > 17.0
    # frame 0's pixels warped into frame 1 by their depth
    X = dx * d0 - w.step
    u1, v1 = X / d0 * w.fx + w.cx, v
    img0, img1 = pw.render(w, tex, 0.0), pw.render(w, tex, pw.gt_x(w, 1))
    inside = (u1 > 1) & (u1 < w.w - 2)
    warped = map_coordinates(img1, [v1[inside], u1[inside]], order=1)
    err = np.abs(warped - img0[inside])
    assert np.median(err) < 0.5 and np.mean(err) < 1.0
    # the floor field defaults to none: KITTI is still the bare tilted plane
    assert pw.KITTI.floor == 0.0
    np.testing.assert_array_equal(pw.depth_map(pw.KITTI, 0.0),
                                  pw.depth_map(pw.KITTI_FLOOR._replace(floor=0.0, step=0.35),
                                               0.0))
