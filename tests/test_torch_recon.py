"""The port's reconstruction losses and Gauss-Newton optimizer against the
JAX package, with the same weights and the same numpy inputs.

Tolerances, each with its reason:
  * loss terms on a small plain decoder (no near-tie ReLUs): atol 1e-5 on
    values, 1e-4 on Jacobians;
  * loss terms at cars_64 width: values atol 2e-5; Jacobians by Frobenius
    relative error 1e-2 (a row whose ReLU pre-activation is within f32
    rounding of 0 may take the other mask in another summation order);
  * one GN iteration through the kernels' route vs the JAX package's Pallas
    route (interpret mode): pose and code atol 2e-3, test_pallas_mlp.py's;
  * the trained fixture decoder: test_trained_decoder_recon.py's bands.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_slam_rgbd_tpu.models import deepsdf as jdeepsdf
from dsp_slam_rgbd_tpu.ops.pallas import mlp_sdf as jmlp
from dsp_slam_rgbd_tpu.recon import losses as jlosses
from dsp_slam_rgbd_tpu.recon import optimizer as jopt
from dsp_slam_rgbd_tpu_torch.models import deepsdf as tdeepsdf
from dsp_slam_rgbd_tpu_torch.recon import losses as tlosses
from dsp_slam_rgbd_tpu_torch.recon import optimizer as topt
from dsp_slam_rgbd_tpu_torch.tools.ellipsoid import make_problem, pose_errors
from dsp_slam_rgbd_tpu_torch.weights import decoder_from_numpy

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "ellipsoid_decoder_64.npz")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _pair(spec, seed, last_scale=1.0):
    """(JAX params, the port's decoder) with the same weights."""
    params = jdeepsdf.init_params(spec, jax.random.PRNGKey(seed))
    layers = [(np.asarray(W), np.asarray(b)) for W, b in params["layers"]]
    layers[-1] = (layers[-1][0] * last_scale, layers[-1][1])
    params = {"layers": [(jnp.asarray(W), jnp.asarray(b)) for W, b in layers]}
    return params, decoder_from_numpy(layers, spec, device="cpu")


SMALL = jdeepsdf.DecoderSpec(latent_size=64, dims=(96, 96, 96, 96), latent_in=(2,))


@pytest.fixture(scope="module")
def small():
    return (SMALL,) + _pair(SMALL, 0)


@pytest.fixture(scope="module")
def cars():
    spec = jdeepsdf.DecoderSpec()
    return (spec,) + _pair(spec, 0)


def _t(x, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _scene(seed, n_pts=48, n_rays=24, depth=6.0, scale=1.0):
    """An object `depth` m ahead: pose, surface points, rays and depths."""
    rng = np.random.default_rng(seed)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] *= scale
    T[:3, 3] = [0.05, -0.03, depth]
    pts = (rng.standard_normal((n_pts, 3)) * 0.4 * scale + T[:3, 3]).astype(np.float32)
    rays = (rng.standard_normal((n_rays, 3)) * 0.05 + [0, 0, 1.0]).astype(np.float32)
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    dep = (depth - 0.5 * scale + rng.random(n_rays) * 0.3).astype(np.float32)
    fg = np.arange(n_rays) < (2 * n_rays) // 3
    return T, pts, rays, dep, fg


def _frob_rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / max(np.linalg.norm(np.asarray(b)),
                                                               1e-12)


# -- loss terms ---------------------------------------------------------------

@pytest.mark.parametrize("which", ["small", "cars"])
def test_compute_sdf_loss_matches_jax(which, request):
    spec, params, dec = request.getfixturevalue(which)
    T, pts, *_ = _scene(0)
    t_oc = np.linalg.inv(T).astype(np.float32)
    code = (np.random.default_rng(1).standard_normal(64) * 0.1).astype(np.float32)
    mask = np.arange(48) % 5 != 0
    j = jlosses.compute_sdf_loss(params, spec, jnp.asarray(pts), jnp.asarray(mask),
                                 jnp.asarray(t_oc), jnp.asarray(code))
    t = tlosses.compute_sdf_loss(dec, _t(pts), _t(mask), _t(t_oc), _t(code))
    np.testing.assert_allclose(t.res.numpy(), np.asarray(j.res), atol=2e-5)
    assert np.array_equal(t.mask.numpy(), np.asarray(j.mask))
    for a, b in ((t.jac_pose, j.jac_pose), (t.jac_code, j.jac_code)):
        if which == "small":
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
        else:
            assert _frob_rel(a.numpy(), b) <= 1e-2


def test_chord_sample_depths_match_jax_and_batch():
    T, _, rays, *_ = _scene(2)
    Ts = np.stack([T, T * np.array([[1.2], [1.2], [1.2], [1]], np.float32)])
    t_oc = np.linalg.inv(Ts).astype(np.float32)
    rays_b = np.stack([rays, rays[::-1].copy()])
    d_t, h_t = tlosses.chord_sample_depths(_t(t_oc), _t(rays_b), 9)
    for i in range(2):
        d_j, h_j = jlosses.chord_sample_depths(jnp.asarray(t_oc[i]), jnp.asarray(rays_b[i]), 9)
        assert np.array_equal(h_t[i].numpy(), np.asarray(h_j))
        hit = np.asarray(h_j)
        np.testing.assert_allclose(d_t[i].numpy()[hit], np.asarray(d_j)[hit], atol=2e-5)


def _render_args(seed, chord, M=10, lo=-1.0, hi=1.0):
    T, _, rays, dep, fg = _scene(seed)
    t_oc = np.linalg.inv(T).astype(np.float32)
    if chord:
        d, hit = jlosses.chord_sample_depths(jnp.asarray(t_oc), jnp.asarray(rays), M)
        sampled, mask = np.asarray(d), np.asarray(hit)
    else:
        sampled = np.linspace(6.0 + lo, 6.0 + hi, M).astype(np.float32)
        mask = np.ones(len(rays), bool)
    return t_oc, rays, mask, dep, sampled


def _check_render(t, j, small_decoder):
    np.testing.assert_allclose(t.res.numpy(), np.asarray(j.res), atol=2e-5)
    assert np.array_equal(t.mask.numpy(), np.asarray(j.mask))
    assert int(t.n_valid) == int(j.n_valid)
    np.testing.assert_allclose(t.res_ray.numpy(), np.asarray(j.res_ray), atol=2e-5)
    np.testing.assert_allclose(t.min_abs_sdf.numpy(), np.asarray(j.min_abs_sdf), atol=2e-5)
    for a, b in ((t.jac_pose, j.jac_pose), (t.jac_code, j.jac_code)):
        if small_decoder:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)
        else:
            assert _frob_rel(a.numpy(), b) <= 1e-2


@pytest.mark.parametrize("which,chord,cap", [
    ("small", True, 8192), ("small", False, 8192), ("small", False, 100),
    ("cars", True, 8192), ("cars", False, 120),
])
def test_compute_render_loss_matches_jax(which, chord, cap, request):
    spec, params, dec = request.getfixturevalue(which)
    t_oc, rays, mask, dep, sampled = _render_args(3, chord)
    code = (np.random.default_rng(4).standard_normal(64) * 0.1).astype(np.float32)
    kw = dict(th=0.05, max_grad_points=64, max_valid_samples=cap)
    j = jlosses.compute_render_loss(params, spec, jnp.asarray(rays), jnp.asarray(mask),
                                    jnp.asarray(dep), jnp.asarray(t_oc),
                                    jnp.asarray(sampled), jnp.asarray(code), **kw)
    t = tlosses.compute_render_loss(dec, _t(rays), _t(mask), _t(dep), _t(t_oc),
                                    _t(sampled), _t(code), **kw)
    _check_render(t, j, which == "small")


def test_render_loss_padding_repeats_sample_zero_like_jax():
    """`jnp.nonzero(size=K, fill_value=0)` pads with index 0, and `live`
    reads the mask there: when sample (ray 0, depth 0) is itself a gradient
    point, every padding slot repeats it as live.  The port keeps this."""
    params, dec = _pair(SMALL, 5, last_scale=1e-4)   # |sdf| << th everywhere
    t_oc, rays, mask, dep, sampled = _render_args(6, False, M=8, lo=-0.9, hi=1.2)
    code = np.zeros(64, np.float32)
    kw = dict(th=0.05, max_grad_points=400, max_valid_samples=8192)
    j = jlosses.compute_render_loss(params, SMALL, jnp.asarray(rays), jnp.asarray(mask),
                                    jnp.asarray(dep), jnp.asarray(t_oc),
                                    jnp.asarray(sampled), jnp.asarray(code), **kw)
    t = tlosses.compute_render_loss(dec, _t(rays), _t(mask), _t(dep), _t(t_oc),
                                    _t(sampled), _t(code), **kw)
    _check_render(t, j, True)
    live = t.mask.numpy()
    n_points = 24 * 8
    assert live.sum() == 400 > n_points           # padding counted as live
    np.testing.assert_array_equal(t.res.numpy()[n_points:], t.res.numpy()[0])


def test_compact_indices_matches_nonzero():
    rng = np.random.default_rng(7)
    m = rng.random((3, 50)) < 0.3
    got = tlosses.compact_indices(_t(m), 12, 99).numpy()
    for i in range(3):
        want = np.asarray(jnp.nonzero(jnp.asarray(m[i]), size=12, fill_value=99)[0])
        np.testing.assert_array_equal(got[i], want)


@pytest.mark.parametrize("aligned", [False, True])
def test_rotation_loss_matches_jax(aligned):
    x = np.zeros(7, np.float32) if aligned else \
        np.array([0.1, 0.2, -0.1, 0.3, -0.2, 0.25, 0.1], np.float32)
    T = np.asarray(jax.jit(lambda v: jnp.asarray(
        __import__("dsp_slam_rgbd_tpu.ops.lie", fromlist=["x"]).exp_sim3(v)))(x))
    T = T @ np.diag([1, -1, -1, 1]).astype(np.float32)   # object up = −y_cam
    J_j, r_j = jlosses.compute_rotation_loss_sim3(jnp.asarray(T))
    J_t, r_t = tlosses.compute_rotation_loss_sim3(_t(T))
    np.testing.assert_allclose(J_t.numpy(), np.asarray(J_j), atol=1e-6)
    np.testing.assert_allclose(float(r_t), float(r_j), atol=1e-6)
    if aligned:
        assert float(r_t) == 0.0 and float(J_t.abs().max()) == 0.0


def test_mean_sdf_loss_matches_jax(small):
    spec, params, dec = small
    rng = np.random.default_rng(10)
    pts = (rng.standard_normal((30, 3)) * 0.5).astype(np.float32)
    mask = rng.random(30) < 0.7
    code = (rng.standard_normal(64) * 0.1).astype(np.float32)
    j = jopt.mean_sdf_loss(params, spec, jnp.asarray(pts), jnp.asarray(mask),
                           jnp.asarray(code))
    t = topt.mean_sdf_loss(dec, _t(pts), _t(mask), _t(code))
    np.testing.assert_allclose(float(t), float(j), atol=1e-6)


# -- the optimizer ------------------------------------------------------------

def _pallas_mlp_problem():
    """test_pallas_mlp.py's one-iteration problem."""
    rng = np.random.default_rng(3)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.0, 0.0, 6.0]
    pts = (rng.standard_normal((64, 3)) * 0.4 + [0, 0, 6.0]).astype(np.float32)
    rays = (rng.standard_normal((32, 3)) * 0.03 + [0, 0, 1.0]).astype(np.float32)
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    depth = np.full(32, 6.0, np.float32)
    return (T, pts, np.ones(64, bool), rays, np.ones(32, bool), depth, np.ones(32, bool))


def test_one_gn_iteration_matches_jax_pallas_route(cars):
    spec, params, dec = cars
    args = _pallas_mlp_problem()
    base = dict(num_iterations=1, num_depth_samples=12, max_grad_points=256,
                max_valid_samples=512)
    rj = jopt.reconstruct_object(params, spec,
                                 jopt.ReconConfig(use_pallas=True, pallas_interpret=True,
                                                  **base),
                                 *(jnp.asarray(a) for a in args))
    rt = topt.reconstruct_object(dec, topt.ReconConfig(**base), *(_t(a) for a in args))
    np.testing.assert_allclose(rt.t_cam_obj.numpy(), np.asarray(rj.t_cam_obj), atol=2e-3)
    np.testing.assert_allclose(rt.code.numpy(), np.asarray(rj.code), atol=2e-3)
    assert bool(rt.is_good) == bool(rj.is_good)


def test_active_rays_keep_index_order_on_ties():
    """Equal scores (clamped residuals, interacting rays) come out in index
    order, as from `jax.lax.top_k`; `torch.topk` does not promise that."""
    rng = np.random.default_rng(8)
    R = 40
    res = np.where(rng.random(R) < 0.5, 0.30, -0.30).astype(np.float32)
    res[::7] = rng.random(len(res[::7])).astype(np.float32) * 0.1
    min_abs = np.where(rng.random(R) < 0.3, 0.001, 1.0).astype(np.float32)
    fg = rng.random(R) < 0.25
    ray_mask = rng.random(R) < 0.9
    th = 0.01
    interact = fg | (min_abs < 5.0 * th)
    score = np.where(ray_mask, 1e3 * interact + np.abs(res), -1.0).astype(np.float32)
    _, want = jax.lax.top_k(jnp.asarray(score), 20)
    got = topt.select_active_rays(_t(res)[None], _t(min_abs)[None], _t(fg)[None],
                                  _t(ray_mask)[None], th, 20)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


def test_batched_matches_per_object():
    """B objects in one batch give each object's own fit (trained decoder,
    where the fit is well conditioned, so summation-order noise stays
    small: atol 1e-4), through the coarse phase and the active-ray fine
    phase."""
    dec = tdeepsdf.load_npz(FIXTURE, device="cpu")
    cfg = topt.ReconConfig(num_iterations=3, num_depth_samples=10, max_grad_points=64,
                           coarse_iterations=1, coarse_samples=6, active_ray_fraction=0.5)
    probs = [make_problem(s) for s in (3, 4, 5)]
    stack = lambda k, sl: torch.stack([_t(p[k][sl]) for p in probs])
    T = stack("T_init", slice(None))
    pts, rays = stack("pts", slice(0, 32)), stack("rays", slice(None, None, 4))
    dep, fg = stack("depth", slice(None, None, 4)), stack("fg_mask", slice(None, None, 4))
    pm, rm = torch.ones(3, 32, dtype=torch.bool), torch.ones(3, 32, dtype=torch.bool)
    out = topt.reconstruct_objects_batched(dec, cfg, T, pts, pm, rays, rm, dep, fg)
    assert out.is_good.all()
    for i in range(3):
        one = topt.reconstruct_object(dec, cfg, T[i], pts[i], pm[i], rays[i], rm[i],
                                      dep[i], fg[i])
        np.testing.assert_allclose(out.t_cam_obj[i].numpy(), one.t_cam_obj.numpy(), atol=1e-4)
        np.testing.assert_allclose(out.code[i].numpy(), one.code.numpy(), atol=1e-4)
        assert bool(one.is_good)


def test_estimate_pose_cam_obj_matches_jax():
    params, spec = jdeepsdf.load_npz(FIXTURE)
    dec = tdeepsdf.load_npz(FIXTURE, device="cpu")
    p = make_problem(3)
    T = p["T_init"].copy()
    s = float(np.cbrt(np.linalg.det(T[:3, :3])))
    T[:3, :3] /= s
    pts, mask = p["pts"][:64], np.ones(64, bool)
    mask[::9] = False
    cfg_j, cfg_t = jopt.ReconConfig(), topt.ReconConfig()
    Tj, lj = jopt.estimate_pose_cam_obj(params, spec, cfg_j, jnp.asarray(T), s,
                                        jnp.asarray(pts), jnp.asarray(mask),
                                        jnp.asarray(p["code_gt"]))
    Tt, lt = topt.estimate_pose_cam_obj(dec, cfg_t, _t(T), s, _t(pts), _t(mask),
                                        _t(p["code_gt"]))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=2e-4)
    np.testing.assert_allclose(float(lt), float(lj), atol=1e-5)


# -- the trained fixture decoder (test_trained_decoder_recon.py's problem) ----

@pytest.fixture(scope="module")
def fixture_fits():
    """The port's faithful f32 fit and its precision-only bf16 fit of
    problem 3, and the JAX package's faithful fit of the same problem."""
    dec = tdeepsdf.load_npz(FIXTURE, device="cpu")
    p = make_problem(3)
    n = len(p["pts"])
    args = (p["T_init"], p["pts"], np.ones(n, bool), p["rays"], np.ones(n, bool),
            p["depth"], p["fg_mask"])
    faithful = topt.ReconConfig(num_iterations=10, max_grad_points=512)
    precision_only = topt.ReconConfig.gpu_fast(
        num_iterations=10, max_grad_points=512, coarse_iterations=0, coarse_samples=0,
        active_ray_fraction=1.0)
    f32 = topt.reconstruct_object(dec, faithful, *(_t(a) for a in args))
    bf16 = topt.reconstruct_object(dec, precision_only, *(_t(a) for a in args),
                                   compute_dtype=topt.FAST_DTYPE)
    params, spec = jdeepsdf.load_npz(FIXTURE)
    jf = jopt.reconstruct_object(params, spec, jopt.ReconConfig(num_iterations=10,
                                                                max_grad_points=512),
                                 *(jnp.asarray(a) for a in args))
    return p, f32, bf16, jf


def test_fixture_faithful_fit_converges(fixture_fits):
    p, f32, _, _ = fixture_fits
    t_err0 = np.linalg.norm(p["T_init"][:3, 3] - p["t_gt"])
    t_err, s_err, r_err = pose_errors(f32.t_cam_obj.numpy(), p)
    assert bool(f32.is_good)
    assert t_err < 0.65 * t_err0 and s_err < 0.10 and r_err < 12.0


def test_fixture_bf16_precision_preset_matches_faithful(fixture_fits):
    p, f32, bf16, _ = fixture_fits
    assert bool(bf16.is_good)
    d = np.abs(np.subtract(pose_errors(bf16.t_cam_obj.numpy(), p), pose_errors(f32.t_cam_obj.numpy(), p)))
    assert d[0] < 0.05 and d[1] < 0.05 and d[2] < 2.0


def test_fixture_faithful_fit_matches_jax(fixture_fits):
    """Ten f32 iterations on the trained decoder land where the JAX
    package's land: the same bands as bf16 vs f32."""
    p, f32, _, jf = fixture_fits
    d = np.abs(np.subtract(pose_errors(f32.t_cam_obj.numpy(), p),
                           pose_errors(np.asarray(jf.t_cam_obj), p)))
    assert d[0] < 0.05 and d[1] < 0.05 and d[2] < 2.0


# -- entry points ---------------------------------------------------------------

def test_entry_runs_on_cpu_and_raises_for_missing_card():
    from dsp_slam_rgbd_tpu_torch.entry import entry

    fn, args = entry(device="cpu")
    t, code, loss = fn(*args)
    assert t.shape == (4, 4) and code.shape == (64,)
    assert torch.isfinite(t).all() and torch.isfinite(loss)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry()


def test_incompatible_decoder_takes_the_plain_route():
    """A decoder of another architecture fits through the plain decoder."""
    _, dec = _pair(SMALL, 1)
    assert not dec.fused
    out = topt.reconstruct_object(dec, topt.ReconConfig(num_iterations=1, num_depth_samples=8,
                                                        max_grad_points=32),
                                  *(_t(a) for a in _pallas_mlp_problem()))
    assert torch.isfinite(out.t_cam_obj).all()
