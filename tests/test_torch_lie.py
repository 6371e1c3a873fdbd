"""The port's Lie-group and robust-norm functions against the JAX package.

Inputs are made with numpy from a seed and fed to both packages; every
comparison is in float32 at atol 1e-5 (rtol 1e-5) unless stated.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_slam_rgbd_tpu.ops import lie as jlie
from dsp_slam_rgbd_tpu.ops import robust as jrobust
from dsp_slam_rgbd_tpu_torch.ops import lie as tlie
from dsp_slam_rgbd_tpu_torch.ops import robust as trobust

ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(t_out, j_out, atol=ATOL):
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=atol, rtol=1e-5)


def _tangents(dim, seed):
    """Batch of tangents: generic, tiny (θ→0), exactly zero, zero rotation
    with translation/scale, and near-zero log-scale."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((8, dim)) * 0.6
    x[1] *= 1e-7
    x[2] = 0.0
    x[3, 3:6] = 0.0
    if dim == 7:
        x[4, 6] = 1e-8
        x[5, 3:6] = 1e-9
    return x.astype(np.float32)


@pytest.mark.parametrize("name,dim", [
    ("exp_so3", 3), ("so3_left_jacobian", 3), ("hat", 3),
    ("exp_se3", 6), ("exp_sim3", 7),
])
def test_exp_maps_match_jax(name, dim):
    x = _tangents(dim, 0)
    t_out = getattr(tlie, name)(torch.tensor(x))
    j_out = getattr(jlie, name)(jnp.asarray(x))
    assert torch.isfinite(t_out).all()
    _close(t_out, j_out)


@pytest.mark.parametrize("exp_name,log_name,dim", [
    ("exp_so3", "log_so3", 3), ("exp_se3", "log_se3", 6),
    ("exp_sim3", "log_sim3", 7),
])
def test_log_maps_match_jax_and_invert(exp_name, log_name, dim):
    x = _tangents(dim, 1)
    T = np.asarray(getattr(jlie, exp_name)(jnp.asarray(x)))
    t_out = getattr(tlie, log_name)(torch.tensor(T))
    assert torch.isfinite(t_out).all()
    _close(t_out, getattr(jlie, log_name)(jnp.asarray(T)), atol=2e-5)
    _close(t_out, x, atol=2e-5)   # log ∘ exp = id away from θ = π


def _sim3_mats(seed):
    x = _tangents(7, seed)
    x[:, :3] *= 5.0
    return np.asarray(jlie.exp_sim3(jnp.asarray(x)))


@pytest.mark.parametrize("name", ["inv_sim3", "sim3_scale", "vee"])
def test_sim3_matrix_functions_match_jax(name):
    T = _sim3_mats(2)
    arg = T[..., :3, :3] if name == "vee" else T
    _close(getattr(tlie, name)(torch.tensor(arg)),
           getattr(jlie, name)(jnp.asarray(arg)), atol=3e-5)


@pytest.mark.parametrize("name", ["inv_se3", "adjoint_se3", "orthonormalize_se3"])
def test_se3_matrix_functions_match_jax(name):
    T = np.asarray(jlie.exp_se3(jnp.asarray(_tangents(6, 3))))
    _close(getattr(tlie, name)(torch.tensor(T)),
           getattr(jlie, name)(jnp.asarray(T)), atol=3e-5)


def test_transform_points_matches_jax_and_batches():
    T = _sim3_mats(4)
    rng = np.random.default_rng(4)
    pts = rng.standard_normal((8, 5, 3)).astype(np.float32)
    batched = tlie.transform_points(torch.tensor(T), torch.tensor(pts))
    for i in range(8):
        _close(batched[i], jlie.transform_points(jnp.asarray(T[i]), jnp.asarray(pts[i])),
               atol=3e-5)


@pytest.mark.parametrize("name", ["points_to_pose_jacobian_se3",
                                  "points_to_pose_jacobian_sim3"])
def test_point_jacobians_match_jax(name):
    pts = np.random.default_rng(5).standard_normal((6, 3)).astype(np.float32)
    _close(getattr(tlie, name)(torch.tensor(pts)),
           getattr(jlie, name)(jnp.asarray(pts)))


def test_quaternions_match_jax():
    rng = np.random.default_rng(6)
    q = rng.standard_normal((16, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    R = tlie.quat_to_rot(torch.tensor(q))
    _close(R, jlie.quat_to_rot(jnp.asarray(q)))
    _close(tlie.rot_to_quat(R), jlie.rot_to_quat(jnp.asarray(R.numpy())), atol=2e-5)


def test_cbrt_is_real_cube_root():
    x = np.array([-27.0, -1e-9, 0.0, 1e-9, 8.0], np.float32)
    _close(tlie.cbrt(torch.tensor(x)), jnp.cbrt(jnp.asarray(x)))


def test_huber_weights_match_jax():
    r = np.abs(np.random.default_rng(7).standard_normal(64)).astype(np.float32)
    r[0] = 0.0
    _close(trobust.huber_weights(torch.tensor(r), 0.2),
           jrobust.huber_weights(jnp.asarray(r), 0.2))


@pytest.mark.parametrize("masked", [False, True])
def test_robust_residuals_match_jax(masked):
    rng = np.random.default_rng(8)
    res = (rng.standard_normal(50) * 0.1).astype(np.float32)
    mask = rng.random(50) < 0.6 if masked else None
    t = trobust.robust_residuals(torch.tensor(res), 0.025,
                                 None if mask is None else torch.tensor(mask))
    j = jrobust.robust_residuals(jnp.asarray(res), 0.025,
                                 None if mask is None else jnp.asarray(mask))
    for a, b in zip(t, j):
        _close(a, b)


def test_robust_residuals_batch_rows_are_independent():
    rng = np.random.default_rng(9)
    res = (rng.standard_normal((3, 20)) * 0.1).astype(np.float32)
    mask = rng.random((3, 20)) < 0.5
    rr, loss, _ = trobust.robust_residuals(torch.tensor(res), 0.05,
                                           torch.tensor(mask))
    for i in range(3):
        jr, jl, _ = jrobust.robust_residuals(jnp.asarray(res[i]), 0.05,
                                             jnp.asarray(mask[i]))
        _close(rr[i], jr)
        _close(loss[i], jl)


def test_tukey_weights_match_jax():
    r = np.abs(np.random.default_rng(10).standard_normal(32)).astype(np.float32)
    _close(trobust.tukey_weights(torch.tensor(r), 1.0),
           jrobust.tukey_weights(jnp.asarray(r), 1.0))
