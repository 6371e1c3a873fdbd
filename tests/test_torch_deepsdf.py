"""The port's DeepSDF decoder module against the JAX package's, at the full
cars_64 width: same weights (carried with `decoder_from_numpy`), same
numpy inputs.  f32 tolerances: sdf atol 2e-5, Jacobian atol 2e-4 on rows
whose ReLU masks no summation order can flip (|pre| >= 1e-6, see
tests/test_torch_mlp_sdf.py); bf16 values atol 1e-2.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_slam_rgbd_tpu.models import deepsdf as jdeepsdf
from dsp_slam_rgbd_tpu_torch.models import deepsdf as tdeepsdf
from dsp_slam_rgbd_tpu_torch.ops.cuda import mlp_sdf
from dsp_slam_rgbd_tpu_torch.weights import decoder_from_numpy

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "ellipsoid_decoder_64.npz")
SDF_ATOL, JAC_ATOL, TIE = 2e-5, 2e-4, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def both():
    spec = jdeepsdf.DecoderSpec()
    params = jdeepsdf.init_params(spec, jax.random.PRNGKey(1))
    dec = decoder_from_numpy([(np.asarray(W), np.asarray(b)) for W, b in params["layers"]],
                             spec, device="cpu")
    return params, spec, dec


def _inputs(seed, n):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(64) * 0.2).astype(np.float32),
            (rng.standard_normal((n, 3)) * 0.5).astype(np.float32))


@pytest.mark.parametrize("kw", [{}, {"latent_size": 8, "dims": (32, 32, 32),
                                     "latent_in": (2,)}, {"latent_in": ()}])
def test_layer_dims_match_jax(kw):
    t = tdeepsdf.DecoderSpec(**kw).layer_dims()
    assert t == jdeepsdf.DecoderSpec(**kw).layer_dims()
    if not kw:
        assert t[3] == (512, 445)     # layer 3 makes room for the re-injection


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_and_sdf_match_jax(both, dtype):
    params, spec, dec = both
    code, xyz = _inputs(0, 200)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    atol = SDF_ATOL if dtype == "float32" else 1e-2
    inputs = np.concatenate([np.broadcast_to(code, (200, 64)), xyz], axis=1)
    np.testing.assert_allclose(
        dec.apply(torch.tensor(inputs), tdt).numpy(),
        np.asarray(jdeepsdf.apply(params, spec, jnp.asarray(inputs), jdt)), atol=atol)
    np.testing.assert_allclose(
        dec.sdf(torch.tensor(code), torch.tensor(xyz), tdt).numpy(),
        np.asarray(jdeepsdf.sdf(params, spec, jnp.asarray(code), jnp.asarray(xyz), jdt)),
        atol=atol)


def test_sdf_and_input_jacobian_matches_jax(both):
    params, spec, dec = both
    code, xyz = _inputs(1, 200)
    s_j, g_j = jdeepsdf.sdf_and_input_jacobian(params, spec, jnp.asarray(code),
                                               jnp.asarray(xyz))
    code, xyz = torch.tensor(code), torch.tensor(xyz)
    s_t, g_t = dec.sdf_and_input_jacobian(code, xyz)
    keep = (mlp_sdf.relu_margin(dec.packed(), code, xyz) >= TIE).numpy()
    assert keep.mean() >= 0.9
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=SDF_ATOL)
    np.testing.assert_allclose(g_t.numpy()[keep], np.asarray(g_j)[keep], atol=JAC_ATOL)


def test_plain_decoder_any_architecture_matches_jax():
    """A small non-cars_64 decoder takes the plain sweep (query) and
    matches JAX, Jacobian included (small widths: no near-ties)."""
    spec = jdeepsdf.DecoderSpec(latent_size=8, dims=(32, 32, 32), latent_in=(2,))
    params = jdeepsdf.init_params(spec, jax.random.PRNGKey(2))
    dec = decoder_from_numpy([(np.asarray(W), np.asarray(b)) for W, b in params["layers"]],
                             spec, device="cpu")
    rng = np.random.default_rng(2)
    code = (rng.standard_normal(8) * 0.3).astype(np.float32)
    xyz = (rng.standard_normal((40, 3)) * 0.5).astype(np.float32)
    s_j, g_j = jdeepsdf.sdf_and_input_jacobian(params, spec, jnp.asarray(code),
                                               jnp.asarray(xyz))
    s_t, g_t = dec.query_with_jacobian(torch.tensor(code), torch.tensor(xyz))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-5)
    np.testing.assert_allclose(dec.query(torch.tensor(code), torch.tensor(xyz)).numpy(),
                               np.asarray(s_j), atol=1e-5)


def test_load_npz_fixture_matches_jax():
    """The committed cars_64-layout fixture (fp16 storage) loads to the same
    weights and the same SDF in both packages."""
    params, spec = jdeepsdf.load_npz(FIXTURE)
    dec = tdeepsdf.load_npz(FIXTURE, device="cpu")
    assert tuple(dec.spec) == tuple(spec) and dec.fused
    for (Wt, bt), (Wj, bj) in zip(dec.layers, params["layers"]):
        np.testing.assert_array_equal(Wt.numpy(), np.asarray(Wj))
        np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    code, xyz = _inputs(3, 64)
    np.testing.assert_allclose(
        dec.query(torch.tensor(code), torch.tensor(xyz)).numpy(),
        np.asarray(jdeepsdf.sdf(params, spec, jnp.asarray(code), jnp.asarray(xyz))),
        atol=SDF_ATOL)


def test_save_npz_round_trip(tmp_path, both):
    params, spec, dec = both
    path = str(tmp_path / "dec.npz")
    tdeepsdf.save_npz(path, dec)
    back = tdeepsdf.load_npz(path, device="cpu")
    for (a, b), (c, d) in zip(dec.layers, back.layers):
        assert torch.equal(a, c) and torch.equal(b, d)
    jparams, jspec = jdeepsdf.load_npz(path)          # JAX reads the port's file
    assert tuple(jspec) == tuple(spec)
    np.testing.assert_array_equal(np.asarray(jparams["layers"][3][0]), dec.W3.numpy())


def test_load_torch_checkpoint_folds_weight_norm_like_jax(tmp_path):
    """A reference-format experiment dir with weight-normed layers and a
    DataParallel prefix loads to the same folded weights in both packages."""
    import json

    spec = {"CodeLength": 8, "NetworkSpecs": {"dims": [32, 32, 32], "latent_in": [2]}}
    rng = np.random.default_rng(4)
    state = {}
    for i, (d_in, d_out) in enumerate(jdeepsdf.DecoderSpec(
            latent_size=8, dims=(32, 32, 32), latent_in=(2,)).layer_dims()):
        state[f"module.lin{i}.weight_g"] = torch.tensor(rng.random((d_out, 1)) + 0.5,
                                                        dtype=torch.float32)
        state[f"module.lin{i}.weight_v"] = torch.tensor(rng.standard_normal((d_out, d_in)),
                                                        dtype=torch.float32)
        state[f"module.lin{i}.bias"] = torch.tensor(rng.standard_normal(d_out),
                                                    dtype=torch.float32)
    os.makedirs(tmp_path / "ModelParameters")
    with open(tmp_path / "specs.json", "w") as f:
        json.dump(spec, f)
    torch.save({"model_state_dict": state}, tmp_path / "ModelParameters" / "latest.pth")
    jparams, jspec = jdeepsdf.load_torch_checkpoint(str(tmp_path))
    dec = tdeepsdf.load_torch_checkpoint(str(tmp_path), device="cpu")
    assert tuple(dec.spec) == tuple(jspec)
    for (Wt, bt), (Wj, bj) in zip(dec.layers, jparams["layers"]):
        np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), atol=1e-6)
        np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=0)


def test_decoder_repacks_on_move(both):
    """The packed kernel weights follow the module across `.to()`."""
    _, _, dec = both
    moved = tdeepsdf.init_decoder(seed=0, device="cpu").to(torch.float32)
    assert moved.packed()[1].device == moved.W1.device
    w0, W, b = dec.packed(torch.bfloat16)
    np.testing.assert_array_equal(W.float().numpy(),
                                  dec.packed()[1].to(torch.bfloat16).float().numpy())


def test_decoder_from_numpy_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    spec = tdeepsdf.DecoderSpec(latent_size=8, dims=(16,), latent_in=())
    layers = [(np.zeros((11, 16), np.float32), np.zeros(16, np.float32)),
              (np.zeros((16, 1), np.float32), np.zeros(1, np.float32))]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decoder_from_numpy(layers, spec)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdeepsdf.load_npz(FIXTURE)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdeepsdf.init_decoder(spec)
    assert decoder_from_numpy(layers, spec, device="cpu").device.type == "cpu"
