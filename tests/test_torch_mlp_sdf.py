"""The port's fused-decoder module (`ops/cuda/mlp_sdf.py`) against the JAX
package's Pallas kernels, run in interpret mode on the CPU as
tests/test_pallas_mlp.py runs them, at the full cars_64 width.

On the CPU the port's wrappers run their plain PyTorch versions; those are
what the card's kernels are held to in chip_smoke.py.  Tolerances:
  * f32: sdf atol 2e-5, Jacobian atol 2e-4 (test_pallas_mlp.py's), on the
    rows whose ReLU pre-activations all keep |pre| >= 1e-6: nearer 0, two
    summation orders may disagree on the mask, and so on that row's
    Jacobian (at most 10% of rows are left out);
  * bf16 vs the Pallas kernel in bf16: both round at the same places and
    differ only in f32 summation order, which can flip a bf16 rounding of
    an activation; sdf atol 1e-2 and Jacobian Frobenius relative error 2e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_slam_rgbd_tpu.models import deepsdf as jdeepsdf
from dsp_slam_rgbd_tpu.ops.pallas import mlp_sdf as jmlp
from dsp_slam_rgbd_tpu_torch.models import deepsdf as tdeepsdf
from dsp_slam_rgbd_tpu_torch.ops.cuda import build, mlp_sdf
from dsp_slam_rgbd_tpu_torch.weights import decoder_from_numpy

SDF_ATOL, JAC_ATOL = 2e-5, 2e-4
BF16_SDF_ATOL, BF16_JAC_FROB = 1e-2, 2e-2
TIE, BF16_TIE = 1e-6, 1e-2


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def both():
    """(JAX params, JAX packed weights, the port's decoder) with one set of
    cars_64 weights."""
    spec = jdeepsdf.DecoderSpec()
    params = jdeepsdf.init_params(spec, jax.random.PRNGKey(0))
    dec = decoder_from_numpy([(np.asarray(W), np.asarray(b)) for W, b in params["layers"]],
                             spec, device="cpu")
    return params, jmlp.pack_params(params, spec), dec


def _inputs(seed, n, per_row=False):
    rng = np.random.default_rng(seed)
    code = (rng.standard_normal((n, 64) if per_row else 64) * 0.2).astype(np.float32)
    xyz = (rng.standard_normal((n, 3)) * 0.5).astype(np.float32)
    return code, xyz


def _untied(wb, code, xyz):
    """Rows whose ReLU masks no summation order can flip (see above)."""
    keep = mlp_sdf.relu_margin(wb, code, xyz).cpu() >= TIE
    assert keep.float().mean() >= 0.9
    return keep.numpy()


def _frob_rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("n,per_row", [(300, False), (37, True)])
def test_jacobian_plain_matches_pallas_f32(both, n, per_row):
    _, wb, dec = both
    code, xyz = _inputs(0, n, per_row)
    s_j, g_j = jmlp.sdf_and_input_jacobian_fused(wb, jnp.asarray(code), jnp.asarray(xyz),
                                                 interpret=True)
    code, xyz = torch.tensor(code), torch.tensor(xyz)
    s_t, g_t = mlp_sdf.sdf_and_input_jacobian_fused(dec.packed(), code, xyz)
    keep = _untied(dec.packed(), code, xyz)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=SDF_ATOL)
    np.testing.assert_allclose(g_t.numpy()[keep], np.asarray(g_j)[keep], atol=JAC_ATOL)


@pytest.mark.parametrize("n,per_row", [(700, False), (45, True)])
def test_value_plain_matches_pallas_f32(both, n, per_row):
    _, wb, dec = both
    code, xyz = _inputs(1, n, per_row)
    s_j = jmlp.sdf_value_fused(wb, jnp.asarray(code), jnp.asarray(xyz), interpret=True)
    s_t = mlp_sdf.sdf_value_fused(dec.packed(), torch.tensor(code), torch.tensor(xyz))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=SDF_ATOL)


def test_bf16_plain_matches_pallas_bf16(both):
    _, wb, dec = both
    code, xyz = _inputs(2, 256)
    bf = torch.bfloat16
    s_j, g_j = jmlp.sdf_and_input_jacobian_fused(
        wb, jnp.asarray(code), jnp.asarray(xyz), interpret=True,
        compute_dtype=jnp.bfloat16)
    s_t, g_t = mlp_sdf.sdf_and_input_jacobian_fused(
        dec.packed(bf), torch.tensor(code), torch.tensor(xyz), bf)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=BF16_SDF_ATOL)
    assert _frob_rel(g_t.numpy(), np.asarray(g_j)) <= BF16_JAC_FROB
    v_j = jmlp.sdf_value_fused(wb, jnp.asarray(code), jnp.asarray(xyz), interpret=True,
                               compute_dtype=jnp.bfloat16)
    v_t = mlp_sdf.sdf_value_fused(dec.packed(bf), torch.tensor(code), torch.tensor(xyz), bf)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=BF16_SDF_ATOL)


def test_bf16_close_to_f32(both):
    """test_pallas_mlp.py's bands: bf16 vs f32 row cosine ≥ 0.90 and
    Frobenius relative error ≤ 0.25 on the Jacobian, sdf atol 3e-2."""
    _, _, dec = both
    code, xyz = (torch.tensor(a) for a in _inputs(2, 256))
    s32, g32 = mlp_sdf.sdf_and_input_jacobian_fused(dec.packed(), code, xyz)
    s16, g16 = mlp_sdf.sdf_and_input_jacobian_fused(dec.packed(torch.bfloat16), code, xyz,
                                                    torch.bfloat16)
    np.testing.assert_allclose(s16.numpy(), s32.numpy(), atol=3e-2)
    jf, jb = g32.numpy(), g16.numpy()
    assert _frob_rel(jb, jf) <= 0.25
    cos = np.sum(jb * jf, 1) / (np.linalg.norm(jb, axis=1) * np.linalg.norm(jf, axis=1) + 1e-12)
    assert cos.min() >= 0.90


def test_per_object_codes_are_one_flat_batch(both):
    """(B, 64) codes over (B, N, 3) points: the same as per-row codes."""
    _, _, dec = both
    rng = np.random.default_rng(3)
    codes = torch.tensor(rng.standard_normal((3, 64)) * 0.3, dtype=torch.float32)
    xyz = torch.tensor(rng.standard_normal((3, 11, 3)) * 0.5, dtype=torch.float32)
    s_b, g_b = mlp_sdf.sdf_and_input_jacobian_fused(dec.packed(), codes, xyz)
    rows = codes[:, None].expand(3, 11, 64).reshape(-1, 64)
    s_r, g_r = mlp_sdf.sdf_and_input_jacobian_fused(dec.packed(), rows, xyz.reshape(-1, 3))
    assert s_b.shape == (3, 11) and g_b.shape == (3, 11, 67)
    np.testing.assert_allclose(s_b.reshape(-1).numpy(), s_r.numpy(), atol=1e-6)
    np.testing.assert_allclose(g_b.reshape(-1, 67).numpy(), g_r.numpy(), atol=1e-6)
    v_b = mlp_sdf.sdf_value_fused(dec.packed(), codes, xyz)
    np.testing.assert_allclose(v_b.reshape(-1).numpy(), s_r.numpy(), atol=1e-6)


def test_plain_versions_match_plain_decoder(both):
    """The kernels' plain versions and the decoder's layer-by-layer sweep
    compute one function (f32)."""
    _, _, dec = both
    code, xyz = (torch.tensor(a) for a in _inputs(4, 64))
    s_k, g_k = mlp_sdf.sdf_and_input_jacobian_plain(dec.packed(), code, xyz)
    s_d, g_d = dec.sdf_and_input_jacobian(code, xyz)
    np.testing.assert_allclose(s_k.numpy(), s_d.numpy(), atol=SDF_ATOL)
    np.testing.assert_allclose(g_k.numpy(), g_d.numpy(), atol=JAC_ATOL)


def test_pack_params_shapes_and_zero_padding(both):
    params, wb_j, dec = both
    w0, W, b = dec.packed()
    assert tuple(w0.shape) == (128, 512) and tuple(W.shape) == (8, 512, 512)
    assert tuple(b.shape) == (9, 512)
    assert float(w0[67:].abs().max()) == 0.0
    assert float(W[2, :, 445:].abs().max()) == 0.0     # layer-3 output padding
    assert float(W[7, :, 1:].abs().max()) == 0.0       # layer 8: one output column
    for t, j in zip((w0, W, b), wb_j):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    w0b, Wb, bb = dec.packed(torch.bfloat16)
    assert w0b.dtype == Wb.dtype == torch.bfloat16 and bb.dtype == torch.float32


def test_incompatible_decoder_raises():
    spec = tdeepsdf.DecoderSpec(dims=(128,) * 8)
    dec = tdeepsdf.init_decoder(spec, seed=0, device="cpu")
    assert not mlp_sdf.compatible(spec) and not dec.fused
    with pytest.raises(ValueError, match="cars/chairs_64"):
        mlp_sdf.pack_params(dec.layers, spec)
    with pytest.raises(ValueError, match="fused kernels"):
        dec.packed()


@pytest.mark.parametrize("bad", ["dtype", "shape", "code", "contiguous", "compute"])
def test_wrapper_rejects_bad_inputs(both, bad):
    _, _, dec = both
    code, xyz = (torch.tensor(a) for a in _inputs(5, 8))
    wb, dt = dec.packed(), torch.float32
    if bad == "dtype":
        xyz = xyz.double()
    elif bad == "shape":
        xyz = xyz[:, :2]
    elif bad == "code":
        code = code[:32]
    elif bad == "contiguous":
        xyz = torch.tensor(_inputs(5, 8)[1].T.copy()).T
    else:
        dt = torch.bfloat16          # f32 weights with a bf16 compute dtype
    with pytest.raises(ValueError):
        mlp_sdf.sdf_value_fused(wb, code, xyz, dt)


def test_module_imports_and_runs_without_nvcc(monkeypatch, both):
    """Importing the kernels and running them on CPU tensors needs no nvcc;
    asking for the library without one raises (nothing falls back)."""
    _, _, dec = both
    monkeypatch.setenv("NVCC", "/nonexistent/nvcc")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(build, "_lib", None)
    mlp_sdf.reset_launch_counts()
    code, xyz = (torch.tensor(a) for a in _inputs(6, 4))
    mlp_sdf.sdf_value_fused(dec.packed(), code, xyz)
    assert mlp_sdf.LAUNCHES == {"mlp_sdf_value": 0, "mlp_sdf_jacobian": 0,
                                "mlp_sdf_value_f32": 0, "mlp_sdf_jacobian_f32": 0}
    if not __import__("os").path.isfile("/usr/local/cuda/bin/nvcc"):
        with pytest.raises(build.KernelBuildError):
            build.load()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_on_card(dtype):
    """On the card: both kernels against their plain versions at ragged N.
    The bf16 Jacobian kernel also reports the ReLU masks it took: they must
    equal the plain version's away from ReLU ties (|pre| >= BF16_TIE, as in
    chip_smoke.py), and the plain reverse sweep under them must give the
    kernel's Jacobian."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt = getattr(torch, dtype)
    dec = tdeepsdf.init_decoder(tdeepsdf.DecoderSpec(), seed=0, device="cuda")
    code, xyz = (torch.tensor(a, device="cuda") for a in _inputs(7, 300, per_row=True))
    wb = dec.packed(dt)
    if dt == torch.float32:
        s_k, g_k = mlp_sdf.sdf_and_input_jacobian_fused(wb, code, xyz, dt,
                                                        dec.tiles(dt, jacobian=True))
    else:
        relu = torch.empty(300, 8, 512, dtype=torch.uint8, device="cuda")
        s_k, g_k = mlp_sdf.sdf_and_input_jacobian_fused(wb, code, xyz, dt, dec.jacobian_tiles,
                                                        masks_out=relu)
    s_p, g_p = mlp_sdf.sdf_and_input_jacobian_plain(wb, code, xyz, dt)
    v_k = mlp_sdf.sdf_value_fused(wb, code, xyz, dt, dec.tiles(dt))
    torch.cuda.synchronize()
    sdf_atol = SDF_ATOL if dt == torch.float32 else BF16_SDF_ATOL
    np.testing.assert_allclose(s_k.cpu().numpy(), s_p.cpu().numpy(), atol=sdf_atol)
    np.testing.assert_allclose(v_k.cpu().numpy(), s_p.cpu().numpy(), atol=sdf_atol)
    if dt == torch.float32:
        keep = _untied(wb, code, xyz)
        np.testing.assert_allclose(g_k.cpu().numpy()[keep], g_p.cpu().numpy()[keep],
                                   atol=JAC_ATOL)
    else:
        assert _frob_rel(g_k.cpu().numpy(), g_p.cpu().numpy()) <= BF16_JAC_FROB
        pre = mlp_sdf.relu_preactivations(wb, code, xyz, dt)
        assert int(((relu.bool() != (pre > 0)) & (pre.abs() >= BF16_TIE)).sum()) == 0
        _, g_m = mlp_sdf.sdf_and_input_jacobian_plain(wb, code, xyz, dt, masks=relu)
        assert _frob_rel(g_k.cpu().numpy(), g_m.cpu().numpy()) <= BF16_JAC_FROB
