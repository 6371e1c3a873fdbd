"""The fused decoder at DeepSDF's published ShapeNet layout (latent 256,
8 x 512, latent_in (4,), final tanh; `examples/chairs/specs.json`), at full
widths and few rows.

On the CPU the port's wrappers run their plain versions on the 256 packed
layout; they are held to the decoder's layer-by-layer sweep, to the
benchmark's plain reference (`benchmark/reference/decoder.py`) and to the
JAX package's XLA decoder.  On the card the 256 kernels (bf16 with the
code's products folded per code, f32 FMA) are held to the plain versions.
Tolerances, each with its reason:
  * f32: sdf atol 2e-5, Jacobian atol 2e-4 relative to the largest entry
    (test_torch_mlp_sdf.py's at 64): only the f32 summation order differs;
    on the card rows within 1e-6 of a ReLU tie are left out (another order
    may take the other side of the mask, and so change that row's
    Jacobian; at most 10% of rows);
  * bf16: every product's operands are rounded to bf16 at the same places,
    so only the f32 summation order differs, and it can flip the bf16
    rounding of an activation: sdf atol 1e-2, Jacobian Frobenius relative
    error 2e-2 (the 64 layout's).  The decoder's own sweep also rounds the
    last layer's output before tanh, hence its sdf atol 1e-2.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dsp_slam_rgbd_tpu_torch.models import deepsdf
from dsp_slam_rgbd_tpu_torch.ops.cuda import mlp_sdf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = deepsdf.DecoderSpec(latent_size=256)
BF = torch.bfloat16
SDF_ATOL, JAC_ATOL = 2e-5, 2e-4
BF16_SDF_ATOL, BF16_JAC_FROB = 1e-2, 2e-2
TIE = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def dec():
    return deepsdf.init_decoder(SPEC, seed=0, device="cpu")


def _inputs(form, n, rng, objects=3):
    """(code, xyz) float32 for a shared (256,), per-row (n, 256) or
    per-object (objects, 256) code over n rows (per object: n an object)."""
    if form == "shared":
        code, xyz = rng.standard_normal(256), rng.standard_normal((n, 3))
    elif form == "per-row":
        code, xyz = rng.standard_normal((n, 256)), rng.standard_normal((n, 3))
    else:
        code, xyz = rng.standard_normal((objects, 256)), rng.standard_normal((objects, n, 3))
    return (torch.tensor(np.asarray(a * s, np.float32)) for a, s in ((code, 0.2), (xyz, 0.5)))


def _frob(a, b):
    return float((a - b).norm() / b.norm())


def test_layout_is_the_kernels_and_packs(dec):
    lay = mlp_sdf.LAYOUTS[256]
    assert dec.fused and mlp_sdf.compatible(SPEC)
    assert (lay.in_dim, lay.split, lay.in_pad, lay.fold) == (259, 253, 384, True)
    w0, W, b = dec.packed()
    assert tuple(w0.shape) == (384, 512) and float(w0[259:].abs().max()) == 0.0
    assert float(W[2, :, 253:].abs().max()) == 0.0          # layer 3: 253 real outputs
    np.testing.assert_array_equal(W[3].numpy(), dec.W4.numpy())   # layer 4 takes 512 rows
    assert dec.value_tiles.numel() * 2 == lay.value_stages * mlp_sdf.VALUE_STAGE_BYTES
    assert lay.value_skip == (4, 3) and lay.value_stages == 54   # xyz's, 56 of W[0..6] - 3
    assert dec.backward_tiles.numel() * 2 == lay.backward_bytes == \
        56 * 65536 + 8 * 64 * 320 * 2
    assert dec.value_tiles_f32.numel() == lay.f32_value_floats == 4 * (272 + 3584) * 128
    assert dec.backward_tiles_f32.numel() == lay.f32_backward_floats == 4 * 3584 * 128 + 512 * 384


def test_folded_value_stream_leaves_out_the_code_rows(dec):
    """The bf16 forward stream at 256: stage 0 holds w0's 3 xyz rows and
    zeros (the code's 256 rows are folded); then W[0..2] in 8 chunks each;
    W[3] (layer 4) in its chunks 0-3 and 7 only, since chunks 4-6 are rows
    of the folded code alone; then W[4..6]."""
    w0, W, _ = dec.packed(BF)
    stages = dec.value_tiles.reshape(54, 512, 8, 8)                 # (stage, n, chunk, 8)
    unswz = torch.stack([stages[:, i, (torch.arange(8) ^ (i % 8))] for i in range(512)], 1)
    unswz = unswz.reshape(54, 512, 64).float()                      # (stage, n, k)
    np.testing.assert_array_equal(unswz[0, :, :3].numpy(), w0[256:259].T.float().numpy())
    assert float(unswz[0, :, 3:].abs().max()) == 0.0
    chunks = [(layer, c) for layer in range(7) for c in range(8) if layer != 3 or c not in (4, 5, 6)]
    assert len(chunks) == 53
    for s, (layer, c) in enumerate(chunks, start=1):
        np.testing.assert_array_equal(unswz[s].numpy(),
                                      W[layer][64 * c:64 * c + 64].T.float().numpy())


def test_64_layout_streams_are_unchanged():
    """The 64 layout's packed weights and streams, byte for byte, as they
    were before the 256 layout was added (sha256 prefixes of a seeded
    decoder's)."""
    d = deepsdf.init_decoder(deepsdf.DecoderSpec(), seed=3, device="cpu")

    def h(t):
        return hashlib.sha256(t.contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()[:16]

    w0, W, b = d.packed()
    got = {"w0": h(w0), "W": h(W), "b": h(b), "value": h(d.value_tiles),
           "backward": h(d.backward_tiles), "value_f32": h(d.value_tiles_f32),
           "backward_f32": h(d.backward_tiles_f32)}
    assert got == {"w0": "c648130df086e703", "W": "a5ac1ffc3f8c9613", "b": "f7b586904e367814",
                   "value": "1e93a56099af7816", "backward": "9625e49607b0351c",
                   "value_f32": "9df3282e23ea2a1b", "backward_f32": "e2e33e316a3d2a9b"}


@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("form,n", [("shared", 200), ("per-row", 64), ("per-object", 70)])
def test_plain_versions_match_the_decoder_sweep(dec, dtype, form, n):
    """`query` / `query_with_jacobian` (the kernels' plain versions on the CPU)
    against `sdf` / `sdf_and_input_jacobian` (the layer-by-layer sweep)."""
    code, xyz = _inputs(form, n, np.random.default_rng(1))
    v = dec.query(code, xyz, dtype)
    s, g = dec.query_with_jacobian(code, xyz, dtype)
    s_d, g_d = dec.sdf_and_input_jacobian(code, xyz, dtype)
    assert g.shape == xyz.shape[:-1] + (259,)
    if dtype == torch.float32:
        np.testing.assert_allclose(s.numpy(), s_d.numpy(), atol=SDF_ATOL)
        np.testing.assert_allclose(v.numpy(), s_d.numpy(), atol=SDF_ATOL)
        np.testing.assert_allclose(g.numpy(), g_d.numpy(), atol=JAC_ATOL * float(g_d.abs().max()))
    else:
        np.testing.assert_allclose(s.numpy(), s_d.numpy(), atol=BF16_SDF_ATOL)
        np.testing.assert_allclose(v.numpy(), s.numpy(), atol=0.0)
        assert _frob(g, g_d) <= BF16_JAC_FROB


@pytest.mark.parametrize("precision,dtype", [("f32", torch.float32), ("bf16", BF)])
def test_plain_versions_match_the_benchmark_reference(dec, tmp_path, precision, dtype):
    """Against `benchmark/reference/decoder.py::PlainDecoder`, which reads the
    decoder's npz itself, per-object codes as the fits query."""
    from benchmark.reference.decoder import PlainDecoder

    path = str(tmp_path / "dec256.npz")
    deepsdf.save_npz(path, dec)
    ref = PlainDecoder(path, "cpu", precision)
    code, xyz = _inputs("per-object", 100, np.random.default_rng(2), objects=2)
    s, g = dec.query_with_jacobian(code, xyz, dtype)
    v = dec.query(code, xyz, dtype)
    s_r, g_r = ref.value_and_jacobian(code, xyz)
    v_r = ref.value(code, xyz)
    tol = SDF_ATOL if dtype == torch.float32 else BF16_SDF_ATOL
    assert float((v - v_r).abs().max()) <= tol and float((s - s_r).abs().max()) <= tol
    if dtype == torch.float32:
        assert float((g - g_r).abs().max()) <= JAC_ATOL * float(g_r.abs().max())
    else:
        assert _frob(g, g_r) <= BF16_JAC_FROB


@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_plain_versions_match_the_jax_decoder(dec, dtype):
    """Against the JAX package's XLA `sdf` and `sdf_and_input_jacobian` at the
    same weights.  In bf16 the values: JAX's `apply` rounds each layer's
    operands to bf16 as the plain versions do, and its output too."""
    import jax.numpy as jnp

    from dsp_slam_rgbd_tpu.models import deepsdf as jdeepsdf

    jspec = jdeepsdf.DecoderSpec(latent_size=256)
    params = {"layers": [(jnp.asarray(W.numpy()), jnp.asarray(b.numpy())) for W, b in dec.layers]}
    code, xyz = _inputs("shared", 120, np.random.default_rng(3))
    jc, jx = jnp.asarray(code.numpy()), jnp.asarray(xyz.numpy())
    if dtype == BF:
        v = dec.query(code, xyz, BF)
        v_j = np.asarray(jdeepsdf.sdf(params, jspec, jc, jx, compute_dtype=jnp.bfloat16))
        np.testing.assert_allclose(v.numpy(), v_j, atol=BF16_SDF_ATOL)
        return
    s, g = dec.query_with_jacobian(code, xyz)
    s_j = np.asarray(jdeepsdf.sdf(params, jspec, jc, jx))
    s_j2, g_j = (np.asarray(a) for a in jdeepsdf.sdf_and_input_jacobian(params, jspec, jc, jx))
    np.testing.assert_allclose(s.numpy(), s_j, atol=SDF_ATOL)
    np.testing.assert_allclose(s.numpy(), s_j2, atol=SDF_ATOL)
    np.testing.assert_allclose(g.numpy(), g_j, atol=JAC_ATOL * float(np.abs(g_j).max()))


def test_other_layouts_take_the_sweep_and_errors_name_both():
    spec = deepsdf.DecoderSpec(latent_size=128)
    d = deepsdf.init_decoder(spec, seed=0, device="cpu")
    assert not mlp_sdf.compatible(spec) and not d.fused
    with pytest.raises(ValueError, match="latent 64.*latent 256"):
        mlp_sdf.pack_params(d.layers, spec)
    with pytest.raises(ValueError, match="latent 64.*latent 256"):
        d.packed()
    code, xyz = _inputs("shared", 10, np.random.default_rng(4))
    with pytest.raises(ValueError, match="256 columns"):
        mlp_sdf.sdf_value_fused(deepsdf.init_decoder(SPEC, device="cpu").packed(), code[:64],
                                xyz)


# -- the fixture, DeepSDF's experiment format, the fit -------------------------

FIXTURE = os.path.join(ROOT, "tests", "fixtures", "ellipsoid_decoder_256.npz")
CELL = "recon_b128.deepsdf256"


def _load(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def _cell(iterations, objects=3, points=32, rays=64, **optimizer):
    """The benchmark cell's configuration at a test size on the CPU."""
    bench = _load("BENCHMARK.json")
    w = next(w for w in bench["workloads"] if w["name"] == CELL)
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    c = {"config": _load(cfg["file"]), "traffic": _load("benchmark", "traffic",
                                                        w["traffic"] + ".json"),
         "cell": _load("benchmark", "workloads", CELL + ".json")}
    c["config"]["optimizer"].update(num_iterations=iterations, **optimizer)
    c["traffic"].update(objects_per_batch=objects, points=points, rays=rays, pool_batches=1)
    c["cell"].update(check_objects=objects, trace_batches=1)
    return c


def _fit_gaps(c, seed):
    return _fit_run(c, seed)[1]


def _fit_run(c, seed):
    """(the fit_batches run, its numbers): the window's fit and the reference's,
    compared as the benchmark does, on one thread (`_one_thread`)."""
    from benchmark.drivers import fit_batches

    with _one_thread():
        d = fit_batches.Driver(ROOT, c["config"], c["traffic"], c["cell"], seed,
                               torch.device("cpu"))
        d.window(0.0)
        d.release()
        return d, d.check()


@contextlib.contextmanager
def _one_thread():
    """PyTorch 2.13's CPU batched LU (`torch.linalg.solve_ex` over 2 or more
    systems of ~150 unknowns or more, MKL) fails in SLASWP with more than
    one thread.  The port's fit guards its own solve on the CPU
    (`normal_solve.solve_batched`); the reference (`benchmark/reference/
    recon.py`) solves the same systems and does not."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def test_fixture_loads_on_the_kernel_route():
    """The cell's trained fixture: the configuration's sha256, the 256
    layout, `fused`."""
    cfg = _load("benchmark", "configs", "shapenet_deepsdf256_gpu_fast.json")
    with open(FIXTURE, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == cfg["decoder"]["weights_sha256"]
    d = deepsdf.load_npz(FIXTURE, device="cpu")
    assert d.spec == SPEC and d.fused
    assert cfg["decoder"]["latent_size"] == cfg["optimizer"]["code_len"] == 256


def test_deepsdf_experiment_dir_loads_on_the_kernel_route(tmp_path):
    """A DeepSDF experiment directory as `examples/chairs` lays it out
    (`specs.json`, weight-normed `lin{i}` layers in
    `ModelParameters/latest.pth`) loads through `load_torch_checkpoint` with
    the weight norm folded, and takes the kernel route."""
    specs = {"Description": "chairs", "NetworkArch": "deep_sdf_decoder", "CodeLength": 256,
             "NetworkSpecs": {"dims": [512] * 8, "dropout": list(range(8)),
                              "dropout_prob": 0.2, "norm_layers": list(range(8)),
                              "latent_in": [4], "xyz_in_all": False, "use_tanh": False,
                              "latent_dropout": False, "weight_norm": True}}
    (tmp_path / "specs.json").write_text(json.dumps(specs))
    (tmp_path / "ModelParameters").mkdir()
    gen = torch.Generator().manual_seed(7)
    state = {}
    for i, (n_in, n_out) in enumerate(SPEC.layer_dims()):
        state[f"module.lin{i}.weight_v"] = torch.randn(n_out, n_in, generator=gen)
        state[f"module.lin{i}.weight_g"] = torch.rand(n_out, 1, generator=gen) + 0.5
        state[f"module.lin{i}.bias"] = torch.randn(n_out, generator=gen) * 0.01
    torch.save({"epoch": 2000, "model_state_dict": state},
               tmp_path / "ModelParameters" / "latest.pth")
    d = deepsdf.load_torch_checkpoint(str(tmp_path), device="cpu")
    assert d.spec == SPEC and d.fused
    v, g = state["module.lin4.weight_v"], state["module.lin4.weight_g"]
    np.testing.assert_allclose(d.W4.numpy(), (g * v / v.norm(dim=1, keepdim=True)).T.numpy(),
                               rtol=1e-6, atol=1e-7)
    code, xyz = _inputs("per-object", 20, np.random.default_rng(8), objects=2)
    np.testing.assert_allclose(d.query(code, xyz).numpy(), d.sdf(code, xyz).numpy(),
                               atol=SDF_ATOL)


def test_one_gauss_newton_iteration_matches_the_reference():
    """One GN iteration of `reconstruct_objects_batched` on the 263-wide
    normal equations, against `benchmark/reference/recon.py` from the same
    inputs in the cell's bf16 (both round every product's operands alike):
    pose, code and loss within 1e-5 (the 64 cells' bound), no object
    judged otherwise."""
    g = _fit_gaps(_cell(1), 21)
    assert g["good_mismatch"] == 0 and g["nonfinite"] == 0, g
    assert max(g["pose_max"], g["code_max"], g["loss_max"]) <= 1e-5, g


def test_the_fit_solves_wide_systems_on_more_cpu_threads():
    """The port's batched solve of 263-wide systems on a CPU with 4 threads
    (`ops/cuda/normal_solve.py::solve_batched`, the CPU route's solve): in a
    child process with a time limit,
    since PyTorch 2.13's threaded CPU batched LU hangs on such systems.  It
    returns the single-system solves' answers, with the caller's thread
    count left as it was."""
    script = (
        "import torch\n"
        "from dsp_slam_rgbd_tpu_torch.ops.cuda import normal_solve\n"
        "torch.set_num_threads(4)\n"
        "g = torch.Generator().manual_seed(0)\n"
        "A = torch.randn(3, 263, 263, generator=g)\n"
        "H = A @ A.transpose(1, 2) + 263 * torch.eye(263)\n"
        "b = torch.randn(3, 263, generator=g)\n"
        "dx, info = normal_solve.solve_batched(H, b)\n"
        "one = torch.stack([torch.linalg.solve(H[i], b[i]) for i in range(3)])\n"
        "assert int(info.abs().max()) == 0 and torch.get_num_threads() == 4\n"
        "print(float((dx - one).abs().max() / one.abs().max()))\n")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=60, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    # f32 LU of well-conditioned systems, another blocking than the single solves'
    assert float(out.stdout.split()[-1]) <= 1e-5, out.stdout


def test_ten_iteration_fit_stays_with_the_reference():
    """The cell's 10-iteration fit at scale_damping 20 (which damps the
    scale) of 4 objects, port and reference from the same inputs: both
    converge, and to the same mean translation error from the truth.  Their
    objects do not stay together one by one: the first iteration agrees
    bit for bit (above), but the later ones carry the two sides' other
    orders of summation (the render term's cumulative sums, the compaction)
    through bf16 rounding, and the trained decoder's fits amplify that
    (seeds 5 and 7 part by up to 0.07 in pose and 0.2 in loss on single
    objects; tests/test_reference_parity.py shows the same at 64, and the
    benchmark holds means over 256 objects).  Seeds 5, 7, 8, 9, 11, 12 and
    22 read: converged error at most 0.751 of the initial (22), port and
    reference apart by at most 0.043 of it (12)."""
    c = _cell(10, objects=4, scale_damping=20.0)
    d, g = _fit_run(c, 22)
    assert g["good_mismatch"] == 0 and g["nonfinite"] == 0, g
    with _one_thread():
        T_ref = d._reference([(0, o) for o in range(4)],
                             c["config"]["precision"]["reference"], "f32")[0]
    truth = d.pool_np[0]
    err = {k: float(np.linalg.norm(np.asarray(T, np.float64)[:, :3, 3]
                                   - truth["T_gt"][:, :3, 3], axis=1).mean())
           for k, T in (("init", truth["T_init"]), ("port", d.results[0][1][0].cpu()),
                        ("reference", T_ref.cpu()))}
    assert max(err["port"], err["reference"]) <= 0.9 * err["init"], err
    assert abs(err["port"] - err["reference"]) <= 0.1 * err["init"], err


# -- on the card ------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["shared", "per-row", "per-object"])
def test_kernels_256_match_plain_on_card(dtype, form):
    """Both 256 kernels against their plain versions at row counts around
    the 64-row tile and past a wave, none a multiple of 64 but one: the
    values, and the Jacobian (bf16: Frobenius; f32: entries, rows off ReLU
    ties).  The bf16 Jacobian kernel reports the ReLU masks it took: the
    plain reverse sweep under them must give its Jacobian."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt = getattr(torch, dtype)
    d = deepsdf.init_decoder(SPEC, seed=0, device="cuda")
    wb = d.packed(dt)
    rng = np.random.default_rng(5)
    for n in (1, 63, 64, 65, 200, 2049):
        code, xyz = (t.cuda() for t in _inputs(form, n, rng))
        v = mlp_sdf.sdf_value_fused(wb, code, xyz, dt, d.tiles(dt))
        relu = (torch.empty(xyz.shape[:-1] + (8, 512), dtype=torch.uint8, device="cuda")
                if dt == BF else None)
        s, g = mlp_sdf.sdf_and_input_jacobian_fused(wb, code, xyz, dt, d.tiles(dt, True),
                                                    masks_out=relu)
        s_p, g_p = mlp_sdf.sdf_and_input_jacobian_plain(wb, code, xyz, dt)
        torch.cuda.synchronize()
        atol = SDF_ATOL if dt == torch.float32 else BF16_SDF_ATOL
        assert float((v - s_p).abs().max()) <= atol, (n, form)
        assert float((s - s_p).abs().max()) <= atol, (n, form)
        if dt == torch.float32:
            keep = mlp_sdf.relu_margin(wb, code, xyz) >= TIE
            assert float(keep.float().mean()) >= 0.9
            err = float((g - g_p)[keep].abs().max()) if bool(keep.any()) else 0.0
            assert err <= JAC_ATOL * float(g_p.abs().max()), (n, form, err)
        else:
            _, g_m = mlp_sdf.sdf_and_input_jacobian_plain(wb, code, xyz, dt, masks=relu)
            assert _frob(g, g_m) <= BF16_JAC_FROB, (n, form)


@pytest.mark.cuda
def test_kernels_256_launch_figures_on_card():
    """The built 256 kernels' figures: no spills, the tensor-core kernels'
    shared memory as mlp_sdf_tc.cuh lays it out (value: ring, activations,
    layer 8's column, no row tile; Jacobian: as at 64, the row tile's 16 KB
    now the masks of layers 4..7), and the f32 launcher's tilings."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    v, j = mlp_sdf.value_kernel_config(256), mlp_sdf.jacobian_kernel_config(256)
    assert v["smem_bytes"] == 1024 + 65536 + 2 * 65536 + 1024 + 32
    assert j["smem_bytes"] == mlp_sdf.jacobian_kernel_config(64)["smem_bytes"] == 231712
    assert v["local_bytes"] == j["local_bytes"] == 0
    f32 = mlp_sdf.f32_kernel_config(256)
    assert all(c["local_bytes"] == 0 for kind in f32.values() for c in kind)
    for kind in ("value", "jacobian"):
        for n in (2048, 131072):
            assert mlp_sdf.f32_tiling(kind, n, 256) in mlp_sdf.F32_TILINGS

