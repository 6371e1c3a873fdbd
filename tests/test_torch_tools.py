"""The port's aux tools (`dsp_slam_rgbd_tpu_torch/tools/`) against the JAX
package's (`tools/`), on the CPU.

Each test runs the JAX tool's `main` (with `sys.argv` patched, imported
from `tools/` as tests/test_format_bridges.py does) and the port's
`main(argv)` with `--device cpu` on the same inputs:
  * evaluate_ate: KITTI and TUM, with and without `--scale`; the printed
    lines equal, the numbers within 1e-5 m of the JAX package's
    `align_trajectories` over the JAX tool's `load_traj`;
  * convert_reference_labels: equal npz arrays from synthesized `.lbl`
    files (a dict of boxes, a bare tensor, with and without LiDAR);
  * extract_map_objects and visualize_map: a narrow decoder npz written by
    the JAX package's `save_npz`; the same triangles in the same order,
    corners within 1e-4, on a map whose grid values all lie more than 1e-5
    from 0 (both packages take the same marching-tetrahedra cases); the port's PNG decodes with
    trajectory, point and object pixels set;
  * render_objects: on tests/test_torch_slam_system.py's sphere decoder,
    depth `.npy` within 2e-5 m on the hit pixels, equal hit masks; the port's MapObjects.txt reader gives its state.npz depths;
  * train_fixture_decoder: `ellipsoid_sdf` and `code_to_axes` at 1e-6; one
    Adam step from the same weights and batch against `optax.adam` on the
    JAX `deepsdf.apply` loss at 1e-5 relative; 30 narrow steps lower the
    loss; the written npz loads through both packages.
Every tool but the host-only label converter raises without a card
unless given `--device cpu`.  `kernel_repeat` (a check for the card only)
is tested on its bookkeeping: stand-ins for the kernel wrappers whose call
flips bits in some rows are reported with the call, rows, tile rows and
columns, and counted per kernel and tiling; `--csrc` points the build at
another directory.
"""
import importlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_slam_rgbd_tpu.models import deepsdf as jdeepsdf
from dsp_slam_rgbd_tpu_torch.models import deepsdf as tdeepsdf
from dsp_slam_rgbd_tpu_torch.system import png
from dsp_slam_rgbd_tpu_torch.tools import (
    convert_reference_labels as t_conv,
    evaluate_ate as t_ate,
    extract_map_objects as t_extract,
    kernel_repeat as t_repeat,
    render_objects as t_render,
    train_fixture_decoder as t_train,
    visualize_map as t_viz,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = jdeepsdf.DecoderSpec(latent_size=64, dims=(32,) * 4, latent_in=())


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two threads a test process: the suite runs in several processes at
    once, and more threads than cores make small ops spin."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def jax_tool(name):
    """The JAX package's tools/<name>.py as a module."""
    tools = os.path.join(ROOT, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    return importlib.import_module(name)


def run_jax(monkeypatch, name, *args):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *map(str, args)])
    return jax_tool(name).main()


# ---------------------------------------------------------------------------
# evaluate_ate

def _trajectories(tmp_path, fmt):
    rng = np.random.default_rng(5)
    n = 40
    gt = np.cumsum(rng.standard_normal((n, 3)) * [0.3, 0.05, 0.5], 0)
    th = 0.3
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
    est = 0.8 * gt @ R.T + [1.0, -0.5, 2.0] + rng.standard_normal((n, 3)) * 0.02
    paths = []
    for name, xyz in (("est", est[:-3]), ("gt", gt)):     # the estimate is shorter
        p = tmp_path / f"{name}_{fmt}.txt"
        if fmt == "kitti":
            rows = np.zeros((len(xyz), 12))
            rows[:, [0, 5, 10]] = 1.0
            rows[:, [3, 7, 11]] = xyz
        else:
            rows = np.concatenate([np.arange(len(xyz))[:, None] * 0.1, xyz,
                                   np.tile([0, 0, 0, 1.0], (len(xyz), 1))], 1)
        np.savetxt(p, rows, fmt="%.9f")
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("fmt", ["kitti", "tum"])
@pytest.mark.parametrize("scale", [False, True])
def test_evaluate_ate_matches_jax(tmp_path, monkeypatch, capsys, fmt, scale):
    from dsp_slam_rgbd_tpu.ops import lie as jlie
    from dsp_slam_rgbd_tpu.solvers import sim3 as jsim3

    est, gt = _trajectories(tmp_path, fmt)
    flags = ["--format", fmt] + (["--scale"] if scale else [])
    run_jax(monkeypatch, "evaluate_ate", est, gt, *flags)
    jax_lines = capsys.readouterr().out.splitlines()
    got = t_ate.main([est, gt, *flags, "--device", "cpu"])
    assert capsys.readouterr().out.splitlines() == jax_lines
    # the JAX tool's numbers at full precision
    jt = jax_tool("evaluate_ate")
    e, g = jt.load_traj(est, fmt), jt.load_traj(gt, fmt)
    n = min(len(e), len(g))
    T, ate = jsim3.align_trajectories(jnp.asarray(e[:n], jnp.float32),
                                      jnp.asarray(g[:n], jnp.float32), fix_scale=not scale)
    err = np.linalg.norm(np.asarray(jlie.transform_points(T, jnp.asarray(e[:n], jnp.float32)))
                         - g[:n], axis=1)
    assert got["n"] == n == 37
    for key, want in (("ate_rmse", float(ate)), ("mean", err.mean()),
                      ("median", np.median(err)), ("max", err.max())):
        assert abs(got[key] - want) <= 1e-5, (key, got[key], want)
    if scale:
        assert abs(got["scale"] - float(jlie.sim3_scale(T))) <= 1e-5
        assert abs(got["scale"] - 1.25) < 0.02
    else:
        assert "scale" not in got


# ---------------------------------------------------------------------------
# convert_reference_labels

def test_convert_reference_labels_matches_jax(tmp_path, monkeypatch):
    lbl = tmp_path / "lbl"
    velo = tmp_path / "velo"
    lbl.mkdir()
    velo.mkdir()
    boxes = np.asarray([[2.0, 1.5, 14.0, 4.0, 1.6, 1.8, 0.3],
                        [-3.0, 1.4, 22.0, 3.8, 1.5, 1.7, -1.2]], np.float32)
    torch.save({"boxes": torch.tensor(boxes)}, lbl / "000000.lbl")
    torch.save(torch.tensor(boxes[1:]), lbl / "000001.lbl")
    rng = np.random.default_rng(2)
    cloud = np.concatenate([rng.uniform([-5, 0, 5, 0], [5, 2, 25, 1], (4000, 4)),
                            rng.normal([2.0, 0.7, 14.0, 0.5], 0.6, (300, 4))]).astype(np.float32)
    cloud.tofile(velo / "000000.bin")     # frame 1 has no scan
    for args in ((), ("--velodyne", str(velo))):
        tag = "velo" if args else "plain"
        run_jax(monkeypatch, "convert_reference_labels", lbl, tmp_path / f"jax_{tag}", *args)
        counts = t_conv.main([str(lbl), str(tmp_path / f"port_{tag}"), *args])
        assert counts == {"000000": 2, "000001": 1}
        for stem in counts:
            with np.load(tmp_path / f"jax_{tag}" / f"{stem}.npz") as zj, \
                    np.load(tmp_path / f"port_{tag}" / f"{stem}.npz") as zt:
                assert sorted(zj.files) == sorted(zt.files)
                for k in zj.files:
                    np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
        with np.load(tmp_path / f"port_{tag}" / "000000.npz") as z:
            assert int(z["0_pts_mask"].sum()) > (100 if args else -1)


# ---------------------------------------------------------------------------
# extract_map_objects, visualize_map, render_objects: a narrow decoder

def _forward_np(layers, spec, x):
    inp = x
    for i, (W, b) in enumerate(layers):
        if i in spec.latent_in:
            x = np.concatenate([x, inp], -1)
        x = x @ W + b
        if i < len(layers) - 1:
            x = np.maximum(x, 0.0)
    return x[..., 0]


def _grid(n):
    from dsp_slam_rgbd_tpu_torch.models.mesh import create_voxel_grid

    return create_voxel_grid(n).numpy()


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    """A narrow random decoder whose zero level set crosses the unit cube
    (the last bias puts 40% of code 0's grid inside), two object codes,
    and the decoder written by the JAX package (npz and experiment dir)."""
    rng = np.random.default_rng(337)   # the first seed from 11 with no grid value near 0
    layers = [((rng.standard_normal((i, o)) * np.sqrt(2.0 / i)).astype(np.float32),
               (rng.standard_normal(o) * 0.1).astype(np.float32))
              for i, o in NARROW.layer_dims()]
    codes = (rng.standard_normal((2, 64)) * 0.3).astype(np.float32)
    g32 = _grid(32)
    pre = _forward_np(layers, NARROW, np.concatenate([np.tile(codes[0], (len(g32), 1)), g32], 1))
    layers[-1] = (layers[-1][0], layers[-1][1] - np.float32(np.quantile(pre, 0.4)))
    for code in codes:      # no grid value near 0 at the voxel sizes the tools use
        for n in (16, 32):
            g = _grid(n)
            sdf = np.tanh(_forward_np(layers, NARROW,
                                      np.concatenate([np.tile(code, (len(g), 1)), g], 1)))
            assert np.abs(sdf).min() > 1e-5 and (sdf < 0).any() and (sdf > 0).any()
    return dict(_write_decoder(tmp_path_factory.mktemp("narrow"), layers, NARROW), codes=codes)


def _write_decoder(d, layers, spec):
    """The decoder as an npz (the JAX package's `save_npz`) and as a
    reference experiment directory (specs.json and a torch state dict)."""
    params = {"layers": [(jnp.asarray(W), jnp.asarray(b)) for W, b in layers]}
    jdeepsdf.save_npz(str(d / "dec.npz"), params, spec)
    exp = d / "experiment"
    (exp / "ModelParameters").mkdir(parents=True)
    (exp / "specs.json").write_text(json.dumps({"CodeLength": spec.latent_size, "NetworkSpecs": {
        "dims": list(spec.dims), "latent_in": list(spec.latent_in)}}))
    torch.save({"model_state_dict": {k: v for i, (W, b) in enumerate(layers) for k, v in (
        (f"lin{i}.weight", torch.tensor(W.T.copy())), (f"lin{i}.bias", torch.tensor(b)))}},
        exp / "ModelParameters" / "latest.pth")
    return {"npz": str(d / "dec.npz"), "experiment": str(exp)}


def _write_map(d, codes, with_points=True):
    """MapObjects.txt (as `io.save_entire_map` writes it), MapPoints.txt and
    Cameras.txt."""
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(4)
    with open(d / "MapObjects.txt", "w") as f:
        for k, code in enumerate(codes):
            th = 0.4 * (k + 1)
            T = np.eye(4)
            T[:3, :3] = (1.5 + k) * np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                                              [-np.sin(th), 0, np.cos(th)]])
            T[:3, 3] = [2.0 * k - 1.0, 0.3, 10.0 + 3 * k]
            f.write(f"{3 * k + 1}\n" + " ".join(f"{v:.9f}" for v in T[:3].reshape(-1)) + "\n"
                    + " ".join(f"{v:.9f}" for v in code) + "\n")
    if with_points:
        np.savetxt(d / "MapPoints.txt", rng.uniform([-5, -1, 2], [5, 1, 20], (300, 3)),
                   fmt="%.9f")
        cams = np.zeros((12, 12))
        cams[:, [0, 5, 10]] = 1.0
        cams[:, 3] = np.linspace(0, 1.5, 12)
        cams[:, 11] = np.linspace(0, 4.0, 12)
        np.savetxt(d / "Cameras.txt", cams, fmt="%.9f")


def _read_ply(path):
    lines = open(path).read().splitlines()
    nv = int(next(ln for ln in lines if ln.startswith("element vertex")).split()[-1])
    nf = int(next(ln for ln in lines if ln.startswith("element face")).split()[-1])
    body = lines[lines.index("end_header") + 1:]
    v = np.array([ln.split()[:3] for ln in body[:nv]], np.float64).reshape(-1, 3)
    f = np.array([ln.split()[1:] for ln in body[nv:nv + nf]], np.int64).reshape(-1, 3)
    return v, f


def _same_mesh(port_ply, jax_ply, least=20):
    """The same triangles in the same order, corners within 1e-4.  Compared
    by the corners' coordinates: `marching_tetrahedra` welds vertices that
    agree to 6 decimals, and a corner 1e-7 from a rounding boundary may be
    welded in one package and not in the other, which renumbers vertices
    without moving a triangle."""
    vt, ft = _read_ply(port_ply)
    vj, fj = _read_ply(jax_ply)
    assert len(ft) == len(fj) > least
    np.testing.assert_allclose(vt[ft], vj[fj], atol=1e-4)
    return vt


def test_extract_map_objects_matches_jax(tmp_path, monkeypatch, narrow):
    for tag in ("jax", "port"):
        _write_map(tmp_path / tag, narrow["codes"], with_points=False)
    run_jax(monkeypatch, "extract_map_objects", tmp_path / "jax", narrow["npz"], "--voxels", 16)
    meshes = t_extract.main([str(tmp_path / "port"), narrow["npz"], "--voxels", "16",
                             "--device", "cpu"])
    assert sorted(meshes) == [1, 4]
    for oid in meshes:
        _same_mesh(tmp_path / "port" / "meshes" / f"{oid}.ply",
                   tmp_path / "jax" / "meshes" / f"{oid}.ply")
        np.testing.assert_array_equal(np.load(tmp_path / "port" / "meshes" / f"{oid}.npy"),
                                      np.load(tmp_path / "jax" / "meshes" / f"{oid}.npy"))
    # a reference experiment directory loads the same decoder
    t_extract.main([str(tmp_path / "port"), narrow["experiment"], "--voxels", "16",
                    "--device", "cpu"])
    _same_mesh(tmp_path / "port" / "meshes" / "1.ply", tmp_path / "jax" / "meshes" / "1.ply")


def test_visualize_map_matches_jax(tmp_path, monkeypatch, narrow):
    for tag in ("jax", "port"):
        _write_map(tmp_path / tag, narrow["codes"])
    run_jax(monkeypatch, "visualize_map", tmp_path / "jax", "--deepsdf", narrow["npz"])
    out_png = tmp_path / "map.png"
    res = t_viz.main([str(tmp_path / "port"), "--deepsdf", narrow["npz"], "--png", str(out_png),
                      "--device", "cpu"])
    vt = _same_mesh(tmp_path / "port" / "scene.ply", tmp_path / "jax" / "scene.ply")
    # the map points come first, as written
    np.testing.assert_allclose(vt[:300], np.loadtxt(tmp_path / "port" / "MapPoints.txt"),
                               atol=1e-6)
    assert res["cameras"] == 12
    img = png.read_png(str(out_png))
    assert img.shape == (800, 800, 3) and img.dtype == np.uint8
    for rgb, least in ((t_viz.TRAJECTORY_RGB, 300), (t_viz.POINT_RGB, 100),
                       (t_viz.OBJECT_RGB, 2 * 40)):
        assert int(np.all(img == rgb, axis=-1).sum()) >= least, rgb
    # a map with points only still writes both files
    bare = tmp_path / "bare"
    bare.mkdir()
    np.savetxt(bare / "MapPoints.txt", np.zeros((1, 3)))
    t_viz.main([str(bare), "--png", str(bare / "m.png"), "--device", "cpu"])
    assert _read_ply(bare / "scene.ply")[0].shape == (1, 3)
    assert png.read_png(str(bare / "m.png")).shape == (800, 800, 3)


@pytest.fixture(scope="module")
def sphere(tmp_path_factory):
    """tests/test_torch_slam_system.py's small decoder fitted to the sphere
    family (a smooth surface: no pixel's opacity sits at the hit test's
    0.5), and two codes (radii ~0.6 and ~0.4)."""
    from test_torch_slam_system import SPEC, sphere_layers

    spec = jdeepsdf.DecoderSpec(*SPEC)
    codes = np.array([[0.5, 0, 0, 0], [-0.5, 0, 0, 0]], np.float32)
    return dict(_write_decoder(tmp_path_factory.mktemp("sphere"), sphere_layers(), spec),
                codes=codes)


def _state_npz(path, codes):
    from dsp_slam_rgbd_tpu_torch.mapping import map_state as ms
    from dsp_slam_rgbd_tpu_torch.utils import checkpoint

    s = ms.empty(max_kf=4, max_feat=8, max_pts=16, max_obj=4, code_len=codes.shape[1],
                 device="cpu")
    code = torch.zeros(4, codes.shape[1])
    code[1], code[3] = torch.tensor(codes[0]), torch.tensor(codes[1])
    checkpoint.save_state(str(path), s._replace(
        obj_valid=torch.tensor([False, True, False, True]),
        obj_scale=torch.tensor([1.0, 1.5, 1.0, 2.5]), obj_code=code))


def test_render_objects_matches_jax(tmp_path, monkeypatch, sphere):
    (tmp_path / "map").mkdir()
    _state_npz(tmp_path / "map" / "state.npz", sphere["codes"])
    view = ["--fx", "50", "--fy", "50", "--cx", "30", "--cy", "20", "--size", "40", "60",
            "--stride", "2"]
    run_jax(monkeypatch, "render_objects", tmp_path / "map", tmp_path / "jax",
            "--decoder", sphere["experiment"], *view)
    got = t_render.main([str(tmp_path / "map"), str(tmp_path / "port"), "--decoder",
                         sphere["experiment"], *view, "--device", "cpu"])
    assert sorted(got) == [1, 3]
    for o, (d, h) in got.items():
        dj = np.load(tmp_path / "jax" / f"object_{o:03d}_depth.npy")
        dt = np.load(tmp_path / "port" / f"object_{o:03d}_depth.npy")
        np.testing.assert_array_equal(dt, d)
        np.testing.assert_array_equal(dt > 0, dj > 0)        # the hit masks
        assert 20 < int(h.sum()) < h.size
        np.testing.assert_allclose(dt[h], dj[h], atol=2e-5)
        img = png.read_png(str(tmp_path / "port" / f"object_{o:03d}_depth.png"))
        assert img.shape == d.shape and img[h].min() >= 55 and not img[~h].any()
    # MapObjects.txt (the command line's layout) gives the same objects
    objs = tmp_path / "objs"
    objs.mkdir()
    with open(objs / "MapObjects.txt", "w") as f:
        for oid, s, code in ((1, 1.5, sphere["codes"][0]), (3, 2.5, sphere["codes"][1])):
            T = np.eye(4)
            T[:3, :3] *= s
            f.write(f"{oid}\n" + " ".join(f"{v:.9f}" for v in T[:3].reshape(-1)) + "\n"
                    + " ".join(f"{v:.9f}" for v in code) + "\n")
    again = t_render.main([str(objs), str(tmp_path / "port2"), "--decoder", sphere["npz"],
                           *view, "--device", "cpu"])
    for o in got:
        np.testing.assert_allclose(again[o][0], got[o][0], atol=1e-6)


# ---------------------------------------------------------------------------
# train_fixture_decoder

def test_ellipsoid_family_matches_jax():
    jt = jax_tool("train_fixture_decoder")
    rng = np.random.default_rng(3)
    codes = rng.standard_normal((5, 64)).astype(np.float32)
    pts = rng.uniform(-1.1, 1.1, (5, 50, 3)).astype(np.float32)
    np.testing.assert_allclose(t_train.code_to_axes(torch.tensor(codes)).numpy(),
                               np.asarray(jt.code_to_axes(jnp.asarray(codes))), atol=1e-6)
    axes = np.asarray(jt.code_to_axes(jnp.asarray(codes)))[:, None, :]
    np.testing.assert_allclose(
        t_train.ellipsoid_sdf(torch.tensor(pts), torch.tensor(axes)).numpy(),
        np.asarray(jt.ellipsoid_sdf(jnp.asarray(pts), jnp.asarray(axes))), atol=1e-6)


def test_one_adam_step_matches_optax():
    import optax

    jt = jax_tool("train_fixture_decoder")
    spec_j = jdeepsdf.DecoderSpec(dims=(96,) * 4, latent_in=(2,))
    spec_t = tdeepsdf.DecoderSpec(dims=(96,) * 4, latent_in=(2,))
    layers_np = [(W.detach().numpy(), b.detach().numpy() + 0.01)
                 for W, b in t_train.init_layers(spec_t, seed=3)]
    codes, pts = t_train.draw_batch(torch.Generator().manual_seed(9), 8, 64, 64)

    def loss_j(params, codes, pts):       # the JAX tool's loss_fn
        axes = jt.code_to_axes(codes)
        target = jnp.clip(jt.ellipsoid_sdf(pts, axes[:, None, :]), -0.1, 0.1)
        B, P, _ = pts.shape
        inp = jnp.concatenate([jnp.broadcast_to(codes[:, None, :], (B, P, 64)), pts],
                              axis=-1).reshape(B * P, 67)
        return jnp.mean(jnp.abs(jdeepsdf.apply(params, spec_j, inp).reshape(B, P) - target))

    params = {"layers": [(jnp.asarray(W), jnp.asarray(b)) for W, b in layers_np]}
    opt = optax.adam(5e-4)
    lj, g = jax.value_and_grad(loss_j)(params, jnp.asarray(codes.numpy()),
                                       jnp.asarray(pts.numpy()))
    updates, _ = opt.update(g, opt.init(params))
    new_j = optax.apply_updates(params, updates)["layers"]

    layers = [(torch.tensor(W).requires_grad_(), torch.tensor(b).requires_grad_())
              for W, b in layers_np]
    lt = t_train.step(layers, spec_t, t_train.make_optimizer(layers, 5e-4), codes, pts)
    assert abs(float(lt) - float(lj)) <= 1e-5 * abs(float(lj))
    for (Wt, bt), (Wj, bj) in zip(layers, new_j):
        for t, j in ((Wt, Wj), (bt, bj)):
            j = np.asarray(j)
            assert np.abs(t.detach().numpy() - j).max() <= 1e-5 * np.abs(j).max()


def test_code_ramp_scales_the_codes_past_the_axes_per_code():
    """`--code-ramp` (the 256 fixture's): the same first draw, each code's
    dims past the first three scaled by one factor in [0, 1)."""
    plain, _ = t_train.draw_batch(torch.Generator().manual_seed(9), 8, 16, 256)
    ramp, _ = t_train.draw_batch(torch.Generator().manual_seed(9), 8, 16, 256, code_ramp=True)
    assert torch.equal(ramp[:, :3], plain[:, :3])
    factor = ramp[:, 3:] / plain[:, 3:]
    assert torch.allclose(factor, factor[:, :1].expand_as(factor), rtol=1e-6, atol=0)
    assert bool(((factor[:, 0] >= 0) & (factor[:, 0] < 1)).all())


def test_train_fixture_decoder_lowers_the_loss_and_writes_the_npz(tmp_path):
    out = tmp_path / "dec.npz"
    res = t_train.main(["--steps", "30", "--batch-codes", "8", "--pts-per-code", "128",
                        "--dims", "96", "96", "96", "96", "--latent-in", "2", "--lr", "1e-3",
                        "--out", str(out), "--device", "cpu"])
    losses = res["losses"]
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert losses[-5:].mean() < losses[:5].mean()
    with np.load(out) as z:
        assert z["W0"].dtype == np.float16 and z["b0"].dtype == np.float32
        assert tuple(z["dims"]) == (96,) * 4 and tuple(z["latent_in"]) == (2,)
    dec_t = tdeepsdf.load_npz(str(out), device="cpu")
    params_j, spec_j = jdeepsdf.load_npz(str(out))
    x = np.random.default_rng(0).standard_normal((20, 67)).astype(np.float32) * 0.3
    np.testing.assert_allclose(dec_t.apply(torch.tensor(x)).numpy(),
                               np.asarray(jdeepsdf.apply(params_j, spec_j, jnp.asarray(x))),
                               atol=1e-5)


# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tool, argv", [
    (t_ate, ["a.txt", "b.txt"]),
    (t_extract, ["map", "dec.npz"]),
    (t_viz, ["map"]),
    (t_render, ["map", "out"]),
    (t_train, ["--steps", "1"]),
    (t_repeat, ["loop"]),
    (t_repeat, ["loop-fast"]),
    (t_repeat, ["stress"]),
])
def test_tools_default_to_the_card(tool, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(argv)


# ---------------------------------------------------------------------------
# kernel_repeat's bookkeeping, over stand-ins for the kernels

def stand_in_kernel(jacobian, flips):
    """A deterministic stand-in for a decoder kernel wrapper whose call
    number c (counted from 0) flips the lowest bit of its last output's
    rows flips[c]."""
    count = [0]

    def kernel(wb, code, xyz, compute_dtype=torch.float32, tiles=None):
        n = xyz.reshape(-1, 3).shape[0]
        sdf = xyz.reshape(n, 3).sum(1)
        grad = torch.arange(n * 67, dtype=torch.float32).reshape(n, 67) / 7.0
        rows = flips.get(count[0], [])
        count[0] += 1
        if rows:
            (grad if jacobian else sdf).view(torch.int32)[rows] ^= 1
        return (sdf, grad) if jacobian else sdf

    return kernel


@pytest.mark.parametrize("odd", [0, 1, 2])
def test_kernel_repeat_reports_the_call_and_rows_that_differ(monkeypatch, odd):
    monkeypatch.setattr(t_repeat.mlp_sdf, "sdf_and_input_jacobian_fused",
                        stand_in_kernel(True, {odd: [48, 49, 50, 51]}))
    monkeypatch.setattr(t_repeat, "tiling_of", lambda kind, dtype, n: "32x1")
    xyz = torch.ones(96, 3)
    with t_repeat.repeating(t_repeat.Tally()) as tally:
        sdf, grad = t_repeat.mlp_sdf.sdf_and_input_jacobian_fused(None, None, xyz)
    assert sdf.shape == (96,) and grad.shape == (96, 67)
    summary = tally.summary("test")
    assert (summary["calls"], summary["differ"]) == (1, 1)
    (found,) = summary["findings"]
    assert found["kernel"] == "mlp_sdf_jacobian_f32" and found["tiling"] == "32x1"
    assert found["output"] == 1 and found["call"] == odd and found["two_agree"]
    assert found["rows"] == [48, 49, 50, 51] and found["n_rows"] == 4
    assert found["tile_rows"] == [16, 17, 18, 19] and found["cols"] == list(range(67))
    assert 0 < found["max_abs"] < 1e-3 and not found["nan"]


def test_kernel_repeat_counts_calls_per_kernel_and_tiling(monkeypatch):
    for name, jac in (("sdf_value_fused", False), ("sdf_and_input_jacobian_fused", True)):
        # each wrapper's fifth call, the second of its second repeated call, flips row 3
        monkeypatch.setattr(t_repeat.mlp_sdf, name, stand_in_kernel(jac, {4: [3]}))
    monkeypatch.setattr(t_repeat, "tiling_of",
                        lambda kind, dtype, n: "64x1" if dtype == torch.bfloat16
                        else "32x1" if n > 64 else "32x2")
    with t_repeat.repeating(t_repeat.Tally()) as tally:
        for n in (64, 100, 100):
            for dtype in (torch.float32, torch.bfloat16):
                t_repeat.mlp_sdf.sdf_value_fused(None, None, torch.ones(n, 3), dtype)
            t_repeat.mlp_sdf.sdf_and_input_jacobian_fused(None, None, torch.ones(n, 3))
    summary = tally.summary("test")
    kernels = summary["kernels"]
    assert set(kernels) == {"mlp_sdf_value", "mlp_sdf_value_f32", "mlp_sdf_jacobian_f32"}
    assert (summary["calls"], summary["differ"]) == (9, 2)
    assert kernels["mlp_sdf_jacobian_f32"] == {
        "calls": 3, "differ": 1, "tilings": {"32x2": [1, 0], "32x1": [2, 1]}, "rows": [64, 100]}
    # the value wrapper's second repeated call is the bf16 one at n = 64
    assert kernels["mlp_sdf_value"] == {
        "calls": 3, "differ": 1, "tilings": {"64x1": [3, 1]}, "rows": [64, 100]}
    assert kernels["mlp_sdf_value_f32"]["differ"] == 0
    assert [(f["kernel"], f["n"], f["rows"], f["tile_rows"]) for f in summary["findings"]] == [
        ("mlp_sdf_value", 64, [3], [3]), ("mlp_sdf_jacobian_f32", 100, [3], [3])]


def test_kernel_sources_from_another_checkout(monkeypatch, tmp_path):
    """`--csrc DIR` builds another checkout's kernel sources, into this
    package's `_build/`, and only before the library is loaded."""
    from dsp_slam_rgbd_tpu_torch.ops.cuda import build

    for name in ("CSRC", "BUILD_DIR", "_lib"):
        monkeypatch.setattr(build, name, getattr(build, name))
    for name in ("a.cu", "b.cuh", "notes.txt"):
        (tmp_path / name).write_text("")
    build._lib = None
    build_dir = build.BUILD_DIR
    build.use_sources(str(tmp_path))
    assert build.sources() == [str(tmp_path / "a.cu"), str(tmp_path / "b.cuh")]
    assert build.BUILD_DIR == build_dir
    build._lib = object()
    with pytest.raises(RuntimeError, match="already loaded"):
        build.use_sources(str(tmp_path))
