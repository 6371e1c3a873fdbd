"""The loop-closing circuit worlds of `dsp_slam_rgbd_tpu_torch/tools/loop_world.py`
and the sequence directory that `chip_smoke.py` phase 16 drives the port's
command line over (`tools/sequence_dirs.py::write_kitti_circuit`):

  * the 224x160 circuit (phase 12c) renders bit for bit as
    tests/test_long_run.py's own world does;
  * the KITTI-size circuit (`loop_world.KITTI`) describes one scene: a
    seed gives the same images, a left image's pixels reappear in the
    right one where the surface's depth puts them, the legs' footprints
    are disjoint, and the objects are seen where phase 16 needs them;
    `object_world.t_cw` and `visible` are unchanged for the plane worlds;
  * the directory reads identically through both packages' loaders,
    yaml readers and label readers (`tests/tracking_driver.py circuit`
    runs the JAX package's command line over these files), and both load
    the vocabulary fixture both command lines close the circuit with
    alike.
"""
import numpy as np
import pytest
import torch

from dsp_slam_rgbd_tpu_torch.tools import loop_world as lw
from dsp_slam_rgbd_tpu_torch.tools import object_world as ow
from dsp_slam_rgbd_tpu_torch.tools import plane_world as pw


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_small_circuit_is_the_long_run_tests_world():
    import test_long_run as tl

    xys, frames = lw.frames()
    assert xys == tl.loop_path()
    texture = tl.make_texture(np.random.default_rng(0))
    assert len(frames) == tl.N_LAP + 1 + tl.LAP2_EXTRA
    for (x, y), (left, right) in zip(xys, frames):
        np.testing.assert_array_equal(left, tl.render(texture, x, y))
        np.testing.assert_array_equal(right, tl.render(texture, x + tl.BASE, y))


def test_small_circuit_helpers_of_phase_12c():
    """The helpers phase 12c drives the small circuit with: its
    configuration, its vocabulary (here on frames 0 and 6) and the lap
    metrics, which read the true path as no error at all."""
    xys, frames = lw.frames()
    cfg = lw.make_cfg()
    assert cfg.cam.fx == lw.FX and cfg.orb.n_features == 400
    vocab = lw.train_vocab(frames[:7], cfg, device="cpu")
    assert (vocab.branching, vocab.depth) == (8, 3)
    n = len(xys)
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, 0, 3] = [-x for x, _ in xys]
    poses[:, 1, 3] = [-y for _, y in xys]
    ate, gap, lap2 = lw.lap_metrics(xys, np.arange(n) / 10.0, poses, np.ones(n, bool))
    assert ate < 1e-5 and gap < 1e-9 and lap2 < 1e-9


@pytest.fixture(scope="module")
def kitti_texture():
    return lw.circuit_texture(lw.KITTI)


def test_kitti_circuit_is_consistent(kitti_texture):
    from scipy.ndimage import map_coordinates

    c = lw.KITTI
    assert (c.h, c.w, c.fx, c.baseline) == (376, 1241, 718.856, 0.537)
    xys = c.path()
    assert len(xys) == c.n_lap + 1 + c.extra and c.extra >= 12
    # the same seed gives the same images
    left, right = lw.stereo_pair(c, kitti_texture, 30)
    again = lw.stereo_pair(c, lw.circuit_texture(c), 30)
    np.testing.assert_array_equal(left, again[0])
    np.testing.assert_array_equal(right, again[1])
    # the left image's pixels reappear in the right one where the surface's
    # depth puts them: disparity fx·baseline / depth along the row.  At one
    # texel a pixel the warp's second bilinear sampling leaves ~0.6 grey
    # levels (of a 23-level spread); a quarter pixel off costs ~4x that
    X, Y, depth = lw.surface_points(c, *xys[30])
    u = np.arange(c.w)[None, :] * np.ones((c.h, 1))
    v = np.arange(c.h)[:, None] * np.ones((1, c.w))

    def warp_err(shift):
        u_r = u - c.fx * c.baseline / depth + shift
        inside = u_r > 1
        return np.abs(map_coordinates(right, [v[inside], u_r[inside]], order=1) - left[inside])

    err, off = warp_err(0.0), warp_err(0.25)
    assert np.median(err) < 1.0 and np.mean(err) < 1.5
    assert np.median(off) > 3.0 * np.median(err)
    # about one texel a pixel: a pixel spans 1/fx of its depth
    texel_per_px = depth / c.fx * c.tex_scale / 10.0
    assert 0.6 < texel_per_px.min() and texel_per_px.max() < 1.5
    # the outbound and return legs' footprints are disjoint, and the far
    # end sees none of what frame 0 sees
    mid_out, mid_back = lw.surface_points(c, *xys[c.n_lap // 4]), \
        lw.surface_points(c, *xys[3 * c.n_lap // 4])
    assert mid_out[1].min() > mid_back[1].max()
    assert lw.surface_points(c, *xys[c.n_lap // 2])[0].min() > lw.surface_points(c, 0.0)[0].max()
    # every frame's footprint lies inside one period of the texture
    for f in (0, c.n_lap // 4, c.n_lap // 2, 3 * c.n_lap // 4):
        Xf, Yf, _ = lw.surface_points(c, *xys[f])
        assert np.abs(Xf).max() * c.tex_scale / 10.0 < c.tex_shape[1] / 2
        assert np.abs(Yf).max() * c.tex_scale / 10.0 < c.tex_shape[0] / 2


def test_kitti_circuit_objects():
    c = lw.KITTI
    truths = lw.kitti_objects()
    assert len(truths) == 6 and not any(t.dynamic for t in truths)
    seen = [[f for f in range(len(c.path())) if ow.visible(c, ow.t_cw(c, f), t, f)]
            for t in truths]
    lap1 = [[f for f in s if f <= c.n_lap] for s in seen]
    lap2 = [[f for f in s if f >= c.n_lap] for s in seen]
    assert all(len(s) >= 3 for s in lap1), seen
    assert len(lap2[0]) >= 3 and len(lap2[1]) >= 3, seen
    # the start's objects are seen at the start of lap 1 and again on the return
    assert 0 in seen[0] and 0 in seen[1]
    # far enough apart on the ground plane (x, z) that no detection gates
    # to another truth's object (4 m), and in 3D that fusing duplicates
    # (1.5 m) can never merge two truths
    centers = np.stack([t.center for t in truths])
    off = ~np.eye(len(truths), dtype=bool)
    ground = np.linalg.norm((centers[:, None] - centers[None])[..., [0, 2]], axis=-1)
    assert ground[off].min() > 5.0
    assert np.linalg.norm(centers[:, None] - centers[None], axis=-1)[off].min() > 3.0
    # between the camera and the surface
    for t in truths:
        assert 1.0 < t.center[2] < lw.KITTI.plane_z - 3.0
    # t_cw puts the camera on the circuit
    f = 30
    np.testing.assert_allclose(np.linalg.inv(ow.t_cw(c, f))[:3, 3], [*c.path()[f], 0.0])


def test_plane_world_poses_unchanged():
    """t_cw and visible give the plane worlds what they gave before the
    circuit's (x, y) camera."""
    for world in (pw.KITTI, pw.SMALL, pw.KITTI_FLOOR):
        for f in range(24):
            want = np.eye(4)
            want[0, 3] = -pw.gt_x(world, f)
            got = ow.t_cw(world, f)
            np.testing.assert_array_equal(got, want)
            assert not np.signbit(got[1:3, 3]).any()
            for t in ow.kitti_objects():
                cam = t.center_at(f) - np.array([pw.gt_x(world, f), 0.0, 0.0])
                old = cam[2] > 1.0 and 0.0 <= world.fx * cam[0] / cam[2] + world.cx < world.w \
                    and 0.0 <= world.fx * cam[1] / cam[2] + world.cy < world.h
                assert ow.visible(world, got, t, f) == old


def test_circuit_directory_reads_the_same_in_both_packages(tmp_path):
    from dsp_slam_rgbd_tpu import config as jconfig
    from dsp_slam_rgbd_tpu.system import sequence as jseq
    from dsp_slam_rgbd_tpu_torch import config as tconfig
    from dsp_slam_rgbd_tpu_torch.system import sequence as tseq
    from dsp_slam_rgbd_tpu_torch.tools import sequence_dirs as sd

    n = 3
    paths = sd.write_kitti_circuit(str(tmp_path), n_frames=n)
    jc = jconfig.from_reference_yaml_json(paths["yaml"], None, sensor="stereo")
    tc = tconfig.from_reference_yaml_json(paths["yaml"], None, sensor="stereo")
    for a, b in ((jc.cam, tc.cam), (jc.orb, tc.orb), (jc.tracking, tc.tracking)):
        assert tuple(a) == tuple(b) if isinstance(a, tuple) else vars(a) == vars(b)
    assert (tc.cam.fx, tc.cam.cx, tc.cam.cy) == (lw.KITTI.fx, lw.KITTI.cx, lw.KITTI.cy)
    assert tc.orb.n_features == 2000 and tc.orb.n_levels == 8
    t = tseq.get_sequence(paths["seq"], tc)
    j = jseq.get_sequence(paths["seq"], jc)
    t.labels_dir = j.labels_dir = paths["labels"]
    assert len(t) == len(j) == n
    np.testing.assert_array_equal(t.P2, j.P2)
    assert abs(t.P2[0, 2] - lw.KITTI.cx) < 1e-9 and abs(t.P2[1, 2] - lw.KITTI.cy) < 1e-9
    texture = lw.circuit_texture(lw.KITTI)
    n_dets = 0
    for i in range(n):
        (lt, rt), (lj, rj) = t.frame(i), j.frame(i)
        for a, b in ((lt, lj), (rt, rj)):
            assert a.dtype == b.dtype and a.shape == b.shape == (376, 1241)
            np.testing.assert_array_equal(a, b)
        want = lw.stereo_pair(lw.KITTI, texture, i)
        np.testing.assert_array_equal(lt, np.clip(want[0], 0, 255).astype(np.uint8))
        dt, dj = t.detections(i), j.detections(i)
        assert len(dt) == len(dj)
        n_dets += len(dt)
        for x, y in zip(dt, dj):
            for u, v in zip(x, y):
                np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
    assert n_dets == 2 * n      # truths 0 and 1 in each of the first frames
    gt = np.loadtxt(paths["gt"], ndmin=2)
    np.testing.assert_allclose(gt[:, [3, 7]], np.asarray(lw.KITTI.path()[:n]), atol=1e-8)


def test_circuit_vocabulary_fixture_reads_the_same_in_both_packages():
    """The vocabulary both command lines close the circuit with (the JAX
    command line's bootstrap over the circuit, `tracking_driver.CIRCUIT_VOCAB`):
    10^4 words, loaded alike by both packages, quantizing descriptors to the
    same words."""
    import jax.numpy as jnp

    import tracking_driver as td
    from dsp_slam_rgbd_tpu.loop import vocabulary as jvoc
    from dsp_slam_rgbd_tpu_torch.loop import vocabulary as tvoc

    jv = jvoc.load_npz(td.CIRCUIT_VOCAB)
    tv = tvoc.load_npz(td.CIRCUIT_VOCAB, device="cpu")
    assert (jv.branching, jv.depth, jv.n_words) == (tv.branching, tv.depth, tv.n_words) \
        == (10, 4, 10_000)
    for a, b in zip(jv.centroids, tv.centroids):
        np.testing.assert_array_equal(np.asarray(a), b.numpy().view(np.uint32))
    rng = np.random.default_rng(0)
    desc = rng.integers(0, 2**32, (512, 8), dtype=np.uint64).astype(np.uint32)
    valid = np.ones(512, bool)
    wj = np.asarray(jvoc.quantize(jv, jnp.asarray(desc), jnp.asarray(valid)))
    wt = tvoc.quantize(tv, torch.from_numpy(desc.view(np.int32)), torch.from_numpy(valid))
    np.testing.assert_array_equal(wt.numpy(), wj)
