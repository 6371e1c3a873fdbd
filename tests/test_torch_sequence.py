"""The port's sequence loaders, PNG codec and native library against PIL
and the JAX package's, on the CPU.

The PNG codec must read what PIL writes (8-bit gray, gray+alpha, RGB,
RGBA, palette, 16-bit gray; PIL's adaptive row filters, odd widths) as
PIL does, with PIL's `convert("L")` luma, and PIL must read what the codec
writes.  Each loader must give the JAX package's frames, calibration,
LiDAR points (1e-6) and detections (equal arrays) on the same directory,
and `get_sequence` must pick the same layout.  The native library (the
port's own build of its copy of `runtime.cc`) must give the JAX package's
`native/runtime.py` results on `tests/test_native.py`'s cases.  The
prefetchers hand over what the source and `Tracker.make_frame` give, in
order, and raise the source's error in the consumer.
"""
import os

import numpy as np
import pytest
from PIL import Image

from dsp_slam_rgbd_tpu.native import runtime as jnative
from dsp_slam_rgbd_tpu.system import detections as jdet
from dsp_slam_rgbd_tpu.system import sequence as jseq
from dsp_slam_rgbd_tpu_torch.native import runtime as tnative
from dsp_slam_rgbd_tpu_torch.system import detections as tdet
from dsp_slam_rgbd_tpu_torch.system import png
from dsp_slam_rgbd_tpu_torch.system import sequence as tseq
from dsp_slam_rgbd_tpu_torch.tools import plane_world as pw
from dsp_slam_rgbd_tpu_torch.tools import sequence_dirs as sd

# the assembly scene of tests/test_kitti_assembly.py
T_CAM_VELO = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1]], np.float32)
K = np.array([[300.0, 0, 310.0], [0, 300.0, 120.0], [0, 0, 1]], np.float32)


def _textured(rng, h, w, channels=None, dtype=np.uint8, hi=256):
    """Smooth-plus-noise pixels (every PNG row filter gets chosen)."""
    shape = (h, w) if channels is None else (h, w, channels)
    base = np.add.outer(np.arange(h), np.arange(w)) * 3
    base = base if channels is None else base[..., None]
    return ((base + rng.integers(0, hi // 4, shape)) % hi).astype(dtype)


@pytest.mark.parametrize("w", [1, 7, 224, 1241])
def test_png_reads_what_pil_writes(tmp_path, w):
    rng = np.random.default_rng(w)
    h = 13
    cases = {
        "L": _textured(rng, h, w),
        "LA": _textured(rng, h, w, 2),
        "RGB": _textured(rng, h, w, 3),
        "RGBA": _textured(rng, h, w, 4),
    }
    for mode, a in cases.items():
        p = str(tmp_path / f"{mode}.png")
        Image.fromarray(a, mode).save(p)
        got = png.read_png(p)
        np.testing.assert_array_equal(got, a, err_msg=mode)
        np.testing.assert_array_equal(png.to_gray(got),
                                      np.asarray(Image.open(p).convert("L")), err_msg=mode)
        np.testing.assert_array_equal(tseq.load_gray(p), jseq.load_gray(p), err_msg=mode)
    # palette images come back as RGB, gray as PIL converts them
    pal = Image.fromarray(cases["RGB"], "RGB").quantize(colors=37)
    pal.save(tmp_path / "P.png")
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "P.png")),
                                  np.asarray(pal.convert("RGB")))
    np.testing.assert_array_equal(tseq.load_gray(str(tmp_path / "P.png")),
                                  np.asarray(pal.convert("L")))
    # 16-bit gray depth, as the RGB-D loader reads it
    d16 = _textured(rng, h, w, dtype=np.uint16, hi=65536)
    Image.fromarray(d16).save(tmp_path / "d.png")
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "d.png")), d16)
    np.testing.assert_array_equal(tseq.load_depth_png(str(tmp_path / "d.png"), 1e-3),
                                  jseq.load_depth_png(str(tmp_path / "d.png"), 1e-3))


def test_pil_reads_what_png_writes(tmp_path):
    rng = np.random.default_rng(0)
    for name, a in (("g", _textured(rng, 9, 31)), ("rgb", _textured(rng, 9, 31, 3)),
                    ("rgba", _textured(rng, 9, 31, 4)),
                    ("d16", _textured(rng, 9, 31, dtype=np.uint16, hi=65536))):
        p = str(tmp_path / f"{name}.png")
        png.write_png(p, a)
        np.testing.assert_array_equal(np.asarray(Image.open(p)), a, err_msg=name)
        np.testing.assert_array_equal(png.read_png(p), a, err_msg=name)
    with pytest.raises(ValueError):
        png.write_png(str(tmp_path / "bad.png"), np.zeros((3, 3), np.float32))
    (tmp_path / "not.png").write_bytes(b"GIF89a")
    with pytest.raises(ValueError):
        png.read_png(str(tmp_path / "not.png"))


def _assembly_scene(rng):
    """Two boxes of LiDAR points ahead of the sensor + ground clutter, with
    their masks and 2D boxes (tests/test_kitti_assembly.py's scene)."""
    cars = []
    for cx, cy in ((8.0, 1.0), (14.0, -2.0)):
        cars.append(np.stack([rng.uniform(-0.9, 0.9, 250), rng.uniform(-2.0, 2.0, 250),
                              rng.uniform(0.0, 1.5, 250)], -1) + [cx, cy, 0.0])
    ground = np.stack([rng.uniform(3, 25, 3000), rng.uniform(-8, 8, 3000),
                       rng.uniform(-0.2, 0.05, 3000)], -1)
    velo = np.concatenate(cars + [ground]).astype(np.float32)
    boxes = np.array([[8.0, 1.0, 0.0, 1.8, 4.0, 1.5, 0.0],
                      [14.0, -2.0, 0.0, 1.8, 4.0, 1.5, 0.0]], np.float32)
    masks, bboxes = [], []
    for car in cars:
        cam = car @ T_CAM_VELO[:3, :3].T
        uv = cam @ K.T
        px = (uv[:, :2] / uv[:, 2:3]).astype(int)
        m = np.zeros((240, 620), bool)
        for du in range(-4, 5):
            for dv in range(-4, 5):
                m[np.clip(px[:, 1] + dv, 0, 239), np.clip(px[:, 0] + du, 0, 619)] = True
        ys, xs = np.nonzero(m)
        masks.append(m)
        bboxes.append([xs.min(), ys.min(), xs.max(), ys.max()])
    return velo, boxes, np.stack(masks), np.asarray(bboxes, np.float32)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """A KITTI directory (images, calib, velodyne, labels and raw labels), an
    RGB-D one and a mono one with mask labels, on the small plane world."""
    root = tmp_path_factory.mktemp("seqs")
    world, tex = pw.SMALL, pw.make_texture(pw.SMALL)
    rng = np.random.default_rng(1)
    kitti = root / "kitti"
    sd.write_kitti(str(kitti), world, tex, 3)
    (kitti / "calib.txt").write_text(sd.KITTI_CALIB)
    (kitti / "velodyne").mkdir()
    (root / "labels").mkdir()
    raw_dir = root / "raw"
    raw_dir.mkdir()
    for i in range(3):
        velo, boxes, masks, bboxes = _assembly_scene(rng)
        refl = rng.uniform(0, 1, (len(velo), 1)).astype(np.float32)
        np.concatenate([velo, refl], 1).tofile(kitti / "velodyne" / f"{i:06d}.bin")
        np.savez(raw_dir / f"{i:06d}_raw.npz", boxes_3d=boxes, masks=masks, bboxes_2d=bboxes)
        d = tdet.make_detection(np.eye(4, dtype=np.float32), pts=velo[:40], rays=None)
        tseq.save_label_file(str(root / "labels" / f"{i:06d}.npz"), [d] * (i + 1))
    # the raw scene's camera: P2 = K, Tr = T_CAM_VELO
    raw_kitti = root / "raw_kitti"
    sd.write_kitti(str(raw_kitti), world, tex, 3)
    P2 = np.concatenate([K, np.zeros((3, 1), np.float32)], 1)
    (raw_kitti / "calib.txt").write_text(
        "P2: " + " ".join(map(str, P2.ravel())) + "\nTr: "
        + " ".join(map(str, T_CAM_VELO[:3].ravel())) + "\n")
    os.symlink(kitti / "velodyne", raw_kitti / "velodyne")
    rgbd = root / "rgbd"
    sd.write_rgbd(str(rgbd), world, tex, 3)
    mono = root / "mono"
    sd.write_mono(str(mono), world, tex, 3)
    (root / "mono_labels").mkdir()
    tseq.save_mask_labels(str(root / "mono_labels" / "000001_masks.npz"),
                          np.ones((2, world.h, world.w), bool))
    return root


def _same(a, b):
    if isinstance(a, tuple):
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _same_dets(a, b):
    assert len(a) == len(b) and len(a) > 0
    for x, y in zip(a, b):
        assert type(x).__name__ == type(y).__name__
        for u, v in zip(x, y):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def test_kitti_sequence_matches_jax(dirs):
    t = tseq.KittiSequence(str(dirs / "kitti"), labels_dir=str(dirs / "labels"))
    j = jseq.KittiSequence(str(dirs / "kitti"), labels_dir=str(dirs / "labels"))
    assert len(t) == len(j) == 3
    np.testing.assert_array_equal(t.P2, j.P2)
    np.testing.assert_array_equal(t.T_cam_velo, j.T_cam_velo)
    assert t.T_cam_velo[0, 3] != 0.0     # the cam0→cam2 offset is folded in
    for i in range(3):
        _same(t.frame(i), j.frame(i))
        vt, vj = t.velodyne_cam(i), j.velodyne_cam(i)
        assert vt.shape == vj.shape == (3500, 3)
        np.testing.assert_allclose(vt, vj, atol=1e-6, rtol=0)
        _same_dets(t.detections(i), j.detections(i))
    img = t.frame(1)[0]
    np.testing.assert_array_equal(img, pw.render_u8(pw.SMALL, pw.make_texture(pw.SMALL),
                                                    pw.gt_x(pw.SMALL, 1)))


def test_detections_from_raw_match_jax(dirs):
    t = tseq.KittiSequence(str(dirs / "raw_kitti"), labels_dir=str(dirs / "raw"))
    j = jseq.KittiSequence(str(dirs / "raw_kitti"), labels_dir=str(dirs / "raw"))
    for i in range(2):
        dt, dj = t.detections(i), j.detections(i)
        assert len(dt) == 2
        _same_dets(dt, dj)


def test_rgbd_and_mono_sequences_match_jax(dirs):
    t, j = tseq.RgbdSequence(str(dirs / "rgbd")), jseq.RgbdSequence(str(dirs / "rgbd"))
    assert len(t) == len(j) == 3
    for i in range(3):
        _same(t.frame(i), j.frame(i))
    dep = t.frame(2)[1]
    truth = pw.depth_map(pw.SMALL, pw.gt_x(pw.SMALL, 2))
    assert np.abs(dep - truth).max() < 1.5e-3        # millimetre PNG
    t = tseq.MonoSequence(str(dirs / "mono"), labels_dir=str(dirs / "mono_labels"))
    j = jseq.MonoSequence(str(dirs / "mono"), labels_dir=str(dirs / "mono_labels"))
    assert len(t) == len(j) == 3
    for i in range(3):
        _same(t.frame(i), j.frame(i))
        assert len(t.detections(i)) == len(j.detections(i))
    (mt,), (mj,) = t.detections(1)[:1], j.detections(1)[:1]
    assert isinstance(mt, tdet.MaskLabel) and isinstance(mj, jdet.MaskLabel)
    np.testing.assert_array_equal(mt.mask, mj.mask)


def test_get_sequence_dispatch(dirs):
    for sub, cls in (("kitti", "KittiSequence"), ("rgbd", "RgbdSequence"),
                     ("mono", "MonoSequence")):
        t, j = tseq.get_sequence(str(dirs / sub), None), jseq.get_sequence(str(dirs / sub), None)
        assert type(t).__name__ == type(j).__name__ == cls
    assert len(tseq.get_sequence(str(dirs / "missing"), None)) == 0


def test_native_library_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    pts4 = rng.standard_normal((500, 4)).astype(np.float32)
    pts4.tofile(tmp_path / "000000.bin")
    np.testing.assert_array_equal(tnative.read_velodyne(str(tmp_path / "000000.bin")),
                                  jnative.read_velodyne(str(tmp_path / "000000.bin")))
    with pytest.raises(IOError):
        tnative.read_velodyne(str(tmp_path / "missing.bin"))
    clusters = np.asarray([[0.1, 0.1, 0.1]] * 50 + [[5.0, 5.0, 5.0]] * 50, np.float32)
    cloud = rng.uniform(-5, 5, (3000, 3)).astype(np.float32)
    for pts, voxel in ((clusters, 1.0), (cloud, 0.7)):
        np.testing.assert_array_equal(tnative.voxel_downsample(pts, voxel),
                                      jnative.voxel_downsample(pts, voxel))
    assert len(tnative.voxel_downsample(clusters, 1.0)) == 2
    th = np.pi / 4
    R = np.asarray([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]],
                   np.float32)
    for Rm in (np.eye(3, dtype=np.float32), R):
        args = (cloud, Rm, np.asarray([0.5, 0, 0], np.float32), np.ones(3, np.float32))
        got = tnative.box_crop(*args)
        np.testing.assert_array_equal(got, jnative.box_crop(*args))
        local = (cloud - args[2]) @ Rm
        assert len(got) == np.all(np.abs(local) <= 1.0, axis=1).sum()
    paths = []
    for i in range(5):
        p = tmp_path / f"f{i}.bin"
        p.write_bytes(bytes([i]) * (100 + i))
        paths.append(str(p))
    with tnative.Prefetcher(paths) as pf:
        for i in list(range(5)) + [1, 4, 0]:
            assert pf.get(i) == bytes([i]) * (100 + i)
    lib = tnative._lib_path()
    assert lib.startswith(tnative.BUILD_DIR) and os.path.isfile(lib)


def test_native_prefetcher_returns_each_file_under_any_order(tmp_path):
    """2,000 `get` calls over 4 prefetchers: sequential runs, repeats and
    random jumps, so that `get` often asks for a slot while the worker is
    still reading another (or the same) file into it.  Every call must
    give its own file's bytes."""
    rng = np.random.default_rng(12)
    files, paths = [], []
    for i in range(8):
        data = rng.integers(0, 256, 40_000 + 23_000 * i, dtype=np.uint8).tobytes()
        p = tmp_path / f"s{i}.bin"
        p.write_bytes(data)
        files.append(data)
        paths.append(str(p))
    for _ in range(4):
        order = []
        while len(order) < 500:
            kind, start = rng.integers(3), int(rng.integers(8))
            if kind == 0:            # a sequential run
                order += [(start + k) % 8 for k in range(int(rng.integers(2, 9)))]
            elif kind == 1:          # a repeat
                order += [start] * int(rng.integers(2, 4))
            else:                    # a jump
                order.append(start)
        with tnative.Prefetcher(paths) as pf:
            for i in order[:500]:
                assert pf.get(i) == files[i], f"get({i}) returned another file"


def test_image_prefetcher_uploads_ahead_and_raises_the_sources_error():
    import torch

    from dsp_slam_rgbd_tpu_torch.system.prefetch import ImagePrefetcher

    rng = np.random.default_rng(0)
    items = [(rng.integers(0, 255, (4, 5)).astype(np.uint8), i) for i in range(5)]
    got = list(ImagePrefetcher(iter(items), depth=2, device="cpu"))
    assert len(got) == 5
    for (a, i), (t, j) in zip(items, got):
        assert isinstance(t, torch.Tensor) and t.dtype == torch.uint8 and j == i
        np.testing.assert_array_equal(t.numpy(), a)
    (single,), = list(ImagePrefetcher([np.zeros(3, np.float32)], device="cpu"))
    assert single.shape == (3,)

    def broken():
        yield (np.zeros(2),)
        raise ValueError("disk gone")

    seen = []
    with pytest.raises(ValueError, match="disk gone"):
        for item in ImagePrefetcher(broken(), device="cpu"):
            seen.append(item)
    assert len(seen) == 1
    # abandoning the iteration stops the thread
    pf = ImagePrefetcher(iter(items * 20), depth=1, device="cpu")
    next(iter(pf))
    pf.close()
    assert not pf._thread.is_alive()


def test_frame_prefetcher_makes_the_trackers_frames():
    import torch

    from dsp_slam_rgbd_tpu_torch.system.prefetch import FramePrefetcher
    from dsp_slam_rgbd_tpu_torch.tools import plane_world as pw
    from dsp_slam_rgbd_tpu_torch.tracking.tracker import Tracker
    from test_torch_tracking import make_cfg, port_config
    from dsp_slam_rgbd_tpu_torch.mapping import map_state as tms

    cfg = port_config(make_cfg("stereo"))
    tr = Tracker(cfg, tms.empty(max_kf=4, max_feat=8, max_pts=16, device="cpu"), device="cpu")
    world, tex = pw.SMALL, pw.make_texture(pw.SMALL)
    pairs = [(pw.render_u8(world, tex, x), pw.render_u8(world, tex, x + world.baseline))
             for x in (0.0, 0.12, 0.24)]
    with FramePrefetcher(tr, iter(pairs), sensor="stereo", fps=5.0) as pf:
        frames = list(pf)
    assert [f.timestamp for f in frames] == [0.0, 0.2, 0.4]
    for (l, r), f in zip(pairs, frames):
        ref = tr.make_frame(l, img_right=r)
        for a, b in zip(f.feats, ref.feats):
            assert torch.equal(a, b)
        assert torch.equal(f.depth, ref.depth) and torch.equal(f.ur, ref.ur)
