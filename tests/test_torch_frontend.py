"""The port's ORB frontend (pyramid, FAST, orientation, BRIEF, matcher,
stereo) against the JAX package's, on the CPU, on the same seeded inputs
(the 224×160 tilted-plane world of tests/test_system_e2e.py,
`OrbConfig(n_features=400, n_levels=3)`).

Tolerances: pyramid levels atol 1e-3 on [0, 255] (the JAX package's f32
einsum is itself ~1e-3 from the exact resize on noise; the port rounds an
f64 sum once); blur 1e-4; FAST scores, detections, descriptors, Hamming
distances, matches and RGB-D depths exact; angles 1e-4 rad against the
JAX package's patch-gather orientation and 1e-3 against its f32
integral-image `moment_angles` (the tolerance the JAX tests hold those two
to each other); stereo: the same valid set, u_R 1e-3; `extract` ≥ 99% of
keypoints equal.  The `cuda` test holds the card's extraction to the
port's own CPU result and needs no JAX.
"""
import numpy as np
import pytest
import torch

from dsp_slam_rgbd_tpu_torch.frontend import fast as tfast
from dsp_slam_rgbd_tpu_torch.frontend import matcher as tmatch
from dsp_slam_rgbd_tpu_torch.frontend import orb as torb
from dsp_slam_rgbd_tpu_torch.frontend import pyramid as tpyr
from dsp_slam_rgbd_tpu_torch.frontend import stereo as tstereo
from dsp_slam_rgbd_tpu_torch.tools import plane_world as pw
from dsp_slam_rgbd_tpu_torch.weights import features_from_numpy

try:
    import jax.numpy as jnp

    from dsp_slam_rgbd_tpu.frontend import fast as jfast
    from dsp_slam_rgbd_tpu.frontend import matcher as jmatch
    from dsp_slam_rgbd_tpu.frontend import orb as jorb
    from dsp_slam_rgbd_tpu.frontend import pyramid as jpyr
    from dsp_slam_rgbd_tpu.frontend import stereo as jstereo
except ImportError:  # the card's machine has no JAX: only the cuda test runs there
    jnp = None

WORLD = pw.SMALL
CFG = dict(n_features=400, n_levels=3)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair():
    """A rendered stereo pair of the small world (f32)."""
    tex = pw.make_texture(WORLD)
    return pw.render(WORLD, tex, 0.3), pw.render(WORLD, tex, 0.3 + WORLD.baseline)


@pytest.fixture(scope="module")
def jax_feats(pair):
    cfg = jorb.OrbConfig(**CFG)
    return jorb.extract(jnp.asarray(pair[0]), cfg), jorb.extract(jnp.asarray(pair[1]), cfg)


def _np_fields(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def t(a):
    return torch.from_numpy(np.array(np.asarray(a)))  # a copy: arrays from JAX are read-only


@pytest.mark.parametrize("shape", [(160, 224), (97, 131)])
def test_pyramid_levels_match_jax(pair, shape):
    img = np.ascontiguousarray(pair[0][: shape[0], : shape[1]])
    assert tpyr.level_shapes(*shape) == jpyr.level_shapes(*shape)
    lj = jpyr.build_pyramid(jnp.asarray(img), 8)
    lt = tpyr.build_pyramid(t(img), 8)
    assert len(lj) == len(lt) == 8
    for a, b in zip(lj, lt):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-3, rtol=0)
    assert tpyr.per_level_features(2000) == jpyr.per_level_features(2000)


@pytest.mark.parametrize("kind", ["render", "noise"])
def test_gaussian_blur_matches_jax(pair, kind):
    img = pair[0] if kind == "render" else \
        np.random.default_rng(1).uniform(0, 255, (97, 131)).astype(np.float32)
    np.testing.assert_allclose(tpyr.gaussian_blur(t(img)).numpy(),
                               np.asarray(jpyr.gaussian_blur(jnp.asarray(img))),
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tpyr.gaussian_kernel(), jpyr.gaussian_kernel())


def test_fast_score_is_exact_on_an_integer_image(pair):
    img = np.round(pair[0])
    for th in (7.0, 20.0):
        sj, cj = jfast.fast_score(jnp.asarray(img), th)
        st, ct = tfast.fast_score(t(img), th)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(tfast.nms3(st).numpy(), np.asarray(jfast.nms3(sj)))


@pytest.mark.parametrize("max_kp", [50, 200, 400])
def test_detect_matches_jax(pair, max_kp):
    xj, sj, vj = jfast.detect(jnp.asarray(pair[0]), max_kp)
    xt, st, vt = tfast.detect(t(pair[0]), max_kp)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_top_k_keeps_equal_values_in_index_order():
    x = torch.tensor([3, 1, 3, 2, 3, 1], dtype=torch.int32)
    v, i = tfast.top_k_stable(x, 4)
    assert i.tolist() == [0, 2, 4, 3] and v.tolist() == [3, 3, 3, 2]


def test_moment_angles_match_jax(pair, jax_feats):
    fj = jax_feats[0]
    lv0 = np.asarray(fj.level) == 0
    xy = np.asarray(fj.xy)[lv0]
    img = pair[0]
    ang = torb.moment_angles(t(img), t(xy)).numpy()
    ref_patch = np.asarray(jorb.orientations(jorb.gather_patches(jnp.asarray(img), jnp.asarray(xy))))
    ref_moment = np.asarray(jorb.moment_angles(jnp.asarray(img), jnp.asarray(xy)))
    np.testing.assert_allclose(ang, ref_patch, atol=1e-4, rtol=0)
    np.testing.assert_allclose(ang, ref_moment, atol=1e-3, rtol=0)
    # the port's patch path is the same function
    patches = torb.gather_patches(t(img), t(xy))
    np.testing.assert_array_equal(patches.numpy(),
                                  np.asarray(jorb.gather_patches(jnp.asarray(img), jnp.asarray(xy))))
    np.testing.assert_allclose(torb.orientations(patches).numpy(), ref_patch, atol=1e-4, rtol=0)


def test_descriptors_flat_bit_equal_to_jax(pair, jax_feats):
    fj = jax_feats[0]
    blurred = np.asarray(jpyr.gaussian_blur(jnp.asarray(pair[0])))
    lv0 = np.asarray(fj.level) == 0
    xy, ang = np.asarray(fj.xy)[lv0], np.asarray(fj.angle)[lv0]
    dj = np.asarray(jorb.descriptors_flat(jnp.asarray(blurred), jnp.asarray(xy), jnp.asarray(ang)))
    dt = torb.descriptors_flat(t(blurred), t(xy), t(ang)).numpy()
    assert len(xy) > 100
    np.testing.assert_array_equal(dt.view(np.uint32), dj)
    # ... and to the patch-gather version of both packages
    dp = torb.descriptors(torb.gather_patches(t(blurred), t(xy)), t(ang)).numpy()
    np.testing.assert_array_equal(dp, dt)
    dpj = np.asarray(jorb.descriptors(jorb.gather_patches(jnp.asarray(blurred), jnp.asarray(xy)),
                                      jnp.asarray(ang)))
    np.testing.assert_array_equal(dp.view(np.uint32), dpj)
    assert (dj >= 2 ** 31).any()  # words with bit 31 set crossed intact


def _random_words(rng, n):
    w = rng.integers(0, 2 ** 32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
    w[0] = 0xFFFFFFFF
    w[1] = 0x80000000
    return w


def test_hamming_matrix_exact():
    rng = np.random.default_rng(0)
    a, b = _random_words(rng, 37), _random_words(rng, 53)
    dj = np.asarray(jmatch.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    dt = tmatch.hamming_matrix(t(a.view(np.int32)), t(b.view(np.int32))).numpy()
    np.testing.assert_array_equal(dt, dj)
    assert dt[0, 0] == 0 and dt[1, 1] == 0 and dt[0, 1] == 8 * 31
    bits = np.unpackbits(a.view(np.uint8), axis=1).sum(1)
    np.testing.assert_array_equal(tmatch.popcount32(t(a.view(np.int32))).sum(1).numpy(), bits)


def _noisy_copies(rng, base, n_flip):
    """Descriptors of `base` with n_flip random bits flipped in each row."""
    out = base.copy()
    for r in range(len(out)):
        for bit in rng.choice(256, n_flip, replace=False):
            out[r, bit // 32] ^= np.uint32(1 << (bit % 32))
    return out


@pytest.mark.parametrize("rotation", [False, True])
def test_match_matches_jax(rotation):
    rng = np.random.default_rng(3)
    n, m = 120, 150
    b = _random_words(rng, m)
    perm = rng.permutation(m)[:n]
    a = _noisy_copies(rng, b[perm], 20)
    a[::7] = _random_words(rng, len(a[::7]))            # unmatched rows
    va, vb = rng.random(n) > 0.1, rng.random(m) > 0.1
    ang_b = rng.uniform(-np.pi, np.pi, m).astype(np.float32)
    ang_a = (ang_b[perm] + 0.3 + rng.normal(0, 0.05, n)).astype(np.float32)
    ang_a[::5] = rng.uniform(-np.pi, np.pi, len(ang_a[::5]))
    ang_b[::9] = np.nan
    mask = rng.random((n, m)) > 0.05
    kw = dict(max_dist=100, ratio=0.9, mutual=True, check_rotation=rotation)
    mj = jmatch.match(jnp.asarray(a), jnp.asarray(va), jnp.asarray(b), jnp.asarray(vb),
                      mask=jnp.asarray(mask), angles_a=jnp.asarray(ang_a),
                      angles_b=jnp.asarray(ang_b), **kw)
    mt = tmatch.match(t(a.view(np.int32)), t(va), t(b.view(np.int32)), t(vb), mask=t(mask),
                      angles_a=t(ang_a), angles_b=t(ang_b), **kw)
    np.testing.assert_array_equal(mt.idx.numpy(), np.asarray(mj.idx))
    np.testing.assert_array_equal(mt.valid.numpy(), np.asarray(mj.valid))
    np.testing.assert_array_equal(mt.dist.numpy(), np.asarray(mj.dist))
    assert 40 < int(mt.valid.sum()) < n


def test_masks_match_jax():
    rng = np.random.default_rng(4)
    xa, xb = rng.uniform(0, 50, (30, 2)), rng.uniform(0, 50, (40, 2))
    r = rng.uniform(2, 9, 30)
    for radius in (5.0, r):
        np.testing.assert_array_equal(
            tmatch.radius_mask(t(xa), t(xb), t(radius) if np.ndim(radius) else radius).numpy(),
            np.asarray(jmatch.radius_mask(jnp.asarray(xa), jnp.asarray(xb), radius)))
    la, lb = rng.integers(0, 8, 30).astype(np.int32), rng.integers(0, 8, 40).astype(np.int32)
    np.testing.assert_array_equal(tmatch.level_band_mask(t(la), t(lb)).numpy(),
                                  np.asarray(jmatch.level_band_mask(jnp.asarray(la), jnp.asarray(lb))))


def test_match_stereo_matches_jax(pair, jax_feats):
    fl, fr = jax_feats
    bf, fx = WORLD.fx * WORLD.baseline, WORLD.fx
    sj = jstereo.match_stereo(fl, fr, jnp.asarray(pair[0]), jnp.asarray(pair[1]), bf, min_z=bf / fx)
    tl = features_from_numpy(_np_fields(fl), "cpu")
    tr = features_from_numpy(_np_fields(fr), "cpu")
    st = tstereo.match_stereo(tl, tr, t(pair[0]), t(pair[1]), bf, min_z=bf / fx)
    vj = np.asarray(sj.valid)
    np.testing.assert_array_equal(st.valid.numpy(), vj)
    assert vj.sum() > 60
    np.testing.assert_allclose(st.u_right.numpy(), np.asarray(sj.u_right), atol=1e-3, rtol=0)
    np.testing.assert_allclose(st.depth.numpy()[vj], np.asarray(sj.depth)[vj], rtol=1e-4)


@pytest.mark.parametrize("n", [0, 1, 6, 7])
def test_nanmedian_matches_jax_even_and_odd(n):
    x = np.full(12, np.nan, np.float32)
    x[:n] = np.random.default_rng(n).uniform(0, 100, n)
    x[:n] = np.round(x[:n])   # exact halves show the mean of the two middles
    mj = float(jnp.nanmedian(jnp.asarray(x)))
    mt = float(tstereo.nanmedian(t(x)))
    assert (np.isnan(mj) and np.isnan(mt)) or mj == mt
    if n == 6:
        s = np.sort(x[:n])
        assert mt == (s[2] + s[3]) / 2 != float(torch.nanmedian(t(x)))


def test_depth_to_stereo_exact(jax_feats):
    fl = jax_feats[0]
    dm = pw.depth_map(WORLD, 0.3)
    dm[::3, ::5] = 0.0
    sj = jstereo.depth_to_stereo(fl, jnp.asarray(dm), 100.0, 0.5)
    st = tstereo.depth_to_stereo(features_from_numpy(_np_fields(fl), "cpu"), t(dm), 100.0, 0.5)
    for a, b in zip(st, sj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_extract_matches_jax(pair, jax_feats):
    fj = jax_feats[0]
    ft = torb.extract(pair[0], torb.OrbConfig(**CFG), device="cpu")
    same = (ft.xy.numpy() == np.asarray(fj.xy)).all(1) & (ft.valid.numpy() == np.asarray(fj.valid))
    assert same.mean() >= 0.99
    np.testing.assert_array_equal(ft.level.numpy(), np.asarray(fj.level))
    v = same & np.asarray(fj.valid)
    np.testing.assert_allclose(ft.angle.numpy()[v], np.asarray(fj.angle)[v], atol=1e-3, rtol=0)
    agree = (ft.desc.numpy()[v].view(np.uint32) == np.asarray(fj.desc)[v]).all(1)
    assert agree.mean() >= 0.99
    # a uint8 image goes up as uint8 and is cast on the device
    f8 = torb.extract(np.clip(pair[0], 0, 255).astype(np.uint8), torb.OrbConfig(**CFG),
                      device="cpu")
    assert f8.xy.shape == ft.xy.shape and f8.desc.dtype == torch.int32


def test_extract_on_host_arrays_needs_a_card_unless_cpu(pair):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError):
        torb.extract(pair[0])


@pytest.mark.cuda
def test_extract_on_card_matches_cpu():
    """The card's extraction and stereo match against the port's own CPU
    result on a KITTI-width pair: keypoints equal on ≥ 99%, descriptors
    equal wherever the keypoint is, depths within 1e-3 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    world = pw.KITTI
    tex = pw.make_texture(world)
    left = pw.render_u8(world, tex, 0.0)
    right = pw.render_u8(world, tex, world.baseline)
    cfg = torb.OrbConfig()
    bf = world.fx * world.baseline
    out = {}
    for dev in ("cuda", "cpu"):
        fl, fr = torb.extract_pair(left, right, cfg, device=dev)
        sm = tstereo.match_stereo(fl, fr, torb.to_image(left, dev), torb.to_image(right, dev),
                                  bf, min_z=bf / world.fx)
        out[dev] = [x.cpu() for x in (fl.xy, fl.valid, fl.desc, sm.valid, sm.depth)]
    (xg, vg, dg, sg, zg), (xc, vc, dc, sc, zc) = out["cuda"], out["cpu"]
    same = (xg == xc).all(1) & (vg == vc)
    assert float(same.float().mean()) >= 0.99
    both = same & vg
    assert bool((dg[both] == dc[both]).all())
    common = sg & sc & same
    assert int(common.sum()) >= 100   # the stereo initialization's minimum
    assert float(((zg - zc).abs() / zc)[common].max()) <= 1e-3
