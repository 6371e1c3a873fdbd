"""The port's detection assembly (`system/detections.py`) and map-object
logic (`mapping/objects.py`) against the JAX package's, on the CPU, on
the same seeded numpy inputs.

Tolerances: the detection functions are numpy in both packages and must
give byte-equal arrays (the same `rng` where one is drawn); every
function of `objects.py` within 1e-6, integers and masks equal.  The
inputs of tests/test_kitti_assembly.py and tests/test_mono_objects.py's
PCA test are reused.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_slam_rgbd_tpu.mapping import objects as jobj
from dsp_slam_rgbd_tpu.system import detections as jdet
from dsp_slam_rgbd_tpu_torch.mapping import objects as tobj
from dsp_slam_rgbd_tpu_torch.system import detections as tdet
from test_kitti_assembly import H, K, N_CAR, T_CAM_VELO, W, _mask_of, _scene

ATOL = 1e-6


def t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def _same(a, b, what=""):
    """Byte-equal numpy outputs (or both None)."""
    if a is None or b is None:
        assert a is None and b is None, what
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def _same_detection(d_t, d_j):
    assert type(d_t).__name__ == type(d_j).__name__
    for name, x, y in zip(d_j._fields, d_t, d_j):
        _same(x, y, name)


def _close(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)


# ---------------------------------------------------------------- detections
@pytest.mark.parametrize("case", ["two_cars", "stray_mask"])
def test_kitti_assembly_matches_jax(case):
    rng = np.random.default_rng(0 if case == "two_cars" else 1)
    velo, boxes = _scene(rng)
    if case == "two_cars":
        m_near, bb_near = _mask_of(velo[:N_CAR])
        m_far, bb_far = _mask_of(velo[N_CAR:2 * N_CAR])
        masks, bboxes = np.stack([m_far, m_near]), np.stack([bb_far, bb_near])
    else:
        masks = np.zeros((1, H, W), bool)
        masks[0, 5:40, 5:60] = True
        bboxes = np.array([[5, 5, 60, 40]], np.float32)
        boxes = boxes[:1]
    args = (K, np.linalg.inv(K), T_CAM_VELO, velo, boxes, masks, bboxes, (H, W))
    d_t, o_t = tdet.assemble_kitti_detections(*args, min_mask_area=50)
    d_j, o_j = jdet.assemble_kitti_detections(*args, min_mask_area=50)
    assert len(d_t) == len(d_j) > 0
    for a, b in zip(d_t, d_j):
        _same_detection(a, b)
    for a, b in zip(o_t, o_j):
        _same(a, b, "occlusion mask")


def test_crop_and_box_pose_match_jax():
    rng = np.random.default_rng(2)
    velo = rng.uniform(-6, 6, (4000, 3)).astype(np.float32)
    T = jdet.box_to_t_velo_obj(np.array([1.0, -0.5, 0.2]), np.array([1.8, 4.0, 1.5]), 0.3)
    _same(tdet.box_to_t_velo_obj(np.array([1.0, -0.5, 0.2]), np.array([1.8, 4.0, 1.5]), 0.3),
          T, "box pose")
    for max_pts in (256, 40):     # the second subsamples
        _same(tdet.crop_lidar_to_box(velo, T, (1.8, 1.5, 4.0), max_pts=max_pts),
              jdet.crop_lidar_to_box(velo, T, (1.8, 1.5, 4.0), max_pts=max_pts), "crop")


def test_background_samplers_match_jax():
    m_near, bb_near = _mask_of(_scene(np.random.default_rng(0))[0][:N_CAR])
    for alpha in (8, 3):
        _same(tdet._pixels_sampler(bb_near, m_near, (H, W), alpha),
              jdet._pixels_sampler(bb_near, m_near, (H, W), alpha), "pixels_sampler")
    invK = np.linalg.inv(K)
    box = (int(bb_near[0]), int(bb_near[1]), int(bb_near[2]), int(bb_near[3]))
    for n_bg, mask in ((200, m_near), (10_000, m_near), (50, None)):
        _same(tdet.sample_background_rays(box, mask, invK, n_bg, np.random.default_rng(4)),
              jdet.sample_background_rays(box, mask, invK, n_bg, np.random.default_rng(4)),
              "background rays")


@pytest.mark.parametrize("erode", [2, 0])
def test_mono_detection_from_mask_matches_jax(erode):
    rng = np.random.default_rng(5)
    mask = np.zeros((160, 224), bool)
    mask[40:100, 60:150] = True
    mask[70:75, 150:170] = True    # a thin limb that erosion removes
    xy = rng.uniform(-10, 240, (300, 2)).astype(np.float32)
    invK = np.linalg.inv(np.array([[200.0, 0, 112.0], [0, 200.0, 80.0], [0, 0, 1]],
                                  np.float32))
    d_t = tdet.mono_detection_from_mask(mask, invK, feats_xy=xy, erode=erode,
                                        rng=np.random.default_rng(6))
    d_j = jdet.mono_detection_from_mask(mask, invK, feats_xy=xy, erode=erode,
                                        rng=np.random.default_rng(6))
    _same_detection(d_t, d_j)
    assert d_t.is_good
    empty = np.zeros_like(mask)
    _same_detection(tdet.mono_detection_from_mask(empty, invK, feats_xy=xy),
                    jdet.mono_detection_from_mask(empty, invK, feats_xy=xy))


# ------------------------------------------------------------------- objects
def _association_case(case):
    """Object centers, flags, velocities, detection poses and camera for a
    case: 'gate' (one object beyond the 4 m gate, one detection claimed by
    two objects, an invalid object and detection), 'dynamic' (a mover
    predicted by its velocity onto another detection), 'tie' (two objects
    at exactly the same distance from one detection: both keep it)."""
    t_cw = np.eye(4, dtype=np.float32)
    t_cw[:3, 3] = [-0.5, 0.0, 0.25]
    if case == "tie":
        centers = np.array([[1.0, 0.0, 4.75], [2.0, 0.0, 4.75], [9.0, 0, 9.0]], np.float32)
        det_c = np.array([[1.0, 0.3, 5.0]], np.float32)
        dyn = np.zeros(3, bool)
        vel = np.zeros((3, 3), np.float32)
        valid = np.array([True, True, False])
        det_valid = np.ones(1, bool)
    else:
        centers = np.array([[0.0, 0.0, 6.0], [0.4, 0.1, 6.2], [3.0, 0.0, 12.0],
                            [-2.0, 0.0, 5.0], [0.0, 0.0, 30.0]], np.float32)
        det_c = np.array([[0.6, 0.0, 5.7], [3.9, 0.0, 11.5], [-0.5, 0.0, 5.0],
                          [0.0, 0.0, 22.0]], np.float32)
        dyn = np.zeros(5, bool)
        vel = np.zeros((5, 3), np.float32)
        if case == "dynamic":
            dyn[3] = True
            vel[3] = [2.4, 0.0, 0.5]
        valid = np.array([True, True, True, True, True])
        det_valid = np.array([True, True, True, False])
    det_t = np.tile(np.eye(4, dtype=np.float32), (len(det_c), 1, 1))
    det_t[:, :3, 3] = det_c
    return centers, valid, dyn, vel, det_t, det_valid, t_cw


@pytest.mark.parametrize("case", ["gate", "dynamic", "tie"])
def test_associate_detections_matches_jax(case):
    args = _association_case(case)
    a_t, u_t = tobj.associate_detections(*(t(a) for a in args))
    a_j, u_j = jobj.associate_detections(*(jnp.asarray(a) for a in args))
    _close(a_t, a_j)
    _close(u_t, u_j)
    if case == "tie":
        assert a_t.tolist() == [0, 0, -1]   # both tied objects keep detection 0
    if case == "dynamic":
        assert int(a_t[3]) == 0              # the mover's prediction reaches detection 0


def _pca_clouds():
    rng = np.random.default_rng(1)
    pts = np.stack([rng.uniform(-2, 2, 300), rng.uniform(-0.3, 0.3, 300),
                    rng.uniform(-0.8, 0.8, 300)], -1).astype(np.float32)
    far = pts.copy()
    far[0] = [5.0, 0.0, 0.0]
    tilted = pts @ np.array([[0.8, 0.0, 0.6], [0.0, 1.0, 0.0], [-0.6, 0.0, 0.8]],
                            np.float32) + [1.0, 0.5, 8.0]
    mask = np.ones(300, bool)
    part = mask.copy()
    part[::7] = False
    return [(pts, mask), (far, mask), (tilted.astype(np.float32), part)]


@pytest.mark.parametrize("case", [0, 1, 2])
def test_pca_cuboid_matches_jax(case):
    """tests/test_mono_objects.py's clouds (and a tilted, partly masked
    one): the same box on the CPU, eigenvector signs included."""
    pts, mask = _pca_clouds()[case]
    c_t = tobj.cuboid_from_points_pca(t(pts), t(mask))
    c_j = jobj.cuboid_from_points_pca(jnp.asarray(pts), jnp.asarray(mask))
    for got, want in zip(c_t, c_j):
        _close(got, want)
    if case == 1:
        assert bool(c_t.outlier[0])


def test_outlier_gates_match_jax():
    rng = np.random.default_rng(3)
    pts = (rng.standard_normal((200, 3)) * 0.8 + [0.5, 0.0, 6.0]).astype(np.float32)
    owned = rng.random(200) < 0.7
    _close(tobj.remove_outliers_simple(t(pts), t(owned)),
           jobj.remove_outliers_simple(jnp.asarray(pts), jnp.asarray(owned)))
    t_wo = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.4), np.sin(0.4)
    t_wo[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    t_wo[:3, 3] = [0.5, 0.0, 6.0]
    bb_min = np.array([-0.4, -0.3, -0.5], np.float32)
    bb_max = np.array([0.45, 0.3, 0.5], np.float32)
    for scale in (1.5, 0.0):     # the second hits the 1e-6 floor
        out_t = tobj.model_outliers(t(pts), t(owned), t(t_wo), scale, t(bb_min), t(bb_max))
        out_j = jobj.model_outliers(jnp.asarray(pts), jnp.asarray(owned), jnp.asarray(t_wo),
                                    scale, jnp.asarray(bb_min), jnp.asarray(bb_max))
        _close(out_t, out_j)
    assert 0 < int(out_t.sum()) < int(owned.sum()) or scale == 0.0


def test_dynamics_nbv_and_culling_match_jax():
    rng = np.random.default_rng(4)
    prev = rng.standard_normal((6, 3)).astype(np.float32)
    new = (prev + rng.standard_normal((6, 3)) * 0.3).astype(np.float32)
    vel = rng.standard_normal((6, 3)).astype(np.float32)
    got = tobj.update_dynamics(t(prev), t(new), 1.0, t(vel))
    for i in range(6):     # the JAX package's function is per object (vmapped by its callers)
        want = jobj.update_dynamics(jnp.asarray(prev[i]), jnp.asarray(new[i]), 1.0,
                                    jnp.asarray(vel[i]))
        for g, w in zip(got, want):
            _close(g[i], w)
    assert 0 < int(got[1].sum()) < 6
    for standoff in (None, 3.0):
        _close(tobj.compute_nbv(t(new[0]), t(prev[0]), standoff),
               jobj.compute_nbv(jnp.asarray(new[0]), jnp.asarray(prev[0]), standoff))
    valid = np.array([True, True, True, False, True])
    n_obs = np.array([1, 3, 1, 1, 0], np.int32)
    last = np.array([2, 0, 30, 0, 5], np.int32)
    _close(tobj.cull_objects(t(valid), t(n_obs), t(last), 31),
           jobj.cull_objects(jnp.asarray(valid), jnp.asarray(n_obs), jnp.asarray(last), 31))
