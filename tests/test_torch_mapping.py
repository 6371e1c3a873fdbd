"""The port's keyframe point stage (`solvers/triangulate.py`,
`mapping/local_mapping.py`: triangulation, neighbor fusion, point and
keyframe culling, `kf_point_stage`) against the JAX package's, on the CPU,
on the same seeded inputs.

Tolerances: `triangulate_dlt` / `triangulate_two_views(_fast)` points 1e-4
relative, `acceptance_masks` equal; `triangulate_new_points` on
tests/test_triangulation_neighbors.py's construction (copied here) the
same slots, the same `kf_feat_pt` and new points within 1e-4 m;
`fuse_neighbors` `kf_feat_pt` equal; `cull_points` masks equal;
`cull_keyframes` the same culled slots in order and the same re-anchored
`pt_ref_kf`; `kf_point_stage` on a stereo and a mono keyframe every
`MapState` field, integers equal and floats within 1e-4, except the
points it triangulates (and their normals and depth ranges), within 1e-3
relative (see the test).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_slam_rgbd_tpu.frontend.orb import Features as JFeatures
from dsp_slam_rgbd_tpu.mapping import local_mapping as jlm
from dsp_slam_rgbd_tpu.mapping import map_state as jms
from dsp_slam_rgbd_tpu.ops import camera as jcam
from dsp_slam_rgbd_tpu.solvers import triangulate as jtri
from dsp_slam_rgbd_tpu.tracking.tracker import Frame as JFrame
from dsp_slam_rgbd_tpu_torch.mapping import local_mapping as tlm
from dsp_slam_rgbd_tpu_torch.mapping import map_state as tms
from dsp_slam_rgbd_tpu_torch.ops import camera as tcam
from dsp_slam_rgbd_tpu_torch.solvers import triangulate as ttri
from dsp_slam_rgbd_tpu_torch.tools import plane_world as pw
from dsp_slam_rgbd_tpu_torch.tracking import tracker as ttr
from dsp_slam_rgbd_tpu_torch.weights import (frame_to_numpy, map_state_from_numpy,
                                             map_state_to_numpy)
from test_system_e2e import make_cfg
from test_torch_tracking import port_config

CAM_ARGS = (100.0, 100.0, 64.0, 48.0, (0.0,) * 5, 0.0)   # the triangulation tests' mono camera


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def _np_state(state) -> dict:
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def _assert_state(ts, js, atol=1e-4, fields=None):
    """Port MapState vs JAX MapState: integer and bool fields equal (words
    as uint32), float fields within atol."""
    got = map_state_to_numpy(ts)
    for k in fields or jms.MapState._fields:
        want = np.asarray(getattr(js, k))
        if want.dtype.kind in "biu":
            np.testing.assert_array_equal(got[k], want, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want, atol=atol, rtol=0, err_msg=k)


# ------------------------------------------------------------ triangulate
def _two_view_problem(seed=0, n=300):
    """Two cameras 0.5 m apart, points 4-12 m ahead, pixel noise 0.5 px
    and 10% of the second view's points moved 5-30 px off their epipolar
    lines."""
    rng = np.random.default_rng(seed)
    t1 = np.eye(4, dtype=np.float32)
    t2 = np.eye(4, dtype=np.float32)
    t2[:3, :3] = np.asarray([[np.cos(0.05), 0, np.sin(0.05)], [0, 1, 0],
                             [-np.sin(0.05), 0, np.cos(0.05)]])
    t2[:3, 3] = [-0.5, 0.02, 0.1]
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(4, 12, n)], -1)
    cam = jcam.Intrinsics(200.0, 200.0, 112.0, 80.0)

    def proj(T):
        pc = pts @ T[:3, :3].T + T[:3, 3]
        return np.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
                         cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], -1)

    uv1 = proj(t1) + rng.normal(0, 0.5, (n, 2))
    uv2 = proj(t2) + rng.normal(0, 0.5, (n, 2))
    out = rng.random(n) < 0.1
    uv2[out, 1] += rng.choice([-1.0, 1.0], out.sum()) * rng.uniform(5, 30, out.sum())
    return cam, t1, t2, uv1.astype(np.float32), uv2.astype(np.float32)


def test_triangulation_matches_jax():
    cam, t1, t2, uv1, uv2 = _two_view_problem()
    tc = tcam.Intrinsics(*cam)
    J = [jnp.asarray(a) for a in (t1, t2, uv1, uv2)]
    T = [t(a) for a in (t1, t2, uv1, uv2)]
    x1 = (uv1 - [cam.cx, cam.cy]) / [cam.fx, cam.fy]
    x2 = (uv2 - [cam.cx, cam.cy]) / [cam.fx, cam.fy]
    pairs = [
        (ttri.triangulate_dlt(t(t1[:3]), t(t2[:3]), t(x1.astype(np.float32)),
                              t(x2.astype(np.float32))),
         jtri.triangulate_dlt(jnp.asarray(t1[:3]), jnp.asarray(t2[:3]),
                              jnp.asarray(x1.astype(np.float32)),
                              jnp.asarray(x2.astype(np.float32)))),
        (ttri.triangulate_two_views(tc, tc, *T), jtri.triangulate_two_views(cam, cam, *J)),
        (ttri.triangulate_two_views_fast(tc, tc, *T),
         jtri.triangulate_two_views_fast(cam, cam, *J)),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)
    pts = pairs[2][1]
    mj = jtri.acceptance_masks(cam, cam, J[0], J[1], pts, J[2], J[3])
    mt = ttri.acceptance_masks(tc, tc, T[0], T[1], t(pts), T[2], T[3])
    for k in ("parallax", "depth", "reproj"):
        np.testing.assert_array_equal(mt[k].numpy(), np.asarray(mj[k]), err_msg=k)
    assert 0 < int(mt["reproj"].sum()) < len(uv1)      # the outliers fail the χ² gate


# ------------------------------------------- multi-neighbor triangulation
def _pose_at(x):
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = -x  # T_cw for a camera at world (x, 0, 0)
    return T


def _build_state(rng):
    """tests/test_triangulation_neighbors.py's construction: 4 KFs along
    x; 20 shared points keep every pair covisible; each neighbor KF shares
    10 exclusive unmatched feature pairs with the new KF 3."""
    cam = jcam.Intrinsics(*CAM_ARGS)
    st = jms.empty(max_kf=8, max_feat=64, max_pts=256, max_obj=2)
    kf_x = [0.0, 0.5, 1.0, 1.5]
    shared = np.stack([rng.uniform(-2, 2, 20), rng.uniform(-1.5, 1.5, 20),
                       rng.uniform(4.5, 6.0, 20)], -1).astype(np.float32)
    excl = {k: np.stack([rng.uniform(-2, 2, 10), rng.uniform(-1.5, 1.5, 10),
                         rng.uniform(4.5, 6.0, 10)], -1).astype(np.float32) for k in range(3)}

    kf_xy = np.zeros((8, 64, 2), np.float32)
    kf_desc = rng.integers(0, 2**32, (8, 64, 8), dtype=np.uint64).astype(np.uint32)
    kf_feat_valid = np.zeros((8, 64), bool)
    kf_feat_pt = np.full((8, 64), -1, np.int32)
    pt_pos = np.zeros((256, 3), np.float32)
    pt_pos[:20] = shared

    def proj(x_cam, pts):
        pc = pts - np.array([x_cam, 0, 0], np.float32)
        return np.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
                         cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], -1)

    shared_desc = rng.integers(0, 2**32, (20, 8), dtype=np.uint64).astype(np.uint32)
    for k in range(4):
        kf_xy[k, :20] = proj(kf_x[k], shared)
        kf_desc[k, :20] = shared_desc
        kf_feat_valid[k, :20] = True
        kf_feat_pt[k, :20] = np.arange(20)
    for k in range(3):
        d = rng.integers(0, 2**32, (10, 8), dtype=np.uint64).astype(np.uint32)
        kf_xy[k, 20:30] = proj(kf_x[k], excl[k])
        kf_desc[k, 20:30] = d
        kf_feat_valid[k, 20:30] = True
        s = 20 + 10 * k
        kf_xy[3, s:s + 10] = proj(kf_x[3], excl[k])
        kf_desc[3, s:s + 10] = d
        kf_feat_valid[3, s:s + 10] = True

    st = st._replace(
        kf_pose=jnp.asarray(np.stack([_pose_at(x) for x in kf_x]
                                     + [np.eye(4, dtype=np.float32)] * 4)),
        kf_valid=jnp.asarray([True] * 4 + [False] * 4),
        kf_frame_id=jnp.asarray([0, 1, 2, 3, -1, -1, -1, -1], jnp.int32),
        kf_xy=jnp.asarray(kf_xy),
        kf_desc=jnp.asarray(kf_desc),
        kf_feat_valid=jnp.asarray(kf_feat_valid),
        kf_feat_pt=jnp.asarray(kf_feat_pt),
        pt_pos=jnp.asarray(pt_pos),
        pt_valid=jnp.asarray([True] * 20 + [False] * 236),
    )
    return st, excl, shared_desc


@pytest.mark.parametrize("n_neighbors", [1, 3])
def test_triangulate_new_points_matches_jax(n_neighbors):
    js, excl, _ = _build_state(np.random.default_rng(3))
    ts = map_state_from_numpy(_np_state(js), "cpu")
    cam_j, cam_t = jcam.Intrinsics(*CAM_ARGS), tcam.Intrinsics(*CAM_ARGS)
    oj = jlm.triangulate_new_points(js, cam_j, 3, n_neighbors=n_neighbors, first_id=7)
    ot = tlm.triangulate_new_points(ts, cam_t, 3, n_neighbors=n_neighbors, first_id=7)
    new = np.asarray(oj.pt_valid) & ~np.asarray(js.pt_valid)
    np.testing.assert_array_equal(ot.pt_valid.numpy(), np.asarray(oj.pt_valid))   # the same slots
    np.testing.assert_array_equal(ot.kf_feat_pt.numpy(), np.asarray(oj.kf_feat_pt))
    np.testing.assert_allclose(ot.pt_pos.numpy()[new], np.asarray(oj.pt_pos)[new], atol=1e-4)
    _assert_state(ot, oj, atol=1e-4)
    # tests/test_triangulation_neighbors.py's own bounds, for the port
    assert new.sum() <= 10 if n_neighbors == 1 else new.sum() >= 24
    truth = np.concatenate([excl[0], excl[1], excl[2]])
    d = np.linalg.norm(ot.pt_pos.numpy()[new][:, None] - truth[None], axis=-1).min(1)
    assert np.median(d) < 0.05


def test_fuse_neighbors_matches_jax():
    """The same map with KF 3's associations to shared points 0-3 cut and
    the points given their descriptors: fusion re-associates them by
    projection (16 shared points keep KF 3 covisible with the others)."""
    js, _, shared_desc = _build_state(np.random.default_rng(3))
    feat_pt = np.asarray(js.kf_feat_pt).copy()
    feat_pt[3, :4] = -1
    pt_desc = np.asarray(js.pt_desc).copy()
    pt_desc[:20] = shared_desc
    js = js._replace(kf_feat_pt=jnp.asarray(feat_pt), pt_desc=jnp.asarray(pt_desc))
    ts = map_state_from_numpy(_np_state(js), "cpu")
    oj = jlm.fuse_neighbors(js, jcam.Intrinsics(*CAM_ARGS), 3)
    ot = tlm.fuse_neighbors(ts, tcam.Intrinsics(*CAM_ARGS), 3)
    np.testing.assert_array_equal(ot.kf_feat_pt.numpy(), np.asarray(oj.kf_feat_pt))
    np.testing.assert_array_equal(ot.kf_feat_pt.numpy()[3, :4], np.arange(4))


# ---------------------------------------------------------------- culling
def test_cull_points_matches_jax():
    """test_cull_points_judges_recent_only's map (tests/test_mapping.py)."""
    st = jms.empty(max_kf=4, max_feat=8, max_pts=8, max_obj=2)
    js = st._replace(
        kf_valid=jnp.asarray([True, True, True, False]),
        kf_feat_valid=jnp.ones((4, 8), bool),
        pt_valid=jnp.asarray([True, True, True, True] + [False] * 4),
        pt_first_kf=jnp.asarray([0, 9, 8, 8] + [-1] * 4, jnp.int32),
        pt_visible=jnp.asarray([100, 100, 4, 4] + [1] * 4, jnp.int32),
        pt_found=jnp.asarray([2, 2, 4, 4] + [1] * 4, jnp.int32),
        kf_feat_pt=jnp.asarray([[0, 1, 2, 3, -1, -1, -1, -1], [2, -1, -1, -1, -1, -1, -1, -1],
                                [-1] * 8, [-1] * 8], jnp.int32),
        kf_ur=jnp.where(jnp.arange(8)[None, :] < 4, 5.0, -1.0) * jnp.ones((4, 1)),
    )
    ts = map_state_from_numpy(_np_state(js), "cpu")
    for current, min_obs in ((10, 4), (10, 3), (9, 4)):
        oj = jlm.cull_points(js, current_id=current, min_obs_after=min_obs)
        ot = tlm.cull_points(ts, current_id=current, min_obs_after=min_obs)
        _assert_state(ot, oj, atol=0)
    keep = tlm.cull_points(ts, 10, min_obs_after=4).pt_valid.numpy()
    np.testing.assert_array_equal(keep[:4], [True, False, True, False])


def test_cull_keyframes_matches_jax():
    """test_multi_kf_culling's map (6 KFs all observing the same 30 points)
    with points anchored on the keyframes that get culled: the same culled
    slots in order, and the same re-anchored references."""
    st = jms.empty(max_kf=8, max_feat=32, max_pts=64, max_obj=2)
    kf_feat_pt = np.full((8, 32), -1, np.int32)
    for k in range(6):
        kf_feat_pt[k, :30] = np.arange(30)
    kf_feat_pt[0, 30] = 31      # point 31 seen by KF 0 only
    js = st._replace(
        kf_valid=jnp.asarray([True] * 6 + [False] * 2),
        kf_frame_id=jnp.asarray([3, 9, 4, 8, 5, 11, -1, -1], jnp.int32),
        kf_feat_valid=jnp.ones((8, 32), bool),
        kf_feat_pt=jnp.asarray(kf_feat_pt),
        pt_valid=jnp.asarray([True] * 30 + [False, True] + [False] * 32),
        pt_ref_kf=jnp.asarray(np.arange(64) % 6, jnp.int32),
    )
    ts = map_state_from_numpy(_np_state(js), "cpu")
    for max_cull in (2, 4):
        sj, cj = jlm.cull_keyframes(js, 5, max_cull=max_cull)
        st_, ct = tlm.cull_keyframes(ts, 5, max_cull=max_cull)
        assert ct == cj and len(ct) >= 2 and 5 not in ct
        _assert_state(st_, sj, atol=0)
        ref = st_.pt_ref_kf.numpy()
        assert not np.isin(ref[:30], ct).any()       # nothing left on a culled slot


# ---------------------------------------------------- the keyframe stage
@pytest.fixture(scope="module")
def stage_inputs():
    """A map of two stereo keyframes of the tilted-plane world (frames 0
    and 3, through the port's `kf_point_stage`) and the frames of a third
    keyframe (frame 6), stereo and mono.  Frames 3 and 6 start at their
    true poses and are tracked against the map (the port's local-map
    stage) before they become keyframes, so they carry associations."""
    world = pw.SMALL
    tex = pw.make_texture(world)
    jc = make_cfg("stereo")
    cfg = port_config(jc)
    tr = ttr.Tracker(cfg, tms.empty(max_kf=8, max_feat=512, max_pts=2048, max_obj=2,
                                    code_len=4, max_oobs=8, device="cpu"), device="cpu")
    th = cfg.tracking.th_depth * cfg.cam.bf / cfg.cam.fx

    def frame(i, stereo):
        x = pw.gt_x(world, i)
        f = tr.make_frame(pw.render(world, tex, x),
                          pw.render(world, tex, x + world.baseline) if stereo else None,
                          timestamp=i * 0.1)
        return f._replace(t_cw=t(_pose_at(x)))

    def tracked(i, stereo):
        tr.state = st
        return tr._track_local_map(frame(i, stereo))[0]

    st = tlm.kf_point_stage(tr.state, cfg.cam, 0, frame(0, True), 0, th, 0, True, 10, 4)
    st = tlm.kf_point_stage(st, cfg.cam, 1, tracked(3, True), 3, th, 1, True, 10, 4)
    return st, {s: tracked(6, s) for s in (True, False)}, jc.cam, th


def _jax_frame(f):
    d = frame_to_numpy(f)
    return JFrame(JFeatures(*[jnp.asarray(d["feats"][k]) for k in JFeatures._fields]),
                  *[jnp.asarray(d[k]) for k in ("ur", "depth", "t_cw", "pt_idx")],
                  d["timestamp"])


@pytest.mark.parametrize("stereo", [True, False])
def test_kf_point_stage_matches_jax(stage_inputs, stereo):
    """The whole stage on a third keyframe: stereo (spawn + triangulation
    with the baseline gate) and mono (no spawn; the median-depth gate)."""
    ts, frames, cam, th = stage_inputs
    if not stereo:
        cam = cam._replace(bf=0.0)
    js = jms.MapState(**{k: jnp.asarray(v) for k, v in map_state_to_numpy(ts).items()})
    n_nb, min_obs = (10, 4) if stereo else (20, 3)
    oj = jlm.kf_point_stage(js, cam, 2, _jax_frame(frames[stereo]), 6, th, 2, stereo, n_nb,
                            min_obs)
    ot = tlm.kf_point_stage(ts, tcam.Intrinsics(*cam), 2, frames[stereo], 6, th, 2, stereo,
                            n_nb, min_obs)
    point_geometry = ("pt_pos", "pt_normal", "pt_min_d", "pt_max_d")
    _assert_state(ot, oj, atol=1e-4,
                  fields=[k for k in jms.MapState._fields if k not in point_geometry])
    # the same points were made; old points within 1e-4.  Points made here
    # by two-view triangulation (0.36-0.72 m baselines, 8-10 m depths:
    # f32 rounding grows by (depth/baseline)² in the 3x3 solve) within
    # 1e-3 relative (measured 7e-5 stereo, 2.5e-4 mono)
    before, after = ts.pt_valid.numpy(), ot.pt_valid.numpy()
    new = after & ~before
    got = map_state_to_numpy(ot)
    for k in point_geometry:
        want = np.asarray(getattr(oj, k))
        np.testing.assert_allclose(got[k][~new], want[~new], atol=1e-4, rtol=0, err_msg=k)
        np.testing.assert_allclose(got[k][new], want[new], atol=1e-4, rtol=1e-3, err_msg=k)
    assert new.sum() > (20 if stereo else 5)       # points were made
    assert (ot.kf_feat_pt.numpy()[2] >= 0).sum() > 50             # and associated
