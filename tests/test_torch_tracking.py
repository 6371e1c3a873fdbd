"""The port's tracking path (camera ops, pose GN, map state, covisibility,
the keyframe bootstrap, PnP, the tracking stage and the `Tracker`)
against the JAX package's, on the CPU, on the same seeded inputs (the
224×160 tilted-plane world of tests/test_system_e2e.py).

Tolerances: camera ops 1e-5; `optimize_pose` (mono and stereo, 20%
outliers) pose 1e-4 and the same inliers; the `MapState` round trip,
covisibility rows and the local window exact; the bootstrap functions
1e-5; `_dlt_pnp`/`_planar_pnp` on fixed samples 1e-3; `solve_pnp_ransac`
recovers a noiseless pose to 1e-3 in both packages (their trial samples
differ); `_track_stage_core` and the motion-model stage equal stats and
pose 1e-4; the fallback chain (reference keyframe 1e-4, relocalization
and the local-map stage after it 1e-3, the same matches).  The 10-frame
stereo and RGB-D sequences run through both packages with the same
keyframe bootstrap (tests/tracking_driver.py): each ≥ 80% of frames OK and
largest error < 0.08 m (the bands of tests/test_rgbd_e2e.py), the two
trajectories within 1e-2 m frame by frame; the same sequences again with
the full keyframe stage (point stage, local BA, keyframe culling): the
same bands, keyframe count and culled slots.  The recent-keyframe lists
go by slot order in both packages after culling.
"""
import copy
import dataclasses
import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracking_driver as td
from dsp_slam_rgbd_tpu import config as jconfig
from dsp_slam_rgbd_tpu.frontend.orb import Features as JFeatures
from dsp_slam_rgbd_tpu.mapping import covisibility as jcov
from dsp_slam_rgbd_tpu.mapping import local_mapping as jlm
from dsp_slam_rgbd_tpu.mapping import map_state as jms
from dsp_slam_rgbd_tpu.ops import camera as jcam
from dsp_slam_rgbd_tpu.ops import lie as jlie
from dsp_slam_rgbd_tpu.solvers import pnp as jpnp
from dsp_slam_rgbd_tpu.solvers import pose_gn as jgn
from dsp_slam_rgbd_tpu.tracking import tracker as jtr
from dsp_slam_rgbd_tpu_torch import config as tconfig
from dsp_slam_rgbd_tpu_torch.frontend.orb import OrbConfig
from dsp_slam_rgbd_tpu_torch.mapping import covisibility as tcov
from dsp_slam_rgbd_tpu_torch.mapping import local_mapping as tlm
from dsp_slam_rgbd_tpu_torch.mapping import map_state as tms
from dsp_slam_rgbd_tpu_torch.ops import camera as tcam
from dsp_slam_rgbd_tpu_torch.solvers import pnp as tpnp
from dsp_slam_rgbd_tpu_torch.solvers import pose_gn as tgn
from dsp_slam_rgbd_tpu_torch.tools import plane_world as pw
from dsp_slam_rgbd_tpu_torch.tracking import tracker as ttr
from dsp_slam_rgbd_tpu_torch.weights import (frame_from_numpy, frame_to_numpy,
                                             map_state_from_numpy, map_state_to_numpy)
from test_system_e2e import make_cfg

WORLD = pw.SMALL
CAM_ARGS = (200.0, 200.0, 112.0, 80.0, (0.0,) * 5, 100.0)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def port_config(j) -> tconfig.SystemConfig:
    """The port's SystemConfig with the numbers of a JAX one."""
    return tconfig.SystemConfig(
        sensor=j.sensor, cam=tcam.Intrinsics(*j.cam), orb=OrbConfig(*j.orb),
        tracking=tconfig.TrackingConfig(**dataclasses.asdict(j.tracking)),
        map=tconfig.MapConfig(**dataclasses.asdict(j.map)),
        async_kf_frames=j.async_kf_frames)


def _np_state(state) -> dict:
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def _np_frame(frame) -> dict:
    return {"feats": {k: np.asarray(v) for k, v in frame.feats._asdict().items()},
            "ur": np.asarray(frame.ur), "depth": np.asarray(frame.depth),
            "t_cw": np.asarray(frame.t_cw), "pt_idx": np.asarray(frame.pt_idx),
            "timestamp": frame.timestamp}


def _both_runs(stage):
    """Both packages' trackers over the 10-frame stereo and RGB-D
    sequences, with the same keyframe stage."""
    tex = pw.make_texture(WORLD)
    out = {}
    for sensor in ("stereo", "rgbd"):
        seq = td.frames(WORLD, tex, sensor, 10)
        jc = make_cfg(sensor)
        out[sensor] = {
            "jax": td.drive(jms, jlm, jtr, jc, seq, code_len=4, stage=stage),
            "torch": td.drive(tms, tlm, ttr, port_config(jc), seq, code_len=4, stage=stage,
                              device="cpu"),
            "seq": seq}
    return out


@pytest.fixture(scope="module")
def runs():
    return _both_runs("bootstrap")


@pytest.fixture(scope="module")
def full_runs():
    return _both_runs("full")


# ---------------------------------------------------------------- geometry
def test_camera_ops_match_jax():
    rng = np.random.default_rng(0)
    p = (rng.standard_normal((500, 3)) * [3, 2, 1] + [0, 0, 8]).astype(np.float32)
    uv = rng.uniform(0, 224, (500, 2)).astype(np.float32)
    d = rng.uniform(1, 20, 500).astype(np.float32)
    for args in (CAM_ARGS, (718.856, 718.856, 620.5, 188.0,
                            (-0.2, 0.05, 1e-3, -2e-3, 0.01), 386.0)):
        J, T = jcam.Intrinsics(*args), tcam.Intrinsics(*args)
        pairs = [
            (jcam.project(J, jnp.asarray(p)), tcam.project(T, t(p))),
            (jcam.project_stereo(J, jnp.asarray(p)), tcam.project_stereo(T, t(p))),
            (jcam.backproject(J, jnp.asarray(uv), jnp.asarray(d)),
             tcam.backproject(T, t(uv), t(d))),
            (jcam.pixel_rays(J, jnp.asarray(uv)), tcam.pixel_rays(T, t(uv))),
            (jcam.distort(J, jnp.asarray(p[:, :2] / 8)), tcam.distort(T, t(p[:, :2] / 8))),
            (jcam.undistort_pixels(J, jnp.asarray(uv)), tcam.undistort_pixels(T, t(uv))),
            (J.K, T.K), (J.K_inv, T.K_inv)]
        for a, b in pairs:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=0)
    assert hash(tcam.Intrinsics(*CAM_ARGS)) == hash(tcam.Intrinsics(*CAM_ARGS))


def _pose_problem(seed, stereo):
    """A camera pose, 300 points in front of it, observations with noise and
    20% gross outliers, and a perturbed initial pose."""
    rng = np.random.default_rng(seed)
    cam = jcam.Intrinsics(*CAM_ARGS)
    T = np.asarray(jlie.exp_se3(jnp.asarray([0.1, -0.05, 0.2, 0.02, -0.03, 0.01])))
    pts_c = np.stack([rng.uniform(-4, 4, 300), rng.uniform(-3, 3, 300),
                      rng.uniform(4, 15, 300)], -1)
    pts_w = (pts_c - T[:3, 3]) @ T[:3, :3]
    obs = np.asarray(jcam.project_stereo(cam, jnp.asarray(pts_c, jnp.float32)))
    obs = obs + rng.normal(0, 0.5, obs.shape)
    out = rng.random(300) < 0.2
    obs[out] += rng.uniform(-40, 40, (out.sum(), 3))
    obs[rng.random(300) < 0.1, 2] = -1.0          # mono edges in a stereo fit
    level = rng.integers(0, 3, 300)
    T0 = np.asarray(jlie.exp_se3(jnp.asarray([0.03, 0.02, -0.04, 0.01, 0.0, -0.01]))) @ T
    valid = rng.random(300) > 0.05
    return (T0.astype(np.float32), pts_w.astype(np.float32),
            (obs if stereo else obs[:, :2]).astype(np.float32),
            (1.0 / 1.2 ** (2 * level)).astype(np.float32), valid, T)


@pytest.mark.parametrize("stereo", [False, True])
def test_optimize_pose_matches_jax(stereo):
    T0, pts, obs, inv_s2, valid, T_true = _pose_problem(1, stereo)
    cam = CAM_ARGS
    rj = jgn.optimize_pose(jcam.Intrinsics(*cam), jnp.asarray(T0), jnp.asarray(pts),
                           jnp.asarray(obs), jnp.asarray(inv_s2), jnp.asarray(valid),
                           stereo=stereo)
    rt = tgn.optimize_pose(tcam.Intrinsics(*cam), t(T0), t(pts), t(obs), t(inv_s2), t(valid),
                           stereo=stereo)
    np.testing.assert_allclose(rt.t_cw.numpy(), np.asarray(rj.t_cw), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers) > 150
    assert np.abs(rt.t_cw.numpy()[:3, 3] - T_true[:3, 3]).max() < 0.05


def _random_state(seed=0, K=8, F=16, P=40):
    """A JAX MapState with random keyframes, observations and descriptor
    words (some with bit 31 set)."""
    rng = np.random.default_rng(seed)
    st = jms.empty(max_kf=K, max_feat=F, max_pts=P, max_obj=2, code_len=4, max_oobs=4)
    kf_feat_pt = rng.integers(-1, P, (K, F)).astype(np.int32)
    kf_feat_pt[:, :6] = np.arange(6)            # shared points: covisible KFs
    kf_feat_pt[3:5, 6:12] = np.arange(20, 26)
    words = rng.integers(0, 2 ** 32, (P, 8), dtype=np.uint64).astype(np.uint32)
    words[0] = 0x80000001
    poses = np.stack([np.asarray(jlie.exp_se3(jnp.asarray(rng.normal(0, 0.1, 6))))
                      for _ in range(K)]).astype(np.float32)
    return st._replace(
        kf_pose=jnp.asarray(poses),
        kf_valid=jnp.asarray(rng.random(K) > 0.15),
        kf_frame_id=jnp.asarray(rng.permutation(K).astype(np.int32) * 3),
        kf_xy=jnp.asarray(rng.uniform(0, 200, (K, F, 2)).astype(np.float32)),
        kf_level=jnp.asarray(rng.integers(0, 3, (K, F)).astype(np.int32)),
        kf_desc=jnp.asarray(rng.integers(0, 2 ** 32, (K, F, 8), dtype=np.uint64)
                            .astype(np.uint32)),
        kf_ur=jnp.asarray(np.where(rng.random((K, F)) > 0.3, 50.0, -1.0).astype(np.float32)),
        kf_feat_valid=jnp.asarray(rng.random((K, F)) > 0.1),
        kf_feat_pt=jnp.asarray(kf_feat_pt),
        pt_pos=jnp.asarray((rng.normal(0, 2, (P, 3)) + [0, 0, 8]).astype(np.float32)),
        pt_valid=jnp.asarray(rng.random(P) > 0.2),
        pt_desc=jnp.asarray(words),
        pt_ref_kf=jnp.asarray(rng.integers(-1, K, P).astype(np.int32)),
    )


def test_map_state_round_trip_is_exact():
    js = _random_state()
    fields = _np_state(js)
    ts = map_state_from_numpy(fields, "cpu")
    assert ts.pt_desc.dtype == torch.int32
    back = map_state_to_numpy(ts)
    for k, v in fields.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert (back["pt_desc"] >= 2 ** 31).any()
    # the port's empty state is the JAX package's, field by field
    e = map_state_to_numpy(tms.empty(max_kf=5, max_feat=7, max_pts=11, max_obj=3,
                                     code_len=4, max_oobs=6, device="cpu"))
    ej = _np_state(jms.empty(max_kf=5, max_feat=7, max_pts=11, max_obj=3, code_len=4,
                             max_oobs=6))
    for k in ej:
        assert e[k].dtype == ej[k].dtype, k
        np.testing.assert_array_equal(e[k], ej[k], err_msg=k)


def test_frame_round_trip_is_exact(runs):
    jframe = runs["stereo"]["jax"][0].last_frame
    fields = _np_frame(jframe)
    back = frame_to_numpy(frame_from_numpy(fields, "cpu"))
    for k in ("ur", "depth", "t_cw", "pt_idx"):
        np.testing.assert_array_equal(back[k], fields[k])
    for k, v in fields["feats"].items():
        np.testing.assert_array_equal(back["feats"][k], v)
    assert back["timestamp"] == fields["timestamp"]


def test_covisibility_and_point_queries_match_jax():
    js = _random_state(3)
    ts = map_state_from_numpy(_np_state(js), "cpu")
    K = js.kf_valid.shape[0]
    for k in range(K):
        np.testing.assert_array_equal(tcov.covisibility_row(ts, k).numpy(),
                                      np.asarray(jcov.covisibility_row(js, k)))
        for mk in (2, 4):
            for a, b in zip(tcov.local_window(ts, k, mk, min_weight=2),
                            jcov.local_window(js, k, mk, min_weight=2)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        i_t, w_t = tcov.best_covisible(ts, k, 3)
        i_j, w_j = jcov.best_covisible(js, k, 3)
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    np.testing.assert_array_equal(tcov.covisibility_matrix(ts, chunk=3).numpy(),
                                  np.asarray(jcov.covisibility_matrix(js, chunk=3)))
    kf_mask = np.arange(K) % 3 == 0
    pairs = [(tms.membership_matrix(ts), jms.membership_matrix(js)),
             (tms._obs_ok(ts), jms._obs_ok(js)),
             (tms.point_mask_of(ts, t(kf_mask)), jms.point_mask_of(js, jnp.asarray(kf_mask))),
             (tms.point_obs_counts(ts), jms.point_obs_counts(js)),
             (tms.point_obs_counts_weighted(ts), jms.point_obs_counts_weighted(js)),
             (tms.kf_sees_mask(ts, ts.pt_valid), jms.kf_sees_mask(js, js.pt_valid))]
    for n in (5, 40, 50):
        pairs.append((tms.free_slots_device(ts.pt_valid, n),
                      jms.free_slots_device(js.pt_valid, n)))
    for a, b in pairs:
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tms.alloc_slots(ts.pt_valid, 7),
                                  jms.alloc_slots(np.asarray(js.pt_valid), 7))


def _close(a, b, atol=1e-5):
    a, b = a.numpy(), np.asarray(b)
    if a.dtype == np.int32 and b.dtype == np.uint32:
        a = a.view(np.uint32)
    np.testing.assert_allclose(a, b, atol=atol, rtol=0)


def test_keyframe_bootstrap_matches_jax(runs):
    jtrk = runs["stereo"]["jax"][0]
    js, jframe = jtrk.state, jtrk.last_frame
    ts = map_state_from_numpy(_np_state(js), "cpu")
    tframe = frame_from_numpy(_np_frame(jframe), "cpu")
    slot = int(jms.alloc_slots(np.asarray(js.kf_valid), 1)[0])
    cam_j, cam_t = make_cfg().cam, tcam.Intrinsics(*make_cfg().cam)
    sj = jlm.insert_keyframe(js, jframe, slot, 9)
    st = tlm.insert_keyframe(ts, tframe, slot, 9)
    sj = jlm.spawn_depth_points(sj, cam_j, slot, jframe, 15.0, first_id=5)
    st = tlm.spawn_depth_points(st, cam_t, slot, tframe, 15.0, first_id=5)
    spawned = int(np.asarray(sj.pt_valid).sum() - np.asarray(js.pt_valid).sum())
    assert spawned > 10
    for k in jms.MapState._fields:
        _close(getattr(st, k), getattr(sj, k))
    sj, st = jlm.update_point_geometry(sj), tlm.update_point_geometry(st)
    for k in ("pt_normal", "pt_min_d", "pt_max_d"):
        _close(getattr(st, k), getattr(sj, k))


def _pnp_sample(seed, planar):
    """Six points 2-4 m ahead (a well-conditioned minimal sample: both
    packages solve it in f32)."""
    rng = np.random.default_rng(seed)
    T = np.asarray(jlie.exp_se3(jnp.asarray([0.2, -0.1, 0.3, 0.05, -0.1, 0.08])))
    pc = np.stack([rng.uniform(-1, 1, 6), rng.uniform(-1, 1, 6), rng.uniform(2, 4, 6)], -1)
    if planar:
        pc[:, 2] = 3.0 + 0.3 * pc[:, 0]
    pw_ = ((pc - T[:3, 3]) @ T[:3, :3]).astype(np.float32)
    xn = (pc[:, :2] / pc[:, 2:]).astype(np.float32)
    return pw_, xn, T


@pytest.mark.parametrize("planar", [False, True])
def test_minimal_pnp_solvers_match_jax(planar):
    pts, xn, T = _pnp_sample(5, planar)
    solver = "_planar_pnp" if planar else "_dlt_pnp"
    tj = np.asarray(getattr(jpnp, solver)(jnp.asarray(pts), jnp.asarray(xn)))
    tt = getattr(tpnp, solver)(t(pts), t(xn)).numpy()
    np.testing.assert_allclose(tt, tj, atol=1e-3, rtol=0)
    np.testing.assert_allclose(tt, T, atol=1e-3, rtol=0)
    # the batched form gives each trial's own solution
    tb = getattr(tpnp, solver)(t(np.stack([pts, pts])), t(np.stack([xn, xn]))).numpy()
    np.testing.assert_allclose(tb[1], tt, atol=1e-5, rtol=0)


def test_solve_pnp_ransac_recovers_a_noiseless_pose():
    rng = np.random.default_rng(7)
    T = np.asarray(jlie.exp_se3(jnp.asarray([0.3, 0.1, -0.2, 0.05, 0.1, -0.04])))
    pc = np.stack([rng.uniform(-4, 4, 200), rng.uniform(-3, 3, 200), rng.uniform(5, 15, 200)], -1)
    pts = ((pc - T[:3, 3]) @ T[:3, :3]).astype(np.float32)
    cam_args = CAM_ARGS
    uv = np.asarray(jcam.project(jcam.Intrinsics(*cam_args), jnp.asarray(pc, jnp.float32)))
    valid = rng.random(200) > 0.3
    inv_s2 = np.ones(200, np.float32)
    import jax
    rj = jpnp.solve_pnp_ransac(jcam.Intrinsics(*cam_args), jnp.asarray(pts), jnp.asarray(uv),
                               jnp.asarray(inv_s2), jnp.asarray(valid), jax.random.PRNGKey(0))
    rt = tpnp.solve_pnp_ransac(tcam.Intrinsics(*cam_args), t(pts), t(uv), t(inv_s2), t(valid),
                               torch.Generator().manual_seed(0))
    assert bool(rj.ok) and bool(rt.ok)
    np.testing.assert_allclose(np.asarray(rj.t_cw), T, atol=1e-3, rtol=0)
    np.testing.assert_allclose(rt.t_cw.numpy(), T, atol=1e-3, rtol=0)
    assert int(rt.n_inliers) == int(valid.sum())


def test_track_stage_core_matches_jax(runs):
    """One tracking stage from the same state and frame (the stereo run's
    tracker after 10 frames, the next frame of the world)."""
    jtrk = runs["stereo"]["jax"][0]
    tex = pw.make_texture(WORLD)
    seq = td.frames(WORLD, tex, "stereo", 11)[10]
    jframe = jtrk.make_frame(seq[0], seq[1], timestamp=1.0)
    lf = jtrk.last_frame
    cam = make_cfg().cam
    th = 30.0 * cam.bf / cam.fx
    t_pred = np.asarray(jtrk.velocity @ lf.t_cw)
    for rot, upd, radius in ((True, False, 7.0), (False, True, 4.0)):
        args = (jframe.feats.xy, jframe.feats.desc, jframe.feats.level, jframe.feats.valid,
                jframe.feats.angle, jframe.ur, jframe.depth, lf.pt_idx, lf.feats.angle)
        oj = jtr._track_stage(cam, jtrk.state, lf.pt_idx, jframe.pt_idx, jnp.asarray(t_pred),
                              *args, radius, th, n_keep=6, check_rotation=rot, stereo=True,
                              update_stats=upd)
        targs = [t(a) for a in args]
        targs[1] = t(np.asarray(args[1]).view(np.int32))
        ot = ttr._track_stage_core(
            tcam.Intrinsics(*cam), map_state_from_numpy(_np_state(jtrk.state), "cpu"),
            t(lf.pt_idx), t(jframe.pt_idx), t(t_pred), *targs, radius, th, 6, rot, True, upd)
        np.testing.assert_array_equal(ot[2].numpy(), np.asarray(oj[2]))
        assert int(ot[2][1]) > 50
        np.testing.assert_allclose(ot[0].numpy(), np.asarray(oj[0]), atol=1e-4, rtol=0)
        np.testing.assert_array_equal(ot[1].numpy(), np.asarray(oj[1]))
        if upd:
            np.testing.assert_array_equal(ot[3].numpy(), np.asarray(oj[3]))
            np.testing.assert_array_equal(ot[4].numpy(), np.asarray(oj[4]))


def _twin_trackers(runs, i):
    """(JAX tracker, port tracker, JAX frame, port frame): a copy of the
    stereo run's JAX tracker after 10 frames (the fixture's stays as it
    is), a port tracker in the same state (map, last frame, reference KF,
    status, motion model) and frame i of the world in both packages."""
    jtrk = copy.copy(runs["stereo"]["jax"][0])
    ttrk = ttr.Tracker(port_config(make_cfg()),
                       map_state_from_numpy(_np_state(jtrk.state), "cpu"), device="cpu")
    ttrk.last_frame = frame_from_numpy(_np_frame(jtrk.last_frame), "cpu")
    ttrk.ref_kf, ttrk.status, ttrk.velocity = jtrk.ref_kf, jtrk.status, t(jtrk.velocity)
    x = pw.gt_x(WORLD, i)
    tex = pw.make_texture(WORLD)
    jframe = jtrk.make_frame(pw.render(WORLD, tex, x), pw.render(WORLD, tex, x + WORLD.baseline),
                             timestamp=i * 0.1)
    return jtrk, ttrk, jframe, frame_from_numpy(_np_frame(jframe), "cpu")


def test_motion_model_stage_matches_jax(runs):
    """`_track_motion_model`, the motion-model stage on its own with its
    doubled-window retry, from the same state and frame: the same verdict,
    stats and matches, pose 1e-4."""
    jtrk, ttrk, jframe, tframe = _twin_trackers(runs, 10)
    fj, okj = jtrk._track_motion_model(jframe)
    ft, okt = ttrk._track_motion_model(tframe)
    assert okj and okt
    np.testing.assert_array_equal(ttrk._stage_stats, np.asarray(jtrk._stage_stats))
    np.testing.assert_allclose(ft.t_cw.numpy(), np.asarray(fj.t_cw), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(ft.pt_idx.numpy(), np.asarray(fj.pt_idx))
    assert ttrk.ref_kf == jtrk.ref_kf


def test_fallback_chain_matches_jax(runs):
    """The branches taken when the motion model fails, from the same state
    and frame: reference-keyframe tracking (deterministic: pose 1e-4, the
    same matches), PnP relocalization over the recent keyframes (their
    trial samples differ, the refined poses agree to 1e-3, both within the
    sequence band of the true pose) and the local-map stage after it (pose
    1e-3, the same inlier count and matches)."""
    jtrk, ttrk, jframe, tframe = _twin_trackers(runs, 11)
    fj, okj = jtrk._track_reference_kf(jframe)
    ft, okt = ttrk._track_reference_kf(tframe)
    assert okj and okt
    np.testing.assert_allclose(ft.t_cw.numpy(), np.asarray(fj.t_cw), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(ft.pt_idx.numpy(), np.asarray(fj.pt_idx))

    x_true = pw.gt_x(WORLD, 11)
    fj, okj = jtrk._relocalize(jframe)
    ft, okt = ttrk._relocalize(tframe)
    assert okj and okt
    np.testing.assert_allclose(ft.t_cw.numpy(), np.asarray(fj.t_cw), atol=1e-3, rtol=0)
    assert abs(-float(ft.t_cw[0, 3]) - x_true) < 0.08
    fj, nj = jtrk._track_local_map(fj)
    ft, nt = ttrk._track_local_map(ft)
    assert nt == nj >= 25
    np.testing.assert_allclose(ft.t_cw.numpy(), np.asarray(fj.t_cw), atol=1e-3, rtol=0)
    np.testing.assert_array_equal(ft.pt_idx.numpy(), np.asarray(fj.pt_idx))


# ----------------------------------------------------------------- tracker
def _revisit_state():
    """tests/test_tracker_window.py's map: loop-side KFs 0-1 observe points
    0..9, recent KFs 2-7 observe points 10..19 far away."""
    st = tms.empty(max_kf=8, max_feat=16, max_pts=32, max_obj=2, device="cpu")
    kf_feat_pt = np.full((8, 16), -1, np.int32)
    kf_feat_pt[0, :10] = np.arange(10)
    kf_feat_pt[1, :10] = np.arange(10)
    for k in range(2, 8):
        kf_feat_pt[k, :10] = np.arange(10, 20)
    pos = np.zeros((32, 3), np.float32)
    pos[:10, 2] = 5.0
    pos[10:20, 0] = 100.0
    pos[10:20, 2] = 5.0
    return st._replace(
        kf_valid=torch.ones(8, dtype=torch.bool),
        kf_frame_id=torch.arange(8, dtype=torch.int32),
        kf_feat_valid=torch.ones(8, 16, dtype=torch.bool),
        kf_feat_pt=t(kf_feat_pt),
        pt_valid=torch.tensor([True] * 20 + [False] * 12),
        pt_pos=t(pos))


def _window_cfg():
    return tconfig.SystemConfig(map=tconfig.MapConfig(max_kf=8, max_feat=16, max_pts=32,
                                                       max_obj=2, local_window=6))


def test_covisibility_window_reacquires_loop_side_kfs():
    tr = ttr.Tracker(_window_cfg(), _revisit_state(), device="cpu")
    pt_idx = np.full(16, -1, np.int32)
    pt_idx[:5] = np.arange(5)
    window = tr._local_kf_window(t(pt_idx))
    assert 0 in window and 1 in window     # loop-side KFs retrieved
    assert tr.ref_kf in (0, 1)             # the strongest voter is loop-side
    recent = tr._recent_window()
    assert 0 not in recent and 1 not in recent
    idx, mask = ttr._gather_local_points(tr.state, window)
    got = set(idx.numpy()[mask.numpy()].tolist())
    assert set(range(10)) <= got


def test_window_votes_with_the_tracked_points():
    """Points 15..19 are seen only by the recent KFs 2-7: they, not the
    loop-side KFs, make the window (the JAX package's `_local_kf_window`
    hands its device function a mask where slots are due, and votes with
    points 0 and 1 instead; ROADMAP §3)."""
    tr = ttr.Tracker(_window_cfg(), _revisit_state(), device="cpu")
    pt_idx = np.full(16, -1, np.int32)
    pt_idx[:5] = np.arange(15, 20)
    window = tr._local_kf_window(t(pt_idx))
    assert set(window.tolist()) == set(range(2, 8))
    assert tr.ref_kf == 2


def test_window_falls_back_to_recent_without_matches():
    tr = ttr.Tracker(_window_cfg(), _revisit_state(), device="cpu")
    window = tr._local_kf_window(torch.full((16,), -1, dtype=torch.int32))
    np.testing.assert_array_equal(window, tr._recent_window())


# ------------------------------------------------------------------- slice
def _tracks_like_jax(r):
    errs = {}
    for pkg in ("jax", "torch"):
        tr, n_kf, _ = r[pkg]
        ok, err, T = td.trajectory_errors(WORLD, tr.trajectory)
        assert len(ok) == 10 and ok.mean() >= 0.8, pkg
        assert err[ok].max() < 0.08, pkg
        assert n_kf >= 2, pkg
        errs[pkg] = T
    assert np.abs(errs["torch"][:, :3, 3] - errs["jax"][:, :3, 3]).max() < 1e-2
    assert r["jax"][1] == r["torch"][1]   # the same keyframe count


@pytest.mark.parametrize("sensor", ["stereo", "rgbd"])
def test_sequence_tracks_like_jax(runs, sensor):
    _tracks_like_jax(runs[sensor])


@pytest.mark.parametrize("sensor", ["stereo", "rgbd"])
def test_full_keyframe_stage_tracks_like_jax(full_runs, sensor):
    """The same sequences with the whole keyframe stage (point stage, local
    BA, keyframe culling): the bands of the bootstrap sequences, the same
    keyframe count and culled slots, trajectories within 1e-2 m."""
    r = full_runs[sensor]
    _tracks_like_jax(r)
    assert r["jax"][2] == r["torch"][2]   # the same culled slots, in order


def test_recent_keyframe_lists_keep_slot_order():
    """After culling, new keyframes take the freed low slots, and both
    packages' `_recent_window`/`_recent_kfs` still go by slot order (kept
    for parity; ROADMAP §3), so the five "recent" KFs are not the five
    newest by frame id."""
    K, F, P = 8, 32, 64
    kf_feat_pt = np.full((K, F), -1, np.int32)
    for k in range(6):
        kf_feat_pt[k, :30] = np.arange(30)
    js = jms.empty(max_kf=K, max_feat=F, max_pts=P, max_obj=2)._replace(
        kf_valid=jnp.asarray([True] * 6 + [False] * 2),
        kf_frame_id=jnp.asarray(list(range(6)) + [-1, -1], jnp.int32),
        kf_feat_valid=jnp.ones((K, F), bool),
        kf_feat_pt=jnp.asarray(kf_feat_pt),
        pt_valid=jnp.asarray([True] * 30 + [False] * 34))
    ts = map_state_from_numpy(_np_state(js), "cpu")
    js, culled_j = jlm.cull_keyframes(js, 5, max_cull=2)
    ts, culled_t = tlm.cull_keyframes(ts, 5, max_cull=2)
    assert culled_j == culled_t == [0, 1]
    kf_valid = np.asarray(js.kf_valid).copy()
    jframe = jtr.Frame(JFeatures(
        xy=jnp.zeros((F, 2)), level=jnp.zeros(F, jnp.int32), angle=jnp.zeros(F),
        score=jnp.zeros(F), desc=jnp.zeros((F, 8), jnp.uint32), valid=jnp.zeros(F, bool)),
        ur=jnp.full(F, -1.0), depth=jnp.full(F, -1.0), t_cw=jnp.eye(4),
        pt_idx=jnp.full(F, -1, jnp.int32), timestamp=0.0)
    tframe = frame_from_numpy(_np_frame(jframe), "cpu")
    for fid in (6, 7):                      # two new keyframes, first-free slots
        slot = int(jms.alloc_slots(kf_valid, 1)[0])
        kf_valid[slot] = True
        js = jlm.insert_keyframe(js, jframe, slot, fid)
        ts = tlm.insert_keyframe(ts, tframe, slot, fid)
    cfg_j = jconfig.SystemConfig(map=jconfig.MapConfig(max_kf=K, max_feat=F, max_pts=P,
                                                       max_obj=2, local_window=4))
    trj = jtr.Tracker(cfg_j, js)
    trt = ttr.Tracker(port_config(cfg_j), ts, device="cpu")
    np.testing.assert_array_equal(trt._recent_window(), np.asarray(trj._recent_window()))
    assert trt._recent_kfs(5) == list(trj._recent_kfs(5)) == [5, 4, 3, 2, 1]
    fids = ts.kf_frame_id.numpy()
    newest = np.argsort(-np.where(ts.kf_valid.numpy(), fids, -1), kind="stable")[:5]
    assert set(newest.tolist()) == {1, 0, 5, 4, 3}
    assert set(trt._recent_kfs(5)) != set(newest.tolist())
    assert set(trt._recent_window().tolist()) == {2, 3, 4, 5}


def test_config_from_reference_yaml_matches_jax():
    yaml = ("%YAML:1.0\nCamera.fx: 718.856\nCamera.fy: 718.856\nCamera.cx: 607.1928\n"
            "Camera.cy: 185.2157\nCamera.k1: 0.01\nCamera.bf: 386.1448\nCamera.fps: 10.0\n"
            "ThDepth: 35\nORBextractor.nFeatures: 2000\nORBextractor.scaleFactor: 1.2\n"
            "ORBextractor.nLevels: 8\nDepthMapFactor: 5000.0\nTworld_camera.tx: 1.5\n"
            "Tworld_camera.qw: 0.9238795\nTworld_camera.qz: 0.3826834\n")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "cam.yaml")
        with open(path, "w") as f:
            f.write(yaml)
        cj = jconfig.from_reference_yaml_json(path, sensor="rgbd")
        ct = tconfig.from_reference_yaml_json(path, sensor="rgbd")
    assert tuple(ct.cam) == tuple(cj.cam) and tuple(ct.orb) == tuple(cj.orb)
    assert dataclasses.asdict(ct.tracking) == dataclasses.asdict(cj.tracking)
    assert ct.depth_scale == cj.depth_scale and ct.sensor == "rgbd"
    np.testing.assert_allclose(np.asarray(ct.t_world_camera0), np.asarray(cj.t_world_camera0),
                               atol=1e-6)
    assert tconfig.MapConfig.kitti_large(max_kf=9) == \
        tconfig.MapConfig(**dataclasses.asdict(jconfig.MapConfig.kitti_large(max_kf=9)))


# ------------------------------------------------------------ entry points
def test_entry_points_default_to_the_card():
    cfg = port_config(make_cfg())
    if torch.cuda.is_available():
        st = tms.empty(max_kf=4, max_feat=8, max_pts=16)
        assert st.kf_pose.is_cuda and ttr.Tracker(cfg, st).device.type == "cuda"
        return
    with pytest.raises(RuntimeError):
        tms.empty(max_kf=4, max_feat=8, max_pts=16)
    with pytest.raises(RuntimeError):
        ttr.Tracker(cfg, tms.empty(max_kf=4, max_feat=8, max_pts=16, device="cpu"))


@pytest.mark.parametrize("what", ["mono", "pipelined"])
def test_tracker_raises_for_parts_not_ported(what):
    j = make_cfg("mono" if what == "mono" else "stereo")
    cfg = port_config(j)
    if what == "pipelined":
        cfg = dataclasses.replace(cfg, tracking=dataclasses.replace(cfg.tracking, pipelined=True))
    with pytest.raises(NotImplementedError, match="slice C"):
        ttr.Tracker(cfg, tms.empty(max_kf=4, max_feat=8, max_pts=16, device="cpu"), device="cpu")
