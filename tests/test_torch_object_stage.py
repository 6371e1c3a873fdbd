"""The port's object stage (`system/object_stage.py`), mono object pipeline
(`system/mono_objects.py`) and keyframe `MappingStage` against the JAX
package's, on the CPU, on the same seeded numpy inputs, with the
committed fixture decoder (`tests/fixtures/ellipsoid_decoder_64.npz`,
cars_64 layout) loaded by both packages' `load_npz`.  The JAX package runs
its plain decoder (`use_pallas=False`, as its system does), the port the
plain versions of its kernels.

Tolerances:
  * `_membership_update` exact; the batched `sdf_bbox` against the JAX
    package's vmapped one: the same grid cell on every face (exact), the
    coordinates within 1e-6 (torch's and XLA's linspace round up to 8
    of the 24 grid coordinates one ulp apart);
  * `refine_associated` and `insert_new_objects`: integers and masks
    exact, poses and the other floats within 1e-4;
  * `recon_unmatched` at `scale_damping=20`: one GN iteration within 1e-4,
    five within 1e-3, the full 10-iteration fit within 1e-2, flags equal.
    The f32 GN loop is chaotic (ROADMAP's rule): on these inputs the two
    packages' fits part by 1.4e-5 after 2 iterations, 8.6e-5 (pose) and
    2.0e-4 (code) after 5, 2.9e-4 and 1.5e-3 after 7, 7.2e-3 and 4.9e-3
    after 10;
  * the mono pipeline over tests/test_mono_objects.py's hand-built map
    (an ellipsoid of the fixture family in place of its analytic sphere):
    ownership, associations and recon flags equal keyframe by keyframe,
    the object pose within 1e-3 (at `scale_damping=20`: at the default 1
    the first fit's 6 f32 iterations part by a loss of 0.516 against
    0.493 between the packages, and the flip test then picks the other
    turn);
  * `MappingStage.process` against the JAX package's
    `MappingStage(..., vocab=None).process`, keyframe by keyframe from the
    same state (the JAX run's): 10 stereo frames of the 224x160 plane
    world, 2 static objects and a mover, `ReconConfig(num_iterations=3,
    scale_damping=20, num_depth_samples=10)`, 64 points and 64 rays a
    detection: object slots, `obj_valid`, `obj_dynamic`, `obj_n_obs`, the
    `oobs` ring and cursors, `pt_object` and the culled slots exact; poses
    and codes within 1e-3.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracking_driver as td
from dsp_slam_rgbd_tpu.mapping import local_mapping as jlm
from dsp_slam_rgbd_tpu.mapping import map_state as jms
from dsp_slam_rgbd_tpu.models import deepsdf as jdeepsdf
from dsp_slam_rgbd_tpu.models import mesh as jmesh
from dsp_slam_rgbd_tpu.recon.optimizer import ReconConfig as JRecon
from dsp_slam_rgbd_tpu.system import detections as jdet
from dsp_slam_rgbd_tpu.system import mapping_stage as jstage
from dsp_slam_rgbd_tpu.system import mono_objects as jmono
from dsp_slam_rgbd_tpu.system import object_stage as jos
from dsp_slam_rgbd_tpu.tracking import tracker as jtr
from dsp_slam_rgbd_tpu_torch.mapping import map_state as tms
from dsp_slam_rgbd_tpu_torch.models import deepsdf as tdeepsdf
from dsp_slam_rgbd_tpu_torch.models import mesh as tmesh
from dsp_slam_rgbd_tpu_torch.ops import camera as tcam
from dsp_slam_rgbd_tpu_torch.parallel.mesh import make_mesh
from dsp_slam_rgbd_tpu_torch.recon.optimizer import ReconConfig as TRecon
from dsp_slam_rgbd_tpu_torch.system import detections as tdet
from dsp_slam_rgbd_tpu_torch.system import mapping_stage as tstage
from dsp_slam_rgbd_tpu_torch.system import mono_objects as tmono
from dsp_slam_rgbd_tpu_torch.system import object_stage as tos
from dsp_slam_rgbd_tpu_torch.tools import object_world as ow
from dsp_slam_rgbd_tpu_torch.tools import plane_world as pw
from dsp_slam_rgbd_tpu_torch.weights import (frame_from_numpy, map_state_from_numpy,
                                             map_state_to_numpy)
from test_system_e2e import make_cfg
from test_torch_tracking import port_config

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "ellipsoid_decoder_64.npz")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def decoders():
    params, spec = jdeepsdf.load_npz(FIXTURE)
    return params, spec, tdeepsdf.load_npz(FIXTURE, device="cpu")


def configs(**kw):
    return JRecon(**kw), TRecon(**kw)


def t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def _np_state(state) -> dict:
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def _jax_state(fields) -> jms.MapState:
    return jms.MapState(**{k: jnp.asarray(fields[k]) for k in jms.MapState._fields})


def _assert_state(ts, js, atol=1e-4, fields=None):
    """Port MapState vs JAX MapState: integer and bool fields equal, float
    fields within atol."""
    got = map_state_to_numpy(ts)
    for k in fields or jms.MapState._fields:
        want = np.asarray(getattr(js, k))
        if want.dtype.kind in "biu":
            np.testing.assert_array_equal(got[k], want, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want, atol=atol, rtol=0, err_msg=k)


def _close(got, want, atol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)


# ---------------------------------------------------------------- the map
TRUTHS = ow.small_objects(0)


def _object_map(seed=0):
    """A small map (K=4, P=256, O=4, Q=16) with two keyframes and objects 0
    and 1 (the first two of `small_objects`, their decoded-shape boxes
    overlapping) reconstructed: 110 points around each, every third one
    owned by its object, and point 0 owned by object 0 but far outside it
    (it is released)."""
    rng = np.random.default_rng(seed)
    f = _np_state(jms.empty(max_kf=4, max_feat=16, max_pts=256, max_obj=4, code_len=64,
                            max_oobs=16))
    f = {k: np.array(v) for k, v in f.items()}
    for k, x in ((0, 0.0), (1, 0.3)):
        f["kf_pose"][k] = ow.t_cw(pw.SMALL, 0).astype(np.float32)
        f["kf_pose"][k][0, 3] = -x
        f["kf_valid"][k] = True
        f["kf_frame_id"][k] = 3 * k
    centers = [np.array([1.0, 0.0, 6.5]), np.array([1.6, 0.1, 6.9])]
    for o, c in enumerate(centers):
        T = TRUTHS[o].t_wo(0)
        T[:3, :3] /= ow.SCALE
        T[:3, 3] = c
        f["obj_pose"][o] = T
        f["obj_scale"][o] = ow.SCALE
        f["obj_code"][o] = TRUTHS[o].code
        f["obj_valid"][o] = f["obj_recon"][o] = True
        f["obj_n_obs"][o] = 2
        f["obj_last_kf"][o] = 0
        f["obj_bbox_min"][o] = [-0.35, -0.3, -0.4]
        f["obj_bbox_max"][o] = [0.35, 0.3, 0.4]
        pts = c + rng.standard_normal((110, 3)) * 0.45
        f["pt_pos"][o * 110:(o + 1) * 110] = pts
        f["pt_object"][o * 110:(o + 1) * 110:3] = o
    f["pt_pos"][220:240] = rng.uniform(-3, 3, (20, 3)) + [0, 0, 8]
    f["pt_valid"][:240] = True
    f["pt_pos"][0] = [5.0, 0.0, 2.0]
    f["pt_object"][0] = 0
    return f


def test_membership_update_matches_jax():
    f = _object_map()
    js = _jax_state(f)
    ts = map_state_from_numpy(f, "cpu")
    obj_idx = np.array([0, 1, -1, -1])
    valid = np.array([True, True, False, False])
    j = jos._membership_update(js, jnp.asarray(obj_idx), jnp.asarray(valid))
    got = tos._membership_update(ts, t(obj_idx), t(valid))
    _close(got.pt_object, j.pt_object, 0)
    po = got.pt_object.numpy()
    assert po[0] == -1                   # released: outside its owner's box
    s = np.array([1.2, 1.5, 1.2])

    def inside(o):
        T = np.linalg.inv(f["obj_pose"][o])
        loc = (f["pt_pos"] @ T[:3, :3].T + T[:3, 3]) / f["obj_scale"][o]
        return (np.all((loc >= s * f["obj_bbox_min"][o]) & (loc <= s * f["obj_bbox_max"][o]), 1)
                & f["pt_valid"])

    both = inside(0) & inside(1) & (f["pt_object"] < 0)
    assert both.any() and (po[both] == 0).all()   # two claimants: the first row wins


def _detections(f, kf, objs, n_pts=64, n_rays=64, seed=1):
    """The port's and the JAX package's detections of objects `objs` of the
    map `f` seen from keyframe kf (same numpy)."""
    rng = np.random.default_rng(seed)
    truths = []
    for o in objs:
        T = f["obj_pose"][o].astype(np.float64)
        truths.append(TRUTHS[o]._replace(center=T[:3, 3]))
    raw = ow.detections(f["kf_pose"][kf].astype(np.float64), truths, rng, n_pts, n_rays)
    return ([tdet.make_detection(d["t_co_sim3"], pts=d["pts"], rays=d["rays"], depth=d["depth"],
                                 n_fg=d["n_fg"]) for d in raw],
            [jdet.make_detection(d["t_co_sim3"], pts=d["pts"], rays=d["rays"], depth=d["depth"],
                                 n_fg=d["n_fg"]) for d in raw])


def test_refine_associated_matches_jax(decoders):
    params, spec, dec = decoders
    f = _object_map()
    td_, _ = _detections(f, 1, [0, 1])
    A = 2
    obj_idx = np.array([0, 1], np.int64)
    valid = np.ones(A, bool)
    det_t = np.stack([d.t_co for d in td_])
    det_pts = np.stack([d.pts for d in td_])
    det_mask = np.stack([d.pts_mask for d in td_])
    qs = np.array([0, 4], np.int64)
    jc, tc = configs()
    j = jos.refine_associated(params, spec, jc, _jax_state(f), jnp.asarray(obj_idx),
                              jnp.asarray(valid), jnp.asarray(det_t), jnp.asarray(det_pts),
                              jnp.asarray(det_mask), 1, jnp.asarray(qs))
    got = tos.refine_associated(dec, tc, map_state_from_numpy(f, "cpu"), t(obj_idx), t(valid),
                                t(det_t), t(det_pts), t(det_mask), 1, t(qs))
    _assert_state(got, j)
    assert got.oobs_valid.numpy()[[0, 4]].all() and got.obj_n_obs.tolist()[:2] == [3, 3]


def test_insert_new_objects_matches_jax():
    f = _object_map()
    rng = np.random.default_rng(2)
    U = 4
    t_sim3 = np.tile(np.eye(4, dtype=np.float32), (U, 1, 1))
    for u in range(U):
        T = TRUTHS[u % 3].t_wo(0)
        T[:3, 3] = [0.5 * u - 1, 0.1, 6.0 + u]
        T[:3, :3] *= 1.0 + 0.1 * u
        t_sim3[u] = T
    codes = rng.standard_normal((U, 64)).astype(np.float32)
    bb_min = -rng.uniform(0.2, 0.5, (U, 3)).astype(np.float32)
    bb_max = rng.uniform(0.2, 0.5, (U, 3)).astype(np.float32)
    slots = np.array([2, -1, 3, -1])
    ok = np.array([True, False, True, False])
    qs = np.array([8, -1, 12, -1])
    args = (slots, ok, t_sim3, codes, bb_min, bb_max)
    j = jos.insert_new_objects(_jax_state(f), *(jnp.asarray(a) for a in args), 1, 5,
                               jnp.asarray(qs))
    got = tos.insert_new_objects(map_state_from_numpy(f, "cpu"), *(t(a) for a in args), 1, 5,
                                 t(qs))
    _assert_state(got, j)
    assert got.obj_valid.tolist() == [True] * 4 and got.oobs_valid.numpy()[[8, 12]].all()


@pytest.mark.parametrize("iters,tol", [(1, 1e-4), (5, 1e-3), (10, 1e-2)])
def test_recon_unmatched_matches_jax(decoders, iters, tol):
    """Two unmatched detections through one batched fit at
    scale_damping=20 (see the module docstring for the tolerances)."""
    params, spec, dec = decoders
    f = _object_map()
    td_, jd_ = _detections(f, 0, [0, 1], seed=3)
    jc, tc = configs(num_iterations=iters, scale_damping=20.0, num_depth_samples=10,
                     max_grad_points=1024, max_valid_samples=1024)
    js, ts = _jax_state(f), map_state_from_numpy(f, "cpu")
    jres, jmin, jmax, jflags, jU, _ = jos.recon_unmatched(params, spec, jc, js, jd_, [0, 1])
    tres, tmin, tmax, tflags, tU, _ = tos.recon_unmatched(dec, tc, ts, td_, [0, 1])
    assert tU == jU == 2
    _close(tres.t_cam_obj, jres.t_cam_obj, tol)
    _close(tres.code, jres.code, tol)
    _close(tres.is_good, jres.is_good, 0)
    _close(tflags, jflags, 0)
    # the decoded-shape boxes come from the codes: the same cells after one
    # iteration, within one grid cell after more
    cells = 0 if iters == 1 else 1
    np.testing.assert_array_less(np.abs(_cell(tmin) - _cell(jmin)), cells + 0.5)
    np.testing.assert_array_less(np.abs(_cell(tmax) - _cell(jmax)), cells + 0.5)
    # on a one-rank mesh (no process group) the sharded path is the same fit
    mres, _, _, mflags, mU, _ = tos.recon_unmatched(dec, tc, ts, td_, [0, 1],
                                                    mesh=make_mesh(), min_cap=1)
    assert mU == tU
    _close(mres.t_cam_obj, tres.t_cam_obj, 0)
    _close(mres.code, tres.code, 0)
    _close(mflags, tflags, 0)


def _cell(v):
    """Grid cell index of a box coordinate (sdf_bbox's 24^3 grid over ±1.1)."""
    v = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return np.round((v + 1.1) / (2.2 / 23))


def test_batched_sdf_bbox_matches_jax(decoders):
    """One value query over U x 24^3 rows against the JAX package's vmap of
    the one-code form: the same boxes, and the empty shape's ±1."""
    params, spec, dec = decoders
    codes = np.stack([tr.code for tr in TRUTHS] + [np.full(64, 30.0, np.float32)])
    bmin_j, bmax_j = jax.vmap(lambda c: jmesh.sdf_bbox(params, spec, c))(jnp.asarray(codes))
    bmin_t, bmax_t = tmesh.sdf_bbox(dec, t(codes))
    for got, want in ((bmin_t, bmin_j), (bmax_t, bmax_j)):
        np.testing.assert_array_equal(_cell(got), _cell(want))
        _close(got, want, 1e-6)
    np.testing.assert_array_equal(bmax_t[-1].numpy(), [1.0, 1.0, 1.0])   # nothing inside
    one = tmesh.sdf_bbox(dec, t(codes[0]))
    np.testing.assert_array_equal(one[0].numpy(), bmin_t[0].numpy())


# ------------------------------------------------------------------- mono
MONO_CFG = dict(num_depth_samples=24, num_iterations=6, scale_damping=20.0, max_grad_points=512,
                max_valid_samples=2048)


def test_mono_pipeline_matches_jax(decoders):
    """tests/test_mono_objects.py's 21-keyframe flow (association by
    voting, poseless creation, PCA seeding, reconstruction at keyframes 15
    and 20 with the flip test) in both packages, each from the other's
    state before every keyframe; then the object is recovered."""
    from dsp_slam_rgbd_tpu.ops import camera as jcam

    params, spec, dec = decoders
    jc, tc = configs(**MONO_CFG)
    cam_args = dict(fx=200.0, fy=200.0, cx=112.0, cy=80.0, bf=100.0)
    jcm, tcm = jcam.Intrinsics(**cam_args), tcam.Intrinsics(**cam_args)
    pts, truth = ow.mono_world(3)
    P = len(pts)
    js = jms.empty(max_kf=23, max_feat=P, max_pts=P + 16, max_obj=4, code_len=64, max_oobs=64)
    f = ow.mono_fields(_np_state(js), pts)
    rng = np.random.default_rng(3)
    n_obs = 0
    for i in range(21):
        f = ow.mono_keyframe(f, i, 0.08 * i)
        kp, bg = ow.mono_detection_inputs(rng)
        js, ts = _jax_state(f), map_state_from_numpy(f, "cpu")
        jd, tdd = [jdet.MonoDetection(kp, bg, True)], [tdet.MonoDetection(kp, bg, True)]
        js, ja = jmono.associate_by_projection(js, i, jd)
        ts, ta = tmono.associate_by_projection(ts, i, tdd)
        js, ja = jmono.create_new_objects(js, i, jd, ja, kfseq=i)
        ts, ta = tmono.create_new_objects(ts, i, tdd, ta, kfseq=i)
        np.testing.assert_array_equal(ta, ja)
        js, jobs = jmono.process_detected_objects(js, jcm, jc, params, spec, i, i, jd, ja)
        ts, tobs = tmono.process_detected_objects(ts, tcm, tc, dec, i, i, tdd, ta)
        assert [o for o, _ in tobs] == [o for o, _ in jobs]
        for (_, a), (_, b) in zip(tobs, jobs):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-3)
        n_obs += len(tobs)
        _assert_state(ts, js, atol=1e-3, fields=(
            "pt_object", "pt_valid", "pt_outlier", "obj_valid", "obj_recon", "obj_n_obs",
            "obj_ref_kfseq", "obj_pose", "obj_scale", "obj_code"))
        f = _np_state(js)
    assert n_obs == 2 and bool(ts.obj_recon[0])
    po = ts.pt_object.numpy()
    assert (po[:ow.N_SURFACE] == 0).mean() > 0.9 and (po[ow.N_SURFACE:P] == 0).sum() == 0
    # recovered: the center within 0.3 of the largest true semi-axis (the
    # scale stays near the PCA seed 0.4·l, as in the JAX package)
    reach = 0.3 * ow.MONO_SCALE * ow.ellipsoid.code_to_axes(truth.code).max()
    assert np.linalg.norm(ts.obj_pose[0, :3, 3].numpy() - truth.center) < reach


# -------------------------------------------------------------- mapping stage
RECON_SMALL = dict(num_iterations=3, scale_damping=20.0, num_depth_samples=10)


def test_mapping_stage_process_matches_jax(decoders):
    """The JAX package's `MappingStage(vocab=None)` drives 10 stereo frames
    with detections of 2 static objects and a mover; at every keyframe the
    port's `MappingStage` runs `process` on the same job from the same
    state (the JAX run's, converted) and must give the JAX result."""
    params, spec, dec = decoders
    base = make_cfg("stereo")
    jc = dataclasses.replace(base, recon=JRecon(**RECON_SMALL))
    tc = dataclasses.replace(port_config(jc), recon=TRecon(**RECON_SMALL))
    port = tstage.MappingStage(tc, None, np.zeros(jc.map.max_kf, bool), decoder=dec)
    seen = []

    def on_keyframe(i, job, pre, res, truth_idx):
        port.state = map_state_from_numpy(_np_state(pre), "cpu")
        port.kf_valid_host[:] = res.kf_valid_host
        for c, _, _ in res.culled:
            port.kf_valid_host[c] = True
        frame = frame_from_numpy(
            {"feats": {k: np.asarray(v) for k, v in job.frame.feats._asdict().items()},
             **{k: np.asarray(getattr(job.frame, k)) for k in ("ur", "depth", "t_cw", "pt_idx")},
             "timestamp": job.frame.timestamp}, "cpu")
        dets = [tdet.ObjectDetection(*d) for d in job.detections]
        r = port.process(tstage.KFJob(frame=frame, detections=dets, kf_slot=job.kf_slot,
                                      kid=job.kid, frame_id=job.frame_id,
                                      timestamp=job.timestamp))
        _assert_state(r.state, res.state, atol=1e-3, fields=(
            "obj_valid", "obj_dynamic", "obj_n_obs", "obj_last_kf", "obj_ref_kfseq",
            "obj_recon", "oobs_kf", "oobs_obj", "oobs_valid", "pt_object", "obj_pose",
            "obj_scale", "obj_code", "oobs_t_co", "kf_valid"))
        assert [c for c, _, _ in r.culled] == [c for c, _, _ in res.culled]
        np.testing.assert_array_equal(r.kf_valid_host, res.kf_valid_host)
        seen.append((len(truth_idx), np.asarray(res.state.obj_valid).sum()))

    objects = td.object_inputs(jstage, jdet, pw.SMALL, TRUTHS, 64, 64, 0,
                               on_keyframe=on_keyframe, decoder_params=params,
                               decoder_spec=spec)
    jstage_obj = {}
    orig = objects["stage"]
    objects["stage"] = lambda *a: jstage_obj.setdefault("s", orig(*a))
    td.drive(jms, jlm, jtr, jc, td.frames(pw.SMALL, pw.make_texture(pw.SMALL), "stereo", 10),
             code_len=64, stage="objects", objects=objects)
    assert len(seen) >= 3 and seen[0] == (3, 3)    # 3 objects from the first keyframe
    assert port._oobs_cursor == jstage_obj["s"]._oobs_cursor
    assert port.oobs_overwrites == jstage_obj["s"].oobs_overwrites


@pytest.mark.parametrize("what", ["recon_mesh"])
def test_mapping_stage_raises_for_parts_not_ported(what):
    """Every part is ported: the stage takes a reconstruction mesh (slice F)
    and shards the new-object fit over it."""
    cfg = port_config(make_cfg("stereo"))
    st = tms.empty(max_kf=4, max_feat=8, max_pts=16, device="cpu")
    mesh = make_mesh()
    stage = tstage.MappingStage(cfg, st, np.zeros(4, bool), **{what: mesh})
    assert stage._recon_mesh is mesh and mesh.shape == {"obj": 1, "ray": 1}
