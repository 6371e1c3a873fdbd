"""The port's keyframe `MappingStage` with loop closing, its monocular
initialization and its BoW relocalization against the JAX package's, on
the CPU, through tests/tracking_driver.py's "mono" and "reloc" stages and
tests/test_loop_integration.py's revisit map:

  * test_loop_integration.py::test_system_loop_stage_closes_loop: both
    packages' `MappingStage(vocab=...)._loop_stage` on the same revisit map
    and vocabulary close the loop at the same call, fuse the same number
    of points and stage the same global-BA budget; the port meets the JAX
    test's bars (KF7's error against KF0 below 0.6x its value before);
  * test_mono_e2e.py: the mono sequence (10 frames, 0.3 m a frame) through
    both packages' trackers and keyframe stages: each initializes and meets
    the JAX test's bars (>= 6 frames OK, >= 2 keyframes, Sim(3)-aligned ATE
    under 8% of the path);
  * test_reloc_e2e.py: map 6 stereo frames, 2 blank frames, return to frame
    2's viewpoint: each package's tracker goes LOST, is recovered with the
    BoW candidates of its database, within the JAX test's 0.08 m.
The RANSAC streams differ between the packages (ROADMAP's rule), so end
to end runs are held at the JAX tests' own bars.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracking_driver as td
from dsp_slam_rgbd_tpu.config import MapConfig as JMapConfig
from dsp_slam_rgbd_tpu.loop import vocabulary as jvoc
from dsp_slam_rgbd_tpu.mapping import local_mapping as jlm
from dsp_slam_rgbd_tpu.mapping import map_state as jms
from dsp_slam_rgbd_tpu.ops import lie as jlie
from dsp_slam_rgbd_tpu.solvers import sim3 as jsim3
from dsp_slam_rgbd_tpu.system import mapping_stage as jstage
from dsp_slam_rgbd_tpu.tracking import tracker as jtr
from dsp_slam_rgbd_tpu_torch.mapping import local_mapping as tlm
from dsp_slam_rgbd_tpu_torch.mapping import map_state as tms
from dsp_slam_rgbd_tpu_torch.ops import lie as tlie
from dsp_slam_rgbd_tpu_torch.solvers import sim3 as tsim3
from dsp_slam_rgbd_tpu_torch.system import mapping_stage as tstage
from dsp_slam_rgbd_tpu_torch.tools import plane_world as pw
from dsp_slam_rgbd_tpu_torch.tracking import tracker as ttr
from dsp_slam_rgbd_tpu_torch.weights import map_state_from_numpy
import test_loop_integration as jli
from test_system_e2e import make_cfg
from test_torch_loop import port_vocab
from test_torch_tracking import port_config


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_system_loop_stage_closes_loop():
    rng = np.random.default_rng(0)
    st, _ = jli.build_revisit_state(rng)
    jcfg = dataclasses.replace(make_cfg(), cam=jli.CAM,
                               map=JMapConfig(max_kf=8, max_feat=96, max_pts=512, max_obj=4,
                                              max_oobs=64, local_window=6))
    jv = jvoc.train(rng.integers(0, 2 ** 32, (3000, 8), dtype=np.uint32), branching=6, depth=3)
    tst = map_state_from_numpy({k: np.asarray(v) for k, v in st._asdict().items()}, "cpu")
    jm = jstage.MappingStage(jcfg, st, np.ones(8, bool), vocab=jv)
    tm = tstage.MappingStage(port_config(jcfg), tst, np.ones(8, bool), vocab=port_vocab(jv))
    for k in range(8):
        jm._update_bow(k)
        tm._update_bow(k)
    np.testing.assert_allclose(tm.db.bow.numpy(), np.asarray(jm.db.bow), atol=1e-7)
    # consistency needs 3 consecutive detections before closing on the 4th
    for q, frame_id in ((5, 30), (6, 34), (7, 38), (7, 38)):
        rj, rt = jm._loop_stage(q, kid=7, frame_id=frame_id), tm._loop_stage(q, kid=7,
                                                                             frame_id=frame_id)
        assert (rj is None) == (rt is None)
        assert jm.consistency.groups == tm.consistency.groups
    assert tm.loop_closures == jm.loop_closures >= 1
    assert int(tm.state.pt_valid.sum()) == int(jnp.sum(jm.state.pt_valid))   # same fusion
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    assert tm._gba_iters_left == jm._gba_iters_left
    assert 0 < tm._gba_iters_left < 10
    drains = 0
    while tm._gba_iters_left > 0:
        tm._drain_gba_budget()
        drains += 1
        assert drains <= 10
    e_before = tlie.log_se3(tst.kf_pose[7] @ tlie.inv_se3(tst.kf_pose[0])).numpy()
    e_after = tlie.log_se3(tm.state.kf_pose[7] @ tlie.inv_se3(tm.state.kf_pose[0])).numpy()
    assert np.linalg.norm(e_after) < 0.6 * np.linalg.norm(e_before)


def _mono_run(port: bool):
    world = pw.SMALL._replace(step=0.3)   # mono needs parallax
    jc = make_cfg(sensor="mono")
    seq = td.frames(world, pw.make_texture(world), "mono", 10)
    if port:
        return td.drive(tms, tlm, ttr, port_config(jc), seq, code_len=4, stage="mono",
                        objects=td.loop_inputs(tstage, True), device="cpu"), world
    return td.drive(jms, jlm, jtr, jc, seq, code_len=4, stage="mono",
                    objects=td.loop_inputs(jstage, False)), world


@pytest.mark.parametrize("port", [False, True])
def test_mono_e2e(port):
    (tr, n_kf, _), world = _mono_run(port)
    ok = np.array([bool(o) for _, _, o in tr.trajectory])
    assert ok.sum() >= 6 and n_kf >= 2
    T = np.stack([np.asarray(p, np.float32) for (_, p, o) in tr.trajectory if o])
    gt = np.array([[round(ts / 0.1) * world.step, 0.0, 0.0]
                   for ts, _, o in tr.trajectory if o], np.float32)
    if port:
        est = tlie.inv_se3(torch.from_numpy(T))[:, :3, 3]
        _, ate = tsim3.align_trajectories(est, torch.from_numpy(gt), fix_scale=False)
    else:
        est = jlie.inv_se3(jnp.asarray(T))[:, :3, 3]
        _, ate = jsim3.align_trajectories(est, jnp.asarray(gt), fix_scale=False)
    assert float(ate) < 0.08 * float(gt[-1, 0] - gt[0, 0])


@pytest.mark.parametrize("port", [False, True])
def test_lost_and_relocalize(port):
    world = pw.SMALL
    seq, frame_of = td.reloc_frames(world, pw.make_texture(world))
    rng = np.random.default_rng(0)
    jv = jvoc.train(rng.integers(0, 2 ** 32, (3000, 8), dtype=np.uint32), branching=6, depth=3)
    jc = make_cfg()
    calls = []
    if port:
        inputs = td.loop_inputs(tstage, True, vocab=port_vocab(jv))
        args = (tms, tlm, ttr, port_config(jc))
        kw = {"device": "cpu"}
    else:
        inputs = td.loop_inputs(jstage, False, vocab=jv)
        args = (jms, jlm, jtr, jc)
        kw = {}
    hook = inputs["reloc"]
    inputs["reloc"] = lambda *a: (lambda f: calls.append(list(hook(*a)(f))) or calls[-1])
    tr, n_kf, _ = td.drive(*args, seq, code_len=4, stage="reloc", objects=inputs, **kw)
    ok = [bool(o) for _, _, o in tr.trajectory]
    assert all(ok[:6]) and n_kf >= 1
    assert not ok[6] and not ok[7]                       # lost in the blackout
    back = [i for i in range(8, len(seq)) if ok[i]]
    assert back, "relocalization failed"
    assert len(calls) >= 1 and any(len(c) for c in calls)   # BoW candidates were used
    est_x = -float(np.asarray(tr.trajectory[back[0]][1])[0, 3])
    assert abs(est_x - pw.gt_x(world, frame_of[back[0]])) < 0.08
    assert tr.status == "OK"


def test_revisit_and_retrieval_maps_match_the_test_builders():
    """`tools/revisit_map.py` (numpy, used by chip_smoke.py phase 11 at
    KITTI capacity) draws the maps of test_loop_integration.py and
    test_loop_scale.py: integers and descriptors exact, floats 1e-4 (pixels of f32 projections)."""
    from dsp_slam_rgbd_tpu_torch.tools import revisit_map
    import test_loop_scale as jls

    want, drift_j = jli.build_revisit_state(np.random.default_rng(3))
    got, drift = revisit_map.build_revisit_state(np.random.default_rng(3))
    np.testing.assert_allclose(drift, np.asarray(drift_j), atol=1e-6)
    rng_j, rng_t = np.random.default_rng(4), np.random.default_rng(4)
    st_j = jls._random_map(rng_j, 40, 32, 600, n_live_kf=30, n_live_pts=500, pts_per_kf=20)
    db_j = jls._random_db(rng_j, 40, 64, st_j.kf_valid)
    st_t, db_t = revisit_map.random_retrieval_map(rng_t, 40, 32, 600, 30, 500, 20, 64)
    np.testing.assert_array_equal(db_t["bow"], np.asarray(db_j.bow))
    for w, g in ((want, got), (st_j, st_t)):
        for k, v in w._asdict().items():
            v = np.asarray(v)
            if v.dtype.kind == "f":
                np.testing.assert_allclose(g[k], v, atol=1e-4, err_msg=k)
            else:
                np.testing.assert_array_equal(g[k], v, err_msg=k)
