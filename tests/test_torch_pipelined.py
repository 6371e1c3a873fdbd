"""The port's one-frame pipelined tracking (`TrackingConfig.pipelined`) on
the CPU.

  * `_track_frame_device` (no host read: both branches run, the device
    selects) equals `_track_frame_fused` (the host reads the motion-model
    stage's counts and runs only the branch taken): pose, associations,
    stats, counters, on the next frame and on one three frames on (three
    times the motion the velocity predicts);
  * tests/test_pipelined_tracking.py's contract, its bars on the port's
    `SLAMSystem`: the pipeline primes (a provisional result), every frame
    has one trajectory entry after `flush`, >= 80% OK after the first two,
    largest error < 0.12 m, >= 2 keyframes;
  * the port's pipelined `SLAMSystem` against the JAX package's, both at
    `async_kf_frames=0`, on those 12 frames and on a sequence like
    tests/test_reloc_e2e.py's (9 frames, a blank one, 3 back at frame 2's
    viewpoint; after 6 a keyframe's map change would make the blank frame
    a synchronous one), where the blank frame fails after the next one was
    dispatched on it:
    the same provisional and finalized results call by call (frame id, OK,
    keyframe), the same rewound frames (the speculative dispatch undone,
    the fallback chain, the next frame tracked again), the same keyframes
    and culled slots, and trajectories within 1e-2 m frame by frame (as
    test_torch_slam_system.py holds the synchronous tracker), and on the
    blank-frame sequence the found/visible counters of the points both maps
    hold equal (the next frame's undone dispatch had raised them);
  * a deliberate divergence from the JAX package (ROADMAP §3): there a
    keyframe finalized one frame late takes the detections passed with the
    NEXT frame, and `flush` passes none; the port hands every keyframe the
    detections passed with its own frame, through `flush` too.
"""
import dataclasses

import numpy as np
import pytest
import torch

import tracking_driver as td
from dsp_slam_rgbd_tpu.system import slam as jslam
from dsp_slam_rgbd_tpu_torch.system import slam as tslam
from dsp_slam_rgbd_tpu_torch.tools import plane_world as pw
from dsp_slam_rgbd_tpu_torch.tracking import tracker as ttr
from test_system_e2e import BASELINE, STEP, make_cfg, make_texture, render
from test_torch_slam_system import configs, record_culls
from test_torch_tracking import port_config

N = 12


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def imgs():
    tex = make_texture(np.random.default_rng(0))
    return [(render(tex, i * STEP), render(tex, i * STEP + BASELINE)) for i in range(N)]


def pipelined_cfg():
    jc = make_cfg()
    return dataclasses.replace(port_config(jc), tracking=dataclasses.replace(
        port_config(jc).tracking, pipelined=True))


def test_device_select_equals_host_branch(imgs):
    cfg = port_config(make_cfg())
    s = tslam.SLAMSystem(cfg, device="cpu")
    for i, (left, right) in enumerate(imgs[:4]):
        s.track_stereo(left, right, timestamp=i * 0.1)
    s.flush()
    tr = s.tracker
    lf = tr.last_frame
    for step in (1, 3):
        left, right = imgs[3 + step]
        f = tr.make_frame(left, img_right=right)
        args = (cfg.cam, tr.state, lf.t_cw, tr.velocity, f.feats.xy, f.feats.desc,
                f.feats.level, f.feats.valid, f.feats.angle, f.ur, f.depth, lf.pt_idx,
                lf.feats.angle, tr._radius, tr._th_depth_m(), cfg.map.local_window, True)
        host = ttr._track_frame_fused(*args)
        dev = ttr._track_frame_device(*args)
        np.testing.assert_array_equal(dev[2].numpy(), host[2])
        for a, b in zip(dev[:2] + dev[3:], host[:2] + host[3:]):
            assert torch.equal(a, b)
    s.shutdown()


@pytest.fixture(scope="module")
def pipelined_run(imgs):
    s = tslam.SLAMSystem(pipelined_cfg(), device="cpu")
    pairs, enqueue = [], s._enqueue_kf

    def recording(frame, detections, timestamp, fid=None):
        pairs.append((fid, s.tracker.frame_id, detections))
        return enqueue(frame, detections, timestamp, fid=fid)

    s._enqueue_kf = recording
    provisional = 0
    for i, (left, right) in enumerate(imgs):
        out = s.track_stereo(left, right, timestamp=i * 0.1, detections=[("frame", i)])
        provisional += bool(out.get("provisional"))
    s.flush()
    s.shutdown()
    return s, provisional, pairs


def test_pipelined_tracking_contract(pipelined_run):
    s, provisional, _ = pipelined_run
    assert provisional >= 1
    traj = s.tracker.trajectory
    assert len(traj) == N
    ok, err, _ = td.trajectory_errors(pw.SMALL, traj)
    assert ok[2:].mean() > 0.8
    assert err[ok].max() < 0.12
    assert s.n_kf >= 2
    assert s.tracker._inflight is None


def test_keyframes_take_their_own_frames_detections(pipelined_run):
    s, _, pairs = pipelined_run
    assert len(pairs) >= 2
    assert any(fid < now for fid, now, _ in pairs[1:]), "no keyframe was finalized late"
    for fid, _, dets in pairs:
        assert dets == [("frame", fid)], (fid, dets)
    assert not s._frame_dets   # nothing left behind after flush


def record_results(system):
    """Wrap the system's tracker: each call's results as (frame id,
    provisional, OK, keyframe), and the frames whose failure rewound a
    speculative dispatch (a finalize with one given that returns two
    results: the failed frame's and the next frame's, tracked again)."""
    calls, rewound, tr = [], [], system.tracker
    track, pending, finalize = tr.track, tr.finalize_pending, tr._finalize_one

    def log(outs):
        calls.append([(int(o["fid"]), bool(o.get("provisional")), bool(o["ok"]),
                       bool(o.get("new_kf"))) for o in outs])
        return outs

    def finalize_one(infl, speculative):
        outs = finalize(infl, speculative)
        if speculative is not None and len(outs) == 2:
            rewound.append(int(infl["fid"]))
        return outs

    tr.track = lambda *a, **k: log(track(*a, **k))
    tr.finalize_pending = lambda: log(pending()) if tr._inflight is not None else []
    tr._finalize_one = finalize_one
    return calls, rewound


def pipelined_pair(seq):
    """`seq` [(left, right)] through both packages' pipelined `SLAMSystem`
    at async_kf_frames=0 -> {package: (system, calls, rewound, culled)}."""
    jc, tc = configs(0)
    jc = dataclasses.replace(jc, tracking=dataclasses.replace(jc.tracking, pipelined=True))
    tc = dataclasses.replace(tc, tracking=dataclasses.replace(tc.tracking, pipelined=True))
    out = {}
    for pkg, s in (("jax", jslam.SLAMSystem(jc)), ("torch", tslam.SLAMSystem(tc, device="cpu"))):
        culled = record_culls(s)
        calls, rewound = record_results(s)
        for i, (left, right) in enumerate(seq):
            s.track_stereo(left, right, timestamp=i * 0.1)
        s.flush()
        out[pkg] = (s, calls, rewound, culled)
    out["torch"][0].shutdown()
    return out


def poses(system):
    traj = system.tracker.trajectory
    return (np.array([bool(o) for _, _, o in traj]),
            np.stack([np.asarray(p, np.float64) for _, p, _ in traj]))


def assert_pipelined_like_jax(runs, n, counters=False):
    (js, j_calls, j_rew, j_culled), (ts, t_calls, t_rew, t_culled) = runs["jax"], runs["torch"]
    assert t_calls == j_calls
    assert t_rew == j_rew
    assert ts.n_kf == js.n_kf >= 2
    assert t_culled == j_culled
    np.testing.assert_array_equal(ts.state.kf_valid.numpy(), np.asarray(js.state.kf_valid))
    if counters:
        # the points both maps hold (same slot, within 1e-3 m), seen and found
        # as often (the undone dispatch had raised both counters)
        jv, tv = np.asarray(js.state.pt_valid), ts.state.pt_valid.numpy()
        same = jv & tv & (np.abs(np.asarray(js.state.pt_pos) - ts.state.pt_pos.numpy())
                          .max(1) < 1e-3)
        assert same.sum() >= 0.8 * jv.sum()
        for k in ("pt_visible", "pt_found"):
            np.testing.assert_array_equal(getattr(ts.state, k).numpy()[same],
                                          np.asarray(getattr(js.state, k))[same], err_msg=k)
    (j_ok, j_T), (t_ok, t_T) = poses(js), poses(ts)
    assert len(t_ok) == len(j_ok) == n
    np.testing.assert_array_equal(t_ok, j_ok)
    assert np.abs(t_T[t_ok, :3, 3] - j_T[j_ok, :3, 3]).max() < 1e-2
    assert ts.tracker._inflight is None


def test_pipelined_system_like_jax(imgs):
    runs = pipelined_pair(imgs)
    assert_pipelined_like_jax(runs, N)
    calls = runs["torch"][1]
    assert any(o[1] for c in calls for o in c), "the pipeline did not prime"
    assert any(not o[1] and o[0] < i for i, c in enumerate(calls[:N]) for o in c), \
        "no frame was finalized one call late"


def test_pipelined_rewind_like_jax(imgs):
    blank = np.zeros_like(imgs[0][0])
    seq = imgs[:9] + [(blank, blank)] + [imgs[2]] * 3
    runs = pipelined_pair(seq)
    assert_pipelined_like_jax(runs, len(seq), counters=True)
    ts, _, rewound, _ = runs["torch"]
    assert rewound == [9], "the blank frame did not fail with the next one dispatched"
    ok, T = poses(ts)
    assert not ok[9] and ok[-1]
    # back at frame 2's viewpoint (tests/test_reloc_e2e.py's bar)
    assert abs(-T[-1, 0, 3] - 2 * STEP) < 0.08
