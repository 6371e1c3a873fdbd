"""The port's `SLAMSystem` (mapping worker, deterministic adoption, merge,
two keyframe mirrors, exports) against the JAX package's, on the CPU.

  * tests/test_system_e2e.py's world (12 stereo frames of the 224x160
    tilted plane) with its detections of one sphere, through both systems
    at `async_kf_frames=0`, with a small DeepSDF decoder fitted to the
    sphere family here and carried across with `weights.decoder_from_numpy`:
    in both >= 80% of frames OK and the largest error < 0.08 m (the bands of
    tests/test_torch_tracking.py's sequences; the object edges in BA move
    the JAX run's to 0.058 m), the same keyframe count and culled slots,
    frame trajectories within 1e-2 m frame by frame (as
    test_full_keyframe_stage_tracks_like_jax holds them), and in both the
    JAX test's object bars (one object seen from >= 2 keyframes, center
    within 0.3 m, >= 2 pose edges);
  * the port at `async_kf_frames=3`: the JAX test's bands (>= 80% of
    frames OK after the first two, error < 0.05 m, median point depth 7-14
    m, >= 2 keyframes);
  * determinism: the same run with a worker slowed by a sleep before every
    job, under a short thread switch interval, gives the same trajectory,
    bit for bit;
  * no `MapState` field is written in place, across `MappingStage.process`
    and across a tracked frame (`Tensor._version` unchanged);
  * `_adopt_merge` equal to the JAX package's on random remaps and
    recycled slots;
  * frames without timestamps give the trajectory of the run with them
    (re-anchoring by frame id);
  * `reset`, `load_state`, localization mode, keyframe capacity exhausted
    (warned once, tracking goes on), `shutdown`.
"""
import dataclasses
import sys
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracking_driver as td
from dsp_slam_rgbd_tpu.models import deepsdf as jdeepsdf
from dsp_slam_rgbd_tpu.recon.optimizer import ReconConfig as JRecon
from dsp_slam_rgbd_tpu.system import detections as jdet
from dsp_slam_rgbd_tpu.system import slam as jslam
from dsp_slam_rgbd_tpu_torch.mapping import map_state as tms
from dsp_slam_rgbd_tpu_torch.models.deepsdf import DecoderSpec, DeepSDFDecoder
from dsp_slam_rgbd_tpu_torch.recon.optimizer import ReconConfig as TRecon
from dsp_slam_rgbd_tpu_torch.system import detections as tdet
from dsp_slam_rgbd_tpu_torch.system import slam as tslam
from dsp_slam_rgbd_tpu_torch.tools import plane_world as pw
from dsp_slam_rgbd_tpu_torch.weights import decoder_from_numpy
from test_system_e2e import BASELINE, N_FRAMES, STEP, make_cfg, make_texture, render
from test_torch_tracking import port_config

SPEC = DecoderSpec(latent_size=4, dims=(32, 32, 32), latent_in=(2,))
OBJ_WORLD = np.array([1.0, 0.0, 6.0])


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def sphere_layers(steps=400):
    """[(W (in, out), b)] of a small DeepSDF decoder fitted (Adam, seeded) to
    the sphere family sdf = |x| − (0.5 + 0.2·code[0]), clamped to ±0.1."""
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    layers = []
    for i, o in SPEC.layer_dims():
        layers.append((rng.standard_normal((i, o)).astype(np.float32) / np.sqrt(i),
                       np.zeros(o, np.float32)))
    dec = DeepSDFDecoder(SPEC, layers)
    params = [p.requires_grad_(True) for W, b in dec.layers for p in (W, b)]
    opt = torch.optim.Adam(params, lr=3e-3)
    g = torch.Generator().manual_seed(0)
    for _ in range(steps):
        xyz = (torch.rand(2048, 3, generator=g) * 2 - 1) * 0.9
        code = torch.zeros(2048, 4)
        code[:, 0] = torch.rand(2048, generator=g) * 2 - 1
        target = torch.clamp(xyz.norm(dim=1) - (0.5 + 0.2 * code[:, 0]), -0.1, 0.1)
        loss = torch.mean((dec.sdf(code, xyz) - target) ** 2)
        opt.zero_grad()
        loss.backward()
        opt.step()
    return [(W.detach().numpy().copy(), b.detach().numpy().copy()) for W, b in dec.layers]


def frames():
    tex = make_texture(np.random.default_rng(0))
    return [(render(tex, i * STEP), render(tex, i * STEP + BASELINE)) for i in range(N_FRAMES)]


def detections(det_mod):
    """test_system_e2e.run_sequence's detections of the sphere at
    OBJ_WORLD, frame by frame, packed by `det_mod`."""
    rng = np.random.default_rng(7)
    t_wo = np.eye(4, dtype=np.float32)
    t_wo[:3, 3] = OBJ_WORLD
    out = []
    for i in range(N_FRAMES):
        t_cw = np.eye(4, dtype=np.float32)
        t_cw[0, 3] = -i * STEP
        t_co = t_cw @ t_wo
        d = rng.standard_normal((100, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        pts_cam = (d * 0.5) @ t_co[:3, :3].T + t_co[:3, 3]
        vis = pts_cam[pts_cam[:, 2] > 0][:64]
        depths = np.linalg.norm(vis, axis=1)
        out.append([det_mod.make_detection(t_co, pts=pts_cam, rays=vis / depths[:, None],
                                           depth=depths, n_fg=len(vis))])
    return out


def configs(async_kf_frames):
    jc = dataclasses.replace(make_cfg(), async_kf_frames=async_kf_frames)
    recon = {k: v for k, v in jc.recon._asdict().items() if k in TRecon._fields}
    return jc, dataclasses.replace(port_config(jc), recon=TRecon(**recon))


def versions(state) -> dict:
    return {k: getattr(state, k)._version for k in tms.MapState._fields}


def record_culls(system, unchanged=None):
    """Wrap the system's `mapping.process` to collect the culled slots (and,
    given a list `unchanged`, whether the job left its input state's tensors
    unwritten)."""
    culled, process = [], system.mapping.process

    def wrapped(job):
        state = system.mapping.state
        before = versions(state) if unchanged is not None else None
        res = process(job)
        culled.extend(c for c, _, _ in res.culled)
        if unchanged is not None:
            unchanged.append(versions(state) == before)
        return res

    system.mapping.process = wrapped
    return culled


def run(system, imgs, dets=None):
    for i, (left, right) in enumerate(imgs):
        system.track_stereo(left, right, timestamp=i * 0.1,
                            detections=None if dets is None else dets[i])
    system.flush()
    return system


@pytest.fixture(scope="module")
def imgs():
    return frames()


@pytest.fixture(scope="module")
def sync_runs(imgs):
    layers = sphere_layers()
    jc, tc = configs(0)
    jspec = jdeepsdf.DecoderSpec(*SPEC)
    js = jslam.SLAMSystem(jc, decoder_params={"layers": [(jnp.asarray(W), jnp.asarray(b))
                                                          for W, b in layers]},
                          decoder_spec=jspec)
    ts = tslam.SLAMSystem(tc, decoder=decoder_from_numpy(layers, SPEC, device="cpu"),
                          device="cpu")
    unchanged = []
    jc_, tc_ = record_culls(js), record_culls(ts, unchanged)
    run(js, imgs, detections(jdet))
    run(ts, imgs, detections(tdet))
    ts.shutdown()
    return {"jax": (js, jc_), "torch": (ts, tc_), "unchanged": unchanged}


def test_sync_system_tracks_like_jax(sync_runs):
    errs = {}
    for pkg in ("jax", "torch"):
        s = sync_runs[pkg][0]
        ok, err, T = td.trajectory_errors(pw.SMALL, s.tracker.trajectory)
        assert len(ok) == N_FRAMES and ok.mean() >= 0.8, pkg
        assert err[ok].max() < 0.08, pkg
        errs[pkg] = T
    (js, j_culled), (ts, t_culled) = sync_runs["jax"], sync_runs["torch"]
    assert np.abs(errs["torch"][:, :3, 3] - errs["jax"][:, :3, 3]).max() < 1e-2
    assert js.n_kf == ts.n_kf >= 2
    assert j_culled == t_culled
    np.testing.assert_array_equal(ts.state.kf_valid.numpy(), np.asarray(js.state.kf_valid))
    # the saved trajectories: one row a tracked frame, the same rows
    jt, tt = js._frame_poses(), ts._frame_poses()
    np.testing.assert_array_equal(tt[0], jt[0])
    assert np.abs(tt[1][:, :3, 3] - np.asarray(jt[1])[:, :3, 3]).max() < 1e-2


def test_sync_system_objects_like_jax(sync_runs):
    for pkg in ("jax", "torch"):
        st = sync_runs[pkg][0].state
        valid = np.asarray(st.obj_valid)
        assert valid.sum() == 1, pkg
        o = int(np.nonzero(valid)[0][0])
        assert int(st.obj_n_obs[o]) >= 2, pkg
        np.testing.assert_allclose(np.asarray(st.obj_pose)[o][:3, 3], OBJ_WORLD, atol=0.3,
                                   err_msg=pkg)
        assert int(np.asarray(st.oobs_valid).sum()) >= 2, pkg
    (js, _), (ts, _) = sync_runs["jax"], sync_runs["torch"]
    assert int(ts.state.obj_n_obs.sum()) == int(np.asarray(js.state.obj_n_obs).sum())
    # the object stage writes no state tensor in place either
    assert len(sync_runs["unchanged"]) >= 2 and all(sync_runs["unchanged"])


@pytest.fixture(scope="module")
def async_run(imgs):
    _, tc = configs(3)
    s = tslam.SLAMSystem(tc, device="cpu")
    unchanged, tracked = [], []
    record_culls(s, unchanged)
    for i, (left, right) in enumerate(imgs):
        state = s.state
        before = versions(state)
        s.track_stereo(left, right, timestamp=i * 0.1)
        tracked.append(versions(state) == before)
    s.flush()
    s.shutdown()
    return s, unchanged, tracked


def test_async_system_bands(async_run):
    s, _, _ = async_run
    ok, err, _ = td.trajectory_errors(pw.SMALL, s.tracker.trajectory)
    assert ok[2:].mean() > 0.8
    assert err[ok].max() < 0.05
    z = s.state.pt_pos[s.state.pt_valid][:, 2].numpy()
    assert np.isfinite(z).all() and 7.0 < np.median(z) < 14.0
    assert s.n_kf >= 2
    assert s._worker is None and not s._pending


def test_map_state_never_written_in_place(async_run):
    _, unchanged, tracked = async_run
    assert len(unchanged) >= 2 and all(unchanged)
    assert len(tracked) == N_FRAMES and all(tracked)


def test_slow_worker_gives_the_same_run(async_run, imgs):
    fast, _, _ = async_run
    _, tc = configs(3)
    slow = tslam.SLAMSystem(tc, device="cpu")
    process = slow.mapping.process

    def sleepy(job):
        time.sleep(0.3)
        return process(job)

    slow.mapping.process = sleepy
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        run(slow, imgs)
    finally:
        sys.setswitchinterval(interval)
        slow.shutdown()
    # the main thread waited for the slowed jobs (before a stats read or at adoption)
    assert slow.blocked_ms["prewait"] + slow.blocked_ms["adopt"] > 300.0, slow.blocked_ms
    assert slow.n_kf == fast.n_kf
    assert len(slow.tracker.trajectory) == len(fast.tracker.trajectory)
    for (ta, pa, oa), (tb, pb, ob) in zip(slow.tracker.trajectory, fast.tracker.trajectory):
        assert ta == tb and oa == ob and torch.equal(pa, pb)
    for k in tms.MapState._fields:
        assert torch.equal(getattr(slow.state, k), getattr(fast.state, k)), k


def test_no_timestamps_give_the_same_trajectory(async_run, imgs):
    """Frames tracked without timestamps (all 0.0) at `async_kf_frames` 3:
    a keyframe's relative-trajectory entry is re-anchored by its frame id,
    so the saved trajectory equals the run with distinct timestamps (the
    JAX package matches timestamps and would re-anchor the newest entry)."""
    timed, _, _ = async_run
    _, tc = configs(3)
    s = tslam.SLAMSystem(tc, device="cpu")
    try:
        for left, right in imgs:
            s.track_stereo(left, right)
        _, poses, ok = s._frame_poses()
    finally:
        s.shutdown()
    _, poses_t, ok_t = timed._frame_poses()
    assert s.n_kf == timed.n_kf >= 3
    np.testing.assert_array_equal(ok, ok_t)
    np.testing.assert_array_equal(poses, poses_t)


def test_adopt_merge_matches_jax():
    rng = np.random.default_rng(0)
    P, F = 400, 120
    for trial in range(4):
        base_first = rng.integers(-1, 6, P).astype(np.int32)
        pt_first = base_first.copy()
        recycled = rng.uniform(size=P) < 0.2             # the job culled + refilled these
        pt_first[recycled] = 9
        fields = {
            "pt_first_kf": pt_first,
            "pt_valid": rng.uniform(size=P) < 0.8,
            "pt_visible": rng.integers(1, 50, P).astype(np.int32),
            "pt_found": rng.integers(1, 30, P).astype(np.int32),
        }
        base_vis, base_fnd = (rng.integers(1, 40, P).astype(np.int32) for _ in range(2))
        view_vis = base_vis + rng.integers(0, 5, P).astype(np.int32)
        view_fnd = base_fnd + rng.integers(0, 5, P).astype(np.int32)
        view_first = np.where(rng.uniform(size=P) < 0.9, base_first, 3).astype(np.int32)
        lf = np.where(rng.uniform(size=F) < 0.7, rng.integers(0, P, F), -1).astype(np.int32)
        remap = (np.arange(P) if trial == 0 else rng.permutation(P)).astype(np.int32)
        js = td_state(fields, "jax")
        ts = td_state(fields, "torch")
        jn, jpi = jslam._adopt_merge(js, *map(jnp.asarray, (base_vis, base_fnd, base_first,
                                                             view_vis, view_fnd, view_first,
                                                             lf, remap)))
        tn, tpi = tslam._adopt_merge(ts, *map(torch.from_numpy, (base_vis, base_fnd,
                                                                 base_first, view_vis,
                                                                 view_fnd, view_first, lf,
                                                                 remap)))
        np.testing.assert_array_equal(tpi.numpy(), np.asarray(jpi))
        assert tpi.dtype == torch.int32
        for k in ("pt_visible", "pt_found"):
            np.testing.assert_array_equal(getattr(tn, k).numpy(), np.asarray(getattr(jn, k)))
        assert (tpi.numpy() == -1).sum() > (lf == -1).sum()   # dead tenants dropped


def td_state(fields, pkg):
    """A map state of 400 point slots with `fields` set, in either package."""
    if pkg == "jax":
        from dsp_slam_rgbd_tpu.mapping import map_state as jms

        st = jms.empty(max_kf=4, max_feat=8, max_pts=400, max_obj=2)
        return st._replace(**{k: jnp.asarray(v) for k, v in fields.items()})
    st = tms.empty(max_kf=4, max_feat=8, max_pts=400, max_obj=2, device="cpu")
    return st._replace(**{k: torch.from_numpy(v) for k, v in fields.items()})


def test_reset_load_state_localization(imgs, tmp_path):
    from dsp_slam_rgbd_tpu_torch.utils import checkpoint

    _, tc = configs(3)
    s = tslam.SLAMSystem(tc, device="cpu")
    run(s, imgs[:6])
    assert s.n_kf >= 2
    checkpoint.save_state(str(tmp_path / "map.npz"), s.state, extra={"n_kf": s.n_kf})
    kv = s.state.kf_valid.numpy().copy()
    # localization: tracking goes on, no keyframe is made
    s.activate_localization_mode()
    n_kf = s.n_kf
    for i, (left, right) in enumerate(imgs[6:9]):
        s.track_stereo(left, right, timestamp=(6 + i) * 0.1)
    assert s.n_kf == n_kf and s.tracker.status == "OK"
    s.deactivate_localization_mode()
    s.reset()
    assert s.n_kf == 0 and not s._kf_valid_host.any() and not s.mapping.kf_valid_host.any()
    assert not bool(s.state.kf_valid.any()) and s.tracker.status == "NOT_INITIALIZED"
    extra = s.load_state(str(tmp_path / "map.npz"))
    assert int(extra["n_kf"]) == n_kf == s.n_kf
    np.testing.assert_array_equal(s._kf_valid_host, kv)
    np.testing.assert_array_equal(s.mapping.kf_valid_host, kv)
    # the next keyframe takes a free slot, never a live one
    slot = int(tms.alloc_slots(s._kf_valid_host, 1)[0])
    assert not kv[slot]
    s.shutdown()


def test_keyframe_capacity_exhaustion_warned_once(imgs):
    jc, tc = configs(3)
    tc = dataclasses.replace(tc, map=dataclasses.replace(tc.map, max_kf=2),
                             tracking=dataclasses.replace(tc.tracking, max_frames_between_kf=2))
    s = tslam.SLAMSystem(tc, device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run(s, imgs)
    s.shutdown()
    assert s.kf_slots_exhausted >= 2
    hits = [w for w in caught if issubclass(w.category, RuntimeWarning)
            and "keyframe capacity" in str(w.message)]
    assert len(hits) == 1
    assert len(s.tracker.trajectory) == N_FRAMES
