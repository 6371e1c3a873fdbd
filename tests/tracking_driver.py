"""The keyframe driver that holds the port's tracker to the JAX package's on
the tilted-plane world (imported by tests/test_torch_tracking.py).

Either package's `Tracker` runs a sequence; whenever it returns `new_kf`,
the driver inserts the keyframe with one of two stages:
  * "bootstrap": the stereo subset of the keyframe point stage
    (`insert_keyframe`, `spawn_depth_points`, `update_point_geometry`);
  * "full": what the JAX package's keyframe stage runs for a keyframe
    without detections and without loop closing
    (`system/mapping_stage.py:190-242`): `kf_point_stage` (insert, spawn,
    triangulation, fusion, point culling, geometry), then
    `local_ba_and_cull_step` over the local window, and the culled slots
    leave the host's keyframe mask;
  * "objects": the package's `MappingStage(..., vocab=None).process`
    (`system/mapping_stage.py`), the full keyframe stage with detections:
    `objects` carries the stage's constructor and the detections of
    `dsp_slam_rgbd_tpu_torch/tools/object_world.py` (see
    `object_inputs`);
  * "loop": `MappingStage(..., vocab=...).process` without detections:
    the keyframe stage with the BoW database and loop closing (see
    `loop_inputs`);
  * "mono": the monocular sequence: the two-frame initialization goes in
    through the package's `SLAMSystem._insert_mono_init`,
    every later keyframe through `MappingStage.process`;
  * "reloc": "loop" with the tracker's relocalization candidates from the
    BoW database (`SLAMSystem._reloc_candidates`, installed as
    `Tracker.reloc_candidates_fn`).

Run as a script, it drives the JAX package on the CPU at the KITTI-size
world that `chip_smoke.py` phase 8 drives the port at (24 stereo frames,
12 RGB-D frames), with both stages, and prints each sequence's largest
translation error, the number phase 8's bands come from; then the stereo
sequence again with the "objects" stage at phase 10's size (8 objects of
`object_world.kitti_objects`, 256 points and 512 rays a detection, the
fixture decoder, `ReconConfig()`), and prints the largest camera error,
each object's center error and the dynamic flags, the numbers phase 10's
bands come from:

    JAX_PLATFORMS=cpu python tests/tracking_driver.py

With `cli DIR` it writes `chip_smoke.py` phase 12a's KITTI directory into
DIR (`tools/sequence_dirs.py::write_kitti_objects`) and runs the JAX
package's command line (`tools/run_slam.py`) over it with 12a's arguments,
its yaml reader wrapped to give a keyframe the port's command line's
feature slots (`run_slam.feature_slots`: 2,048 for the yaml's 2,000
features, where the JAX command line keeps 1,024), and prints the ATE
after a rigid alignment, the largest translation error and the static
objects' center errors, the numbers 12a's bands come from (~5 min):

    JAX_PLATFORMS=cpu python tests/tracking_driver.py cli DIR

With `circuit DIR` it writes `chip_smoke.py` phase 16's KITTI-size loop
circuit into DIR (`tools/sequence_dirs.py::write_kitti_circuit`) and runs
the JAX command line over it with phase 16's arguments (`circuit_args`:
the labels, the fixture decoder, the vocabulary CIRCUIT_VOCAB, --gt) and
the port's feature slots, and prints what `circuit_metrics` reads: the
ATE, the largest error, the lap gap and lap-2 error, the closures,
keyframes and dropped keyframes, the map objects and each static truth's
nearest one, the numbers of `chip_smoke.JAX_CIRCUIT` (~6 min); with
`--train` it bootstraps the vocabulary (25 frames, 10^4 words) as
CIRCUIT_VOCAB was made, with k-medians seeded by `--seed S` (0, as
CIRCUIT_VOCAB, by default).  `mono-plane` runs the JAX mono tracker on the
bare KITTI plane at phase 11a's 14 frames (`chip_smoke.JAX_MONO_PLANE`):

    JAX_PLATFORMS=cpu python tests/tracking_driver.py circuit DIR [--train [--seed S]]
    JAX_PLATFORMS=cpu python tests/tracking_driver.py mono-plane

With `pipelined DIR` (the "pipelined" stage) it writes `chip_smoke.py`
phase 12b's RGB-D layout into DIR (12 KITTI-size frames of the tilted
plane as rgb/ + 16-bit depth/ PNGs, a yaml of phase 8's tracking
configuration at 5 fps: `tools/sequence_dirs.py::write_rgbd`,
`write_yaml`) and runs the JAX package's command line over it with the
port's feature slots, once synchronous and once with the pipelined tracker
(`TrackingConfig.pipelined`): the JAX pipelined `SLAMSystem` at 12b's
configuration.  It prints each run's keyframe count and its camera center
of every frame (CameraTrajectory_TUM.txt), the numbers 12b holds the
port's two runs to (~3 min):

    JAX_PLATFORMS=cpu python tests/tracking_driver.py pipelined DIR
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from dsp_slam_rgbd_tpu_torch.tools import object_world as ow  # noqa: E402
from dsp_slam_rgbd_tpu_torch.tools import plane_world as pw  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "ellipsoid_decoder_64.npz")
# the vocabulary both command lines close the KITTI-size circuit with: the one the JAX
# command line bootstraps over `write_kitti_circuit`'s directory (`circuit DIR --train`:
# 25 frames, branching 10, depth 4).  The port's ORB rounds its orientation in f64, so
# ~0.3% of its descriptors differ from JAX's, and k-medians over them trains another
# vocabulary, with which either package closes the circuit differently
CIRCUIT_VOCAB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                             "circuit_vocab_10k.npz")
# the frames `circuit DIR --train` bootstraps that vocabulary from
CIRCUIT_VOCAB_FRAMES = 25


def frames(world, texture, sensor, n, u8=False):
    """[(left, right or None, depth or None)] for frames 0..n-1."""
    img = pw.render_u8 if u8 else pw.render
    out = []
    for i in range(n):
        x = pw.gt_x(world, i)
        out.append((img(world, texture, x),
                    img(world, texture, x + world.baseline) if sensor == "stereo" else None,
                    pw.depth_map(world, x) if sensor == "rgbd" else None))
    return out


def object_inputs(stage_mod, det_mod, world, truths, n_pts, n_rays, seed=0,
                  on_keyframe=None, **stage_kwargs):
    """The "objects" stage's inputs for `drive`: `stage_mod` and `det_mod`
    are either package's mapping_stage and detections modules,
    `stage_kwargs` its decoder (`decoder_params`/`decoder_spec` for the
    JAX package, `decoder` for the port).  Frame i's detections are
    `object_world.frame_detections` (the same numpy for both packages).
    on_keyframe(i, job, pre_state, result, truth indices) is called after
    each `process`."""
    def make_detections(i):
        return ow.frame_detections(det_mod, world, truths, i, n_pts, n_rays, seed)

    return {"stage": lambda cfg, state, kv: stage_mod.MappingStage(cfg, state, kv, **stage_kwargs),
            "job": stage_mod.KFJob, "detections": make_detections, "on_keyframe": on_keyframe}


def _jax_slam_method(name, tr, mapping, kf_valid):
    """A bound `SLAMSystem` method of the JAX package over a driver's
    tracker, mapping stage and keyframe mask (the methods read only these,
    and `flush`, which has nothing to flush here)."""
    import types

    from dsp_slam_rgbd_tpu.system.slam import SLAMSystem

    shim = types.SimpleNamespace(tracker=tr, mapping=mapping, _kf_valid_host=kf_valid,
                                 vocab=mapping.vocab, state=tr.state, n_kf=0,
                                 flush=lambda: None)
    return types.MethodType(getattr(SLAMSystem, name), shim)


def jax_insert_mono_init(tr, mapping, kf_valid):
    """The JAX package's `SLAMSystem._insert_mono_init` -> keyframe count."""
    _jax_slam_method("_insert_mono_init", tr, mapping, kf_valid)()
    return 2


def jax_reloc_candidates(tr, mapping, kf_valid):
    """The JAX package's `SLAMSystem._reloc_candidates` as a frame -> slots
    hook."""
    return _jax_slam_method("_reloc_candidates", tr, mapping, kf_valid)


def port_insert_mono_init(tr, mapping, kf_valid):
    """The port's `SLAMSystem._insert_mono_init` over the driver's tracker,
    mapping stage and keyframe mask (its mapping stage shares the mask)."""
    import types

    from dsp_slam_rgbd_tpu_torch.system.slam import SLAMSystem

    shim = types.SimpleNamespace(tracker=tr, mapping=mapping, _kf_valid_host=kf_valid,
                                 state=tr.state, n_kf=0, _map_stream=None,
                                 flush=lambda: None)
    SLAMSystem._insert_mono_init(shim)
    return shim.n_kf


def port_reloc_candidates(tr, mapping, kf_valid):
    """The port's `SLAMSystem._reloc_candidates` as a frame -> slots hook,
    over the mapping stage's current database."""
    import types

    from dsp_slam_rgbd_tpu_torch.system.slam import SLAMSystem

    return lambda frame: SLAMSystem._reloc_candidates(types.SimpleNamespace(
        tracker=tr, vocab=mapping.vocab, _db_view=mapping.db), frame)


def loop_inputs(stage_mod, port: bool, on_keyframe=None, **stage_kwargs):
    """The "loop", "mono" and "reloc" stages' inputs for `drive`:
    `stage_mod` is either package's mapping_stage module, `port` says which
    package (it picks the `SLAMSystem` methods it calls),
    `stage_kwargs` its `vocab` (None: no BoW database)."""
    return {"stage": lambda cfg, state, kv: stage_mod.MappingStage(cfg, state, kv, **stage_kwargs),
            "job": stage_mod.KFJob, "detections": lambda i: (None, None),
            "on_keyframe": on_keyframe,
            "mono_init": port_insert_mono_init if port else jax_insert_mono_init,
            "reloc": port_reloc_candidates if port else jax_reloc_candidates}


def reloc_frames(world, texture, n_map=6, n_blank=2, back_frame=2, n_back=3):
    """test_reloc_e2e.py's sequence: n_map stereo frames along the path,
    n_blank black frames (tracking is lost), then n_back frames at frame
    `back_frame`'s viewpoint -> ([(left, right, None)], frame index of each
    entry or -1 for a blank)."""
    seq = frames(world, texture, "stereo", n_map, u8=True)
    blank = np.zeros((world.h, world.w), np.uint8)
    seq += [(blank, blank, None)] * n_blank + [seq[back_frame]] * n_back
    return seq, list(range(n_map)) + [-1] * n_blank + [back_frame] * n_back


def drive(ms, lm, tracker_mod, cfg, seq, code_len, stage="bootstrap", objects=None,
          **device):
    """Track `seq`, inserting keyframes with `stage` ("bootstrap", "full",
    "objects" with `objects` from `object_inputs`, or "loop", "mono",
    "reloc" with `objects` from `loop_inputs`) -> (tracker, keyframe count,
    culled slots in order); the mapping stage, if any, is `tr.mapping`.
    `ms`, `lm`, `tracker_mod`: either package's map_state, local_mapping
    and tracker modules; `device` goes to the port's entry points."""
    m = cfg.map
    state = ms.empty(max_kf=m.max_kf, max_feat=m.max_feat, max_pts=m.max_pts,
                     max_obj=m.max_obj, code_len=code_len, max_oobs=m.max_oobs,
                     **device)
    tr = tracker_mod.Tracker(cfg, state, **device)
    kf_valid = np.zeros(m.max_kf, bool)
    n_kf = 0
    culled = []
    th_depth_m = cfg.tracking.th_depth * cfg.cam.bf / cfg.cam.fx
    stereo = cfg.sensor in ("stereo", "rgbd")
    staged = stage in ("objects", "loop", "mono", "reloc")
    mapping = objects["stage"](cfg, tr.state, kf_valid) if staged else None
    tr.mapping = mapping
    if stage == "reloc":
        tr.reloc_candidates_fn = objects["reloc"](tr, mapping, kf_valid)
    for i, (left, right, depth) in enumerate(seq):
        out = tr.track(left, img_right=right, depth_map=depth, timestamp=i * 0.1)[-1]
        if not out["new_kf"]:
            continue
        if stage == "mono" and n_kf == 0:
            # the initialization's two keyframes (`CreateInitialMapMonocular`)
            mapping.state = tr.state
            n_kf = objects["mono_init"](tr, mapping, kf_valid)
            continue
        slot = int(ms.alloc_slots(kf_valid, 1)[0])
        if slot < 0:
            continue
        kf_valid[slot] = True
        if staged:
            dets, truth_idx = objects["detections"](i)
            job = objects["job"](frame=out["frame"], detections=dets, kf_slot=slot, kid=n_kf,
                                 frame_id=out["fid"], timestamp=out["timestamp"])
            mapping.state = pre = tr.state
            res = mapping.process(job)
            if objects["on_keyframe"] is not None:
                objects["on_keyframe"](i, job, pre, res, truth_idx)
            culled += [c for c, _, _ in res.culled]   # `process` cleared them in kf_valid
            st = res.state
        elif stage == "full":
            st = lm.kf_point_stage(tr.state, cfg.cam, slot, out["frame"], out["fid"],
                                   th_depth_m, n_kf, stereo,
                                   n_neighbors=10 if stereo else 20,
                                   min_obs_after=4 if stereo else 3)
            st, gone = lm.local_ba_and_cull_step(st, cfg.cam, slot, m.local_window)
            kf_valid[gone] = False
            culled += gone
        else:
            st = lm.insert_keyframe(tr.state, out["frame"], slot, out["fid"])
            st = lm.spawn_depth_points(st, cfg.cam, slot, out["frame"], th_depth_m,
                                       first_id=n_kf)
            st = lm.update_point_geometry(st)
        tr.state = st
        n_kf += 1
        tr.last_kf_frame_id = out["fid"]
        if tr.ref_kf < 0:
            tr.ref_kf = slot
    return tr, n_kf, culled


def trajectory_errors(world, trajectory):
    """(ok (n,) bool, |x_est − x_true| (n,), T_cw (n, 4, 4)) from a tracker's
    trajectory (timestamps 0.1 s a frame)."""
    ok = np.array([bool(o) for _, _, o in trajectory])
    T = np.stack([np.asarray(p, np.float64) for _, p, _ in trajectory])
    gt = np.array([pw.gt_x(world, int(round(t / 0.1))) for t, _, _ in trajectory])
    return ok, np.abs(-T[:, 0, 3] - gt), T


def kitti_configs(pkg_config, pkg_orb, pkg_camera, sensor):
    """Phase 8's KITTI-size configuration (`tools/bench_pipeline.py:91-117`)
    from either package's config, OrbConfig and Intrinsics."""
    w = pw.KITTI
    cam = pkg_camera.Intrinsics(fx=w.fx, fy=w.fx, cx=w.cx, cy=w.cy, bf=w.fx * w.baseline)
    return pkg_config.SystemConfig(
        sensor=sensor, cam=cam, orb=pkg_orb.OrbConfig(),
        tracking=pkg_config.TrackingConfig(fps=10.0, th_depth=35.0, max_frames_between_kf=5),
        map=pkg_config.MapConfig(max_kf=48, max_feat=2048, max_pts=32768, max_obj=8,
                                 max_oobs=256, local_window=8))


def objects_run(world=pw.KITTI, n=24, seed=0):
    """The JAX package's stereo run with the "objects" stage at phase 10's
    size on the CPU -> (tracker, keyframe count, culled, ObjectLog)."""
    from dsp_slam_rgbd_tpu import config
    from dsp_slam_rgbd_tpu.frontend import orb
    from dsp_slam_rgbd_tpu.mapping import local_mapping, map_state
    from dsp_slam_rgbd_tpu.models import deepsdf
    from dsp_slam_rgbd_tpu.ops import camera
    from dsp_slam_rgbd_tpu.system import detections, mapping_stage
    from dsp_slam_rgbd_tpu.tracking import tracker

    truths = ow.kitti_objects(seed)
    log = ow.ObjectLog(truths)
    params, spec = deepsdf.load_npz(FIXTURE)
    objects = object_inputs(mapping_stage, detections, world, truths, 256, 512, seed,
                            on_keyframe=lambda i, job, pre, res, idx: log(i, res.state),
                            decoder_params=params, decoder_spec=spec)
    cfg = kitti_configs(config, orb, camera, "stereo")
    tr, n_kf, culled = drive(map_state, local_mapping, tracker, cfg,
                             frames(world, pw.make_texture(world), "stereo", n, u8=True),
                             code_len=64, stage="objects", objects=objects)
    return tr, n_kf, culled, log


def main():
    from dsp_slam_rgbd_tpu import config
    from dsp_slam_rgbd_tpu.frontend import orb
    from dsp_slam_rgbd_tpu.mapping import local_mapping, map_state
    from dsp_slam_rgbd_tpu.ops import camera
    from dsp_slam_rgbd_tpu.tracking import tracker

    world = pw.KITTI
    texture = pw.make_texture(world)
    for stage in ("bootstrap", "full"):
        for sensor, n in (("stereo", 24), ("rgbd", 12)):
            cfg = kitti_configs(config, orb, camera, sensor)
            t0 = time.perf_counter()
            tr, n_kf, culled = drive(map_state, local_mapping, tracker, cfg,
                                     frames(world, texture, sensor, n, u8=True), code_len=64,
                                     stage=stage)
            ok, err, _ = trajectory_errors(world, tr.trajectory)
            print(f"JAX package on the CPU, KITTI-size {sensor}, {n} frames, {stage} "
                  f"keyframe stage: ok {ok.mean():.3f}, keyframes {n_kf}, culled {culled}, "
                  f"largest translation error {err[ok].max():.6f} m "
                  f"({time.perf_counter() - t0:.0f} s); per frame "
                  f"{' '.join(f'{e:.3f}' for e in err)}", flush=True)
    t0 = time.perf_counter()
    tr, n_kf, culled, log = objects_run(world)
    ok, err, _ = trajectory_errors(world, tr.trajectory)
    summ = log.summary()
    print(f"JAX package on the CPU, KITTI-size stereo, 24 frames, objects keyframe stage "
          f"(8 objects, 256 points, 512 rays, ReconConfig()): ok {ok.mean():.3f}, keyframes "
          f"{n_kf}, culled {culled}, largest translation error {err[ok].max():.6f} m; objects "
          f"valid {summ['valid']}, identities kept {summ['identities_kept']}; per slot "
          + ", ".join(f"{d['slot']}->truth {d['truth']} err {d['center_err_m']:.4f} m "
                      f"dynamic {d['dynamic']} (truth {d['truth_dynamic']})"
                      for d in summ["slots"])
          + f" ({time.perf_counter() - t0:.0f} s)", flush=True)


def mono_outcome(world, trajectory, n):
    """A mono run's outcome as phase 11a reads it: {"init_frame" (the
    first tracked frame, the trajectory starts there; -1 if none),
    "ok_share" (of n frames), "ate_m" (camera centers after a Sim(3)
    alignment; None without 3 tracked frames)}."""
    import torch

    from dsp_slam_rgbd_tpu_torch.solvers import sim3

    ok = np.array([bool(o) for _, _, o in trajectory], bool)
    if not ok.any():
        return {"init_frame": -1, "ok_share": 0.0, "ate_m": None}
    T = np.stack([np.asarray(p.cpu() if hasattr(p, "cpu") else p, np.float64)
                  for (_, p, o) in trajectory if o])
    cen = np.linalg.inv(T)[:, :3, 3]
    gt = np.asarray([[pw.gt_x(world, int(round(t / 0.1))), 0.0, 0.0]
                     for t, _, o in trajectory if o])
    ate = float(sim3.align_trajectories(torch.tensor(cen, dtype=torch.float32),
                                        torch.tensor(gt, dtype=torch.float32))[1]) \
        if len(cen) >= 3 else None
    return {"init_frame": int(round(trajectory[int(np.argmax(ok))][0] / 0.1)),
            "ok_share": float(ok.sum() / n), "ate_m": ate}


def mono_plane_run(n=14):
    """The JAX package's mono tracker with the keyframe stage ("mono") on
    the bare KITTI wall (`plane_world.KITTI`, no floor) for phase 11a's 14
    frames at phase 8's configuration and `OrbConfig()` -> `mono_outcome`
    and the keyframe count."""
    from dsp_slam_rgbd_tpu import config
    from dsp_slam_rgbd_tpu.frontend import orb
    from dsp_slam_rgbd_tpu.mapping import local_mapping, map_state
    from dsp_slam_rgbd_tpu.ops import camera
    from dsp_slam_rgbd_tpu.system import mapping_stage
    from dsp_slam_rgbd_tpu.tracking import tracker

    world = pw.KITTI
    cfg = kitti_configs(config, orb, camera, "mono")
    tr, n_kf, _ = drive(map_state, local_mapping, tracker, cfg,
                        frames(world, pw.make_texture(world), "mono", n, u8=True), code_len=64,
                        stage="mono", objects=loop_inputs(mapping_stage, False))
    return dict(mono_outcome(world, tr.trajectory, n), keyframes=n_kf)


def cli_run(root):
    """The JAX command line over phase 12a's directory (see the module
    docstring) -> {"ate_m", "max_err_m", "static_center_err_m", "summary"}."""
    import json
    from unittest import mock

    import torch

    from dsp_slam_rgbd_tpu import config
    from dsp_slam_rgbd_tpu_torch.solvers import sim3
    from dsp_slam_rgbd_tpu_torch.system import io as io_mod
    from dsp_slam_rgbd_tpu_torch.tools import run_slam as port_cli
    from dsp_slam_rgbd_tpu_torch.tools import sequence_dirs as sd
    from tools import run_slam as jax_cli

    paths = sd.write_kitti_objects(root)
    out = os.path.join(root, "out_jax")
    read = config.from_reference_yaml_json

    def sized(*a, **k):
        cfg = read(*a, **k)
        return config.replace(cfg, map=config.replace(cfg.map,
                                                      max_feat=port_cli.feature_slots(cfg)))

    argv = ["run_slam.py", paths["seq"], out, "--yaml", paths["yaml"], "--labels",
            paths["labels"], "--deepsdf", FIXTURE, "--vocab", os.path.join(root, "vocab.npz"),
            "--bootstrap-vocab", "24", "--vocab-depth", "4", "--gt", paths["gt"]]
    with mock.patch.object(config, "from_reference_yaml_json", sized), \
            mock.patch.object(sys, "argv", argv):
        jax_cli.main()
    rows = np.loadtxt(os.path.join(out, "CameraTrajectory.txt"), ndmin=2)[:, [3, 7, 11]]
    gt = np.loadtxt(paths["gt"], ndmin=2)[:, [3, 7, 11]]
    ate = float(sim3.align_trajectories(torch.tensor(rows, dtype=torch.float32),
                                        torch.tensor(gt[:len(rows)], dtype=torch.float32),
                                        fix_scale=True)[1])
    ids, poses, _ = io_mod.load_map_objects(os.path.join(out, "MapObjects.txt"))
    centers = [float(np.linalg.norm(poses[:, :3, 3] - t.center, axis=1).min())
               for t in ow.kitti_objects()[:7]]
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    return {"ate_m": ate, "max_err_m": float(np.abs(rows - gt[:len(rows)]).max()),
            "rows": len(rows), "static_center_err_m": centers, "map_objects": len(ids),
            "summary": summary}


def circuit_metrics(paths, out, fps=10.0):
    """The numbers phase 16 holds the port's run to, read from a command
    line's output directory over `write_kitti_circuit`'s files: the ATE
    after a rigid alignment and the largest translation error of
    CameraTrajectory_TUM.txt's rows (frame = timestamp · fps), the lap gap
    and the largest lap-2 error (`loop_world.center_metrics`), and each
    static truth's nearest map object and the map objects within
    `fuse_duplicate_objects`' 1.5 m of it."""
    import json

    from dsp_slam_rgbd_tpu_torch.system import io as io_mod
    from dsp_slam_rgbd_tpu_torch.tools import loop_world as lw

    rows = np.loadtxt(os.path.join(out, "CameraTrajectory_TUM.txt"), ndmin=2)
    fi = np.round(rows[:, 0] * fps).astype(int)
    cen = rows[:, 1:4]
    xys = lw.KITTI.path()
    ate, gap, lap2 = lw.center_metrics(xys, fi, cen, lw.KITTI.n_lap)
    gt = np.asarray([[xys[f][0], xys[f][1], 0.0] for f in fi])
    ids, poses, _ = io_mod.load_map_objects(os.path.join(out, "MapObjects.txt"))
    d = np.stack([np.linalg.norm(poses[:, :3, 3] - t.center, axis=1) if len(ids)
                  else np.full(1, np.inf) for t in lw.kitti_objects()])
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    return {"rows": len(rows), "frames": int(len(xys)), "ate_m": ate,
            "max_err_m": float(np.abs(cen - gt).max()), "lap_gap_m": gap, "lap2_max_m": lap2,
            "loop_closures": summary["loop_closures"], "keyframes": summary["n_kf"],
            "kf_slots_exhausted": summary["kf_slots_exhausted"], "map_objects": len(ids),
            "truth_nearest_m": d.min(axis=1).tolist(),
            "truth_objects_within_1_5m": (d < 1.5).sum(axis=1).tolist(), "summary": summary}


def circuit_run(root, train=False, seed=0):
    """The JAX command line over `write_kitti_circuit`'s directory with
    phase 16's arguments and the port's feature slots -> `circuit_metrics`.
    The run loads CIRCUIT_VOCAB, as phase 16 does; with `train` it
    bootstraps the vocabulary anew from CIRCUIT_VOCAB_FRAMES frames with
    k-medians seeded by `seed` (root/vocab.npz; seed 0 made CIRCUIT_VOCAB)."""
    import functools
    import shutil
    from unittest import mock

    from dsp_slam_rgbd_tpu import config
    from dsp_slam_rgbd_tpu.loop import vocabulary
    from dsp_slam_rgbd_tpu_torch.tools import run_slam as port_cli
    from dsp_slam_rgbd_tpu_torch.tools import sequence_dirs as sd
    from tools import run_slam as jax_cli

    paths = sd.write_kitti_circuit(root)
    out = os.path.join(root, "out_jax")
    read = config.from_reference_yaml_json

    def sized(*a, **k):
        cfg = read(*a, **k)
        return config.replace(cfg, map=config.replace(cfg.map,
                                                      max_feat=port_cli.feature_slots(cfg)))

    vocab = os.path.join(root, "vocab.npz")
    if os.path.exists(vocab):
        os.remove(vocab)
    if not train:
        shutil.copy(CIRCUIT_VOCAB, vocab)
    argv = ["run_slam.py"] + circuit_args(paths, out, vocab, train)
    with mock.patch.object(config, "from_reference_yaml_json", sized), \
            mock.patch.object(vocabulary, "train",
                              functools.partial(vocabulary.train, seed=seed)), \
            mock.patch.object(sys, "argv", argv):
        jax_cli.main()
    return circuit_metrics(paths, out)


def circuit_args(paths, out, vocab, train=False):
    """Phase 16's command line arguments (either package's `run_slam`);
    with `train`, those that bootstrap the vocabulary into `vocab`."""
    boot = ["--bootstrap-vocab", str(CIRCUIT_VOCAB_FRAMES)] if train else []
    return [paths["seq"], out, "--yaml", paths["yaml"], "--labels", paths["labels"],
            "--deepsdf", FIXTURE, "--vocab", vocab, *boot, "--vocab-depth", "4",
            "--gt", paths["gt"]]


def pipelined_run(root, n=12):
    """The JAX command line over 12b's RGB-D layout, synchronous and
    pipelined -> {mode: {"keyframes", "frames" (frame index of each row),
    "centers" (each row's camera center), "summary"}}."""
    import json
    from unittest import mock

    from dsp_slam_rgbd_tpu import config
    from dsp_slam_rgbd_tpu_torch.tools import run_slam as port_cli
    from dsp_slam_rgbd_tpu_torch.tools import sequence_dirs as sd
    from tools import run_slam as jax_cli

    world = pw.KITTI
    seq = os.path.join(root, "rgbd")
    sd.write_rgbd(seq, world, pw.make_texture(world), n)
    yaml = os.path.join(root, "rgbd.yaml")
    sd.write_yaml(yaml, world, fps=5.0)
    read = config.from_reference_yaml_json
    out = {}
    for mode in ("sync", "pipelined"):
        def sized(*a, **k):
            cfg = read(*a, **k)
            return config.replace(
                cfg, map=config.replace(cfg.map, max_feat=port_cli.feature_slots(cfg)),
                tracking=config.replace(cfg.tracking, pipelined=mode == "pipelined"))

        dst = os.path.join(root, f"out_rgbd_{mode}")
        argv = ["run_slam.py", seq, dst, "--sensor", "rgbd", "--yaml", yaml]
        with mock.patch.object(config, "from_reference_yaml_json", sized), \
                mock.patch.object(sys, "argv", argv):
            jax_cli.main()
        rows = np.loadtxt(os.path.join(dst, "CameraTrajectory_TUM.txt"), ndmin=2)
        with open(os.path.join(dst, "summary.json")) as f:
            summary = json.load(f)
        out[mode] = {"keyframes": summary["n_kf"],
                     "frames": np.round(rows[:, 0] * 5.0).astype(int).tolist(),
                     "centers": rows[:, 1:4].tolist(), "summary": summary}
    return out


if __name__ == "__main__":
    if sys.argv[1:2] == ["pipelined"]:
        t0 = time.perf_counter()
        for mode, r in pipelined_run(sys.argv[2]).items():
            print(f"JAX package's command line on the CPU over phase 12b's RGB-D layout, "
                  f"{mode}: keyframes {r['keyframes']}, frames {r['frames']}, centers "
                  f"{[[round(float(v), 6) for v in c] for c in r['centers']]}", flush=True)
        print(f"({time.perf_counter() - t0:.0f} s)")
    elif sys.argv[1:2] == ["mono-plane"]:
        t0 = time.perf_counter()
        r = mono_plane_run()
        print(f"JAX package on the CPU, mono on the bare KITTI plane (plane_world.KITTI, 14 "
              f"frames, OrbConfig(), phase 8's configuration, the mono keyframe stage): {r} "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)
    elif sys.argv[1:2] == ["circuit"]:
        t0 = time.perf_counter()
        seed = int(sys.argv[sys.argv.index("--seed") + 1]) if "--seed" in sys.argv else 0
        r = circuit_run(sys.argv[2], train="--train" in sys.argv[3:], seed=seed)
        print(f"JAX package's command line on the CPU over phase 16's KITTI-size circuit: "
              + ", ".join(f"{k} {v!r}" for k, v in r.items() if k != "summary")
              + f"; summary {r['summary']} ({time.perf_counter() - t0:.0f} s)", flush=True)
    elif sys.argv[1:2] == ["cli"]:
        t0 = time.perf_counter()
        r = cli_run(sys.argv[2])
        print(f"JAX package's command line on the CPU over phase 12a's directory: "
              f"{r['rows']} rows, ATE {r['ate_m']!r} m, largest translation error "
              f"{r['max_err_m']!r} m, {r['map_objects']} map objects, static centers "
              + ", ".join(f"{e:.4f}" for e in r["static_center_err_m"])
              + f" m; summary {r['summary']} ({time.perf_counter() - t0:.0f} s)", flush=True)
    else:
        main()
