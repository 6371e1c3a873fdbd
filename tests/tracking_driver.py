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
    leave the host's keyframe mask.

Run as a script, it drives the JAX package on the CPU at the KITTI-size
world that `chip_smoke.py` phase 8 drives the port at (24 stereo frames,
12 RGB-D frames), with both stages, and prints each sequence's largest
translation error, the number phase 8's bands come from:

    JAX_PLATFORMS=cpu python tests/tracking_driver.py
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from dsp_slam_rgbd_tpu_torch.tools import plane_world as pw  # noqa: E402


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


def drive(ms, lm, tracker_mod, cfg, seq, code_len, stage="bootstrap", **device):
    """Track `seq`, inserting keyframes with `stage` ("bootstrap" or
    "full") -> (tracker, keyframe count, culled slots in order).  `ms`,
    `lm`, `tracker_mod`: either package's map_state, local_mapping and
    tracker modules; `device` goes to the port's entry points."""
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
    for i, (left, right, depth) in enumerate(seq):
        out = tr.track(left, img_right=right, depth_map=depth, timestamp=i * 0.1)[-1]
        if not out["new_kf"]:
            continue
        slot = int(ms.alloc_slots(kf_valid, 1)[0])
        if slot < 0:
            continue
        kf_valid[slot] = True
        if stage == "full":
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


if __name__ == "__main__":
    main()
