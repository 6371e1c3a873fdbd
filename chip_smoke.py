#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--report details.json]

Builds the port's CUDA kernels from `dsp_slam_rgbd_tpu_torch/csrc/`,
holds each against its plain PyTorch version on the card, drives the main
path (batched object reconstruction at the full cars_64 decoder width,
with the committed fixture decoder) and checks its output, times each
kernel at the main path's shapes, then drives the per-frame tracking path
and the keyframe stage at KITTI size (phases 8 and 9a) and bundle
adjustment at KITTI-00 scale (phases 9b and 9c).  Exits non-zero, with no
result line, if there is no card or any phase fails.  Prints, before the
last line, the card's name and power limit and one JSON line of kernel
numbers; the last line is {"ok": true, "device": {...}}.  With --report,
every measured number also goes to that JSON file.

Phase 2 also counts the tensor-core (HGMMA) instructions in the SASS of
both bf16 kernels (value and Jacobian) and fails if there are none or if
either spills to local memory; phase 3 also holds each of them to its
plain version at ragged row counts up to past the main path's sizes, for
shared, per-row and per-object codes, at random weights (where a fault of
summation order would show).

Tolerances (kernel vs plain version, same inputs, on the card):
  * f32: sdf atol 2e-5; Jacobian atol 2e-4 on rows whose ReLU
    pre-activations all keep |pre| >= 1e-6 (nearer 0 another summation
    order may take the other mask; at most 10% of rows are left out);
  * bf16 vs plain bf16: sdf atol 1e-2, Jacobian Frobenius relative 2e-2
    (same rounding points, f32 sums in another order can flip a bf16
    rounding).  The bf16 Jacobian kernel also reports the ReLU masks it
    took (`masks_out`).  A change of summation order moves later
    pre-activations by a few 1e-3 through each layer's bf16 rounding, and
    a unit that near 0 takes the other side: at random weights about one
    unit in ten rows, which alone moves the whole Jacobian by 1-2.5%
    (tests/test_torch_jacobian_tiles.py shows it on the CPU with a model
    of the tensor cores' accumulation).  So the kernel is held to: its
    masks equal the plain version's at every unit with |pre| >= 1e-2
    (BF16_TIE), and differ at no more than 8 + n/5 units over n rows;
    the plain reverse sweep under its masks within 2e-2; and the plain
    version with its own masks within 2e-2 on the rows where no mask
    differs.  Each case also reports the largest |pre| of a unit whose
    masks differ, the error against the plain version's own masks over
    all rows, and the distance of kernel and plain version from the
    plain version with every product summed in f64 and rounded once;
  * bf16 vs f32: Jacobian row cosine >= 0.90, Frobenius relative <= 0.25;
  * one f32 GN iteration, kernels on the card vs plain versions on the
    CPU: pose and code atol 2e-3.

Phase 8 drives the per-frame tracking path, and phase 9 the keyframe
stage and bundle adjustment (torch ops on the card; they launch no
kernel of the port), at KITTI size: 1241x376 uint8 images, fx = fy =
718.856, baseline 0.537 m, `OrbConfig()` (2,000 features, 8 levels),
`MapConfig(max_kf=48, max_feat=2048, max_pts=32768, local_window=8)`,
`TrackingConfig(th_depth=35, max_frames_between_kf=5)`, the tilted-plane
world of `tools/bench_pipeline.py`
(`dsp_slam_rgbd_tpu_torch/tools/plane_world.py`):
  * 8a: `extract_pair` and `match_stereo` of one pair on the card and on
    the CPU: keypoints equal on >= 99% of each image, descriptors equal at
    every common keypoint, >= 100 common stereo matches with depths within
    1e-3 relative;
  * 8b / 8c: 24 stereo and 12 RGB-D frames with the full keyframe stage
    (`drive_tracking`: `kf_point_stage`, then `local_ba_and_cull_step`):
    >= 90% of frames OK, >= 2 keyframes, finite poses, at least one
    keyframe culled in the stereo run, and a largest translation error
    under STEREO_BAND / RGBD_BAND, 1.5x the JAX package's own on the same
    driver and world on the CPU (0.110393 m and 0.184753 m with 10 and 6
    keyframes, the stereo run culling slots 2 and 1; with the keyframe
    bootstrap alone, 3.403762 m and 0.184759 m:
    `JAX_PLATFORMS=cpu python tests/tracking_driver.py`); median ms per
    frame and per keyframe stage;
  * then per-frame times (ORB extraction, stereo match, the fused tracking
    stage, pose GN), host syncs of one frame
    (`torch.cuda.set_sync_debug_mode`), and launches, busy time and idle
    share of one traced frame, on the frames after 8b's;
  * 9a: one more keyframe stage on 8b's map: host syncs of the stage,
    launches, busy time and idle share of each half, the BA window's size;
  * 9b: BA on the KITTI-00-scale corridor map (`tools/corridor_map.py`:
    1,000 keyframes, 200,000 points), tests/test_ba_scale.py's criteria:
    local BA at keyframes 10, 500 and 990 with B <= 64 and the mean
    reprojection error cut below 0.7x; one `global_ba_pcg(n_iters=6)`
    with B >= 1,000, every live observation (> 150,000) in the problem, a
    finite result and the error cut below 0.5x; ms and launches of each;
  * 9c: the card against the CPU on the same problems: one LM step of each
    local problem within 1e-4 (poses and points), and on the 24-keyframe
    corridor the dense and PCG solvers each within 0.03 m of the truth
    and within 5e-3 of each other on both, card and CPU within 5e-3.
"""
import argparse
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "ellipsoid_decoder_64.npz")

SDF_ATOL, JAC_ATOL, TIE = 2e-5, 2e-4, 1e-6
BF16_SDF_ATOL, BF16_JAC_FROB, BF16_TIE = 1e-2, 2e-2, 1e-2
# main path: bench.py's shapes
B, N_PTS, N_RAYS, ITERS = 8, 256, 512, 10
# bf16 kernel sweeps: around their 64-row tile, and past the main path's sizes
VALUE_ROWS = (1, 63, 64, 65, 300, 4097, 102417)
JAC_ROWS = (1, 63, 64, 65, 300, 2048, 2049, 8192, 8193)
# phase 8 bands on the largest translation error (m); see the docstring
STEREO_BAND, RGBD_BAND = 0.166, 0.277
# (bf16 dense tensor-core FLOP/s, memory bytes/s): NVIDIA data sheets
PEAKS = {"H100 PCIe": (756e12, 2.0e12), "H200": (989e12, 4.8e12), "H100": (989e12, 3.35e12)}


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device time of fn over `reps` back-to-back calls (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_fit(fit, untraced_ms):
    """Device time of one traced fit, from torch.profiler's kernel events:
    total busy time, the share the mlp_sdf kernels take, the five kernels
    that take the most, and the idle share of an untraced fit's wall time
    (tracing slows the host, not the kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in p.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    check(busy > 0, "the profiler saw device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"traced_wall_ms": wall_ms, "busy_ms": busy, "idle_share": 1.0 - busy / untraced_ms,
            "mlp_sdf_ms": sum(v for k, v in by_name.items() if "mlp_sdf" in k),
            "n_kernels": sum(1 for e in p.events() if e.device_type == DeviceType.CUDA),
            "top": [(k[:60], v) for k, v in top]}


def hgmma_count(build, kernel):
    """HGMMA (wgmma) instructions in `kernel`'s SASS in the built library."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", build.lib_path], capture_output=True,
                          text=True, check=True).stdout
    sections = sass.split("Function : ")[1:]
    check(any(kernel in sec.splitlines()[0] for sec in sections), f"{kernel} in the SASS")
    return sum(sec.count("HGMMA") for sec in sections if kernel in sec.splitlines()[0])


def code_forms(n, gen, dev):
    """(form, code, xyz) over n rows for a shared, per-row and per-object code
    (the largest object count <= 20 that divides n)."""
    b = max(d for d in range(1, 21) if n % d == 0)
    xyz = gen.standard_normal((n, 3)) * 0.5
    for form, code, x in (("shared", gen.standard_normal(64), xyz),
                          ("per-row", gen.standard_normal((n, 64)), xyz),
                          ("per-object", gen.standard_normal((b, 64)), xyz.reshape(b, n // b, 3))):
        yield (form, torch.tensor(code * 0.2, dtype=torch.float32, device=dev),
               torch.tensor(x, dtype=torch.float32, device=dev))


def frob_rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def f64_matmul(a, b):
    """a @ b with the sums in f64, rounded once to f32."""
    return (a.double() @ b.double()).float()


def hold_bf16_jacobian(mlp_sdf, wb, tiles, code, xyz, tag):
    """The bf16 Jacobian kernel against its plain version on the same
    inputs (tolerances above) -> (the kernel's sdf and Jacobian, the
    plain Jacobian under the kernel's masks, the case's numbers)."""
    bf = torch.bfloat16
    relu = torch.empty(xyz.shape[:-1] + (8, 512), dtype=torch.uint8, device=xyz.device)
    s_k, g_k = mlp_sdf.sdf_and_input_jacobian_fused(wb, code, xyz, bf, tiles, masks_out=relu)
    s_p, g_p = mlp_sdf.sdf_and_input_jacobian_plain(wb, code, xyz, bf)
    _, g_m = mlp_sdf.sdf_and_input_jacobian_plain(wb, code, xyz, bf, masks=relu)
    _, g_64 = mlp_sdf.sdf_and_input_jacobian_plain(wb, code, xyz, bf, matmul=f64_matmul)
    pre = mlp_sdf.relu_preactivations(wb, code, xyz, bf)
    torch.cuda.synchronize()
    check(s_k.shape == s_p.shape and g_k.shape == g_p.shape
          and bool(torch.isfinite(s_k).all()) and bool(torch.isfinite(g_k).all()),
          f"{tag}: finite kernel output of the plain version's shape")
    differ = relu.bool() != (pre > 0)
    n_rows, n_differ = s_k.numel(), int(differ.sum())
    agree = ~differ.reshape(n_rows, -1).any(1)   # rows whose masks all agree
    g_k1, g_p1 = g_k.reshape(n_rows, -1), g_p.reshape(n_rows, -1)
    case = {"case": tag, "sdf_err": float((s_k - s_p).abs().max()), "jac_err": frob_rel(g_k, g_m),
            "jac_err_own_masks_agreeing_rows":
                frob_rel(g_k1[agree], g_p1[agree]) if bool(agree.any()) else 0.0,
            "jac_err_own_masks": frob_rel(g_k, g_p), "mask_ties": n_differ,
            "tie_pre_max": float(pre[differ].abs().max()) if n_differ else 0.0,
            "kernel_vs_f64": frob_rel(g_k, g_64), "plain_vs_f64": frob_rel(g_p, g_64)}
    check(case["sdf_err"] <= BF16_SDF_ATOL and case["jac_err"] <= BF16_JAC_FROB
          and case["jac_err_own_masks_agreeing_rows"] <= BF16_JAC_FROB
          and case["tie_pre_max"] < BF16_TIE and n_differ <= 8 + n_rows // 5, f"{tag}: {case}")
    return s_k, g_k, g_m, case


def _median(xs):
    return float(np.median(xs)) if len(xs) else float("nan")


def drive_tracking(world, texture, sensor, n, dev):
    """Phase 8's driver: the port's tracker over n frames of the tilted-
    plane world with the full keyframe stage whenever it returns `new_kf`
    (`kf_point_stage`, then `local_ba_and_cull_step` over the local
    window; culled slots leave the host's keyframe mask): the "full" stage
    of tests/tracking_driver.py.  -> (tracker, keyframe count, culled
    slots, [(untraced wall ms of each frame with its keyframe stage,
    whether it made a keyframe)], [(ms of kf_point_stage, ms of
    local_ba_and_cull_step) per keyframe])."""
    from dsp_slam_rgbd_tpu_torch.mapping import local_mapping as lm
    from dsp_slam_rgbd_tpu_torch.mapping import map_state as ms
    from dsp_slam_rgbd_tpu_torch.tools import plane_world as pw
    from dsp_slam_rgbd_tpu_torch.tracking import tracker as trk

    cfg = tracking_config(world, sensor)
    m = cfg.map
    tr = trk.Tracker(cfg, ms.empty(max_kf=m.max_kf, max_feat=m.max_feat, max_pts=m.max_pts,
                                   max_obj=m.max_obj, max_oobs=m.max_oobs, device=dev),
                     device=dev)
    kf_valid = np.zeros(m.max_kf, bool)
    n_kf = 0
    culled, frame_ms, kf_ms = [], [], []
    th_depth_m = cfg.tracking.th_depth * cfg.cam.bf / cfg.cam.fx
    for i in range(n):
        x = pw.gt_x(world, i)
        left = pw.render_u8(world, texture, x)
        right = pw.render_u8(world, texture, x + world.baseline) if sensor == "stereo" else None
        depth = pw.depth_map(world, x) if sensor == "rgbd" else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tr.track(left, img_right=right, depth_map=depth, timestamp=i * 0.1)[-1]
        if out["new_kf"]:
            slot = int(ms.alloc_slots(kf_valid, 1)[0])
            if slot >= 0:
                kf_valid[slot] = True
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                st = lm.kf_point_stage(tr.state, cfg.cam, slot, out["frame"], out["fid"],
                                       th_depth_m, n_kf, True, n_neighbors=10, min_obs_after=4)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                st, gone = lm.local_ba_and_cull_step(st, cfg.cam, slot, m.local_window)
                torch.cuda.synchronize()
                kf_ms.append(((t2 - t1) * 1e3, (time.perf_counter() - t2) * 1e3))
                kf_valid[gone] = False
                culled += gone
                tr.state = st
                n_kf += 1
                tr.last_kf_frame_id = out["fid"]
                if tr.ref_kf < 0:
                    tr.ref_kf = slot
        torch.cuda.synchronize()
        frame_ms.append(((time.perf_counter() - t0) * 1e3, bool(out["new_kf"])))
    return tr, n_kf, culled, frame_ms, kf_ms


def tracking_config(world, sensor):
    """`tools/bench_pipeline.py:91-117`'s tracking configuration for `world`."""
    from dsp_slam_rgbd_tpu_torch import config
    from dsp_slam_rgbd_tpu_torch.frontend.orb import OrbConfig
    from dsp_slam_rgbd_tpu_torch.ops.camera import Intrinsics

    cam = Intrinsics(fx=world.fx, fy=world.fx, cx=world.cx, cy=world.cy,
                     bf=world.fx * world.baseline)
    return config.SystemConfig(
        sensor=sensor, cam=cam, orb=OrbConfig(),
        tracking=config.TrackingConfig(fps=10.0, th_depth=35.0, max_frames_between_kf=5),
        map=config.MapConfig(max_kf=48, max_feat=2048, max_pts=32768, max_obj=8,
                             max_oobs=256, local_window=8))


def wall_ms(fn, reps):
    """Mean wall time of fn over reps calls, each ended by a synchronize
    (host-driven work: the launches and host reads are part of its time)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def tracking_phase(dev, smi):
    """Phases 8 and 9a: the per-frame tracking path and the keyframe stage
    at KITTI size (see the module docstring) -> the report's "tracking"
    entry."""
    from dsp_slam_rgbd_tpu_torch.frontend import orb, stereo
    from dsp_slam_rgbd_tpu_torch.ops.cuda import mlp_sdf
    from dsp_slam_rgbd_tpu_torch.solvers import pose_gn
    from dsp_slam_rgbd_tpu_torch.tools import plane_world as pw
    from dsp_slam_rgbd_tpu_torch.tracking import tracker as trk

    t_phase = time.perf_counter()
    world = pw.KITTI
    texture = pw.make_texture(world)
    rep = {"card": smi}
    bf = world.fx * world.baseline
    cfg_orb = orb.OrbConfig()

    # ---- 8a. frontend on the card against the same port code on the CPU
    left = pw.render_u8(world, texture, 0.0)
    right = pw.render_u8(world, texture, world.baseline)
    res = []
    for d in (dev, torch.device("cpu")):
        il, ir = orb.to_image(left, d), orb.to_image(right, d)
        fl, fr = orb.extract_pair(il, ir, cfg_orb, device=d)
        sm = stereo.match_stereo(fl, fr, il, ir, bf, min_z=bf / world.fx)
        res.append([t.cpu() for t in (fl.xy, fl.valid, fl.desc, fr.xy, fr.valid, fr.desc,
                                      sm.valid, sm.depth)])
    g, c = res
    same = [((g[i] == c[i]).all(1) & (g[i + 1] == c[i + 1])) for i in (0, 3)]
    kp_eq = [float(s.float().mean()) for s in same]
    desc_bad = [int((g[i + 2][s & g[i + 1]] != c[i + 2][s & g[i + 1]]).any(1).sum())
                for i, s in zip((0, 3), same)]
    common = g[6] & c[6] & same[0]
    depth_rel = float(((g[7] - c[7]).abs() / c[7])[common].max())
    rep["frontend_vs_cpu"] = {"keypoints_equal": kp_eq, "descriptors_differing": desc_bad,
                              "stereo_common": int(common.sum()), "stereo_valid_card": int(g[6].sum()),
                              "stereo_valid_cpu": int(c[6].sum()), "depth_rel_err": depth_rel}
    check(min(kp_eq) >= 0.99 and sum(desc_bad) == 0 and int(common.sum()) >= 100
          and depth_rel <= 1e-3, f"8a frontend on the card vs the CPU: {rep['frontend_vs_cpu']}")
    print(f"phase 8a frontend card vs CPU (KITTI 1241x376 pair, 2000 features, 8 levels): "
          f"keypoints equal {kp_eq[0]:.4f} / {kp_eq[1]:.4f} (left / right), descriptors "
          f"differing at common keypoints {desc_bad}, stereo matches {int(g[6].sum())} card / "
          f"{int(c[6].sum())} CPU, {int(common.sum())} common, largest depth difference "
          f"{depth_rel:.3g} relative on {smi}", flush=True)

    # ---- 8b / 8c. stereo and RGB-D sequences with the full keyframe stage
    # (the counts of the decoder kernels are read around them: the tracking
    # path launches none)
    trackers = {}
    for tag, sensor, n, band in (("8b", "stereo", 24, STEREO_BAND), ("8c", "rgbd", 12, RGBD_BAND)):
        mlp_sdf.reset_launch_counts()
        tr, n_kf, culled, frame_ms, kf_ms = drive_tracking(world, texture, sensor, n, dev)
        launches = dict(mlp_sdf.LAUNCHES)
        trackers[sensor] = tr, n_kf
        ok = np.array([bool(o) for _, _, o in tr.trajectory])
        T = np.stack([p.cpu().numpy() for _, p, _ in tr.trajectory]).astype(np.float64)
        gt = np.array([pw.gt_x(world, int(round(ts / 0.1))) for ts, _, _ in tr.trajectory])
        err = np.abs(-T[:, 0, 3] - gt)
        max_err = float(err[ok].max()) if ok.any() else float("inf")
        seq = {"frames": n, "tracked": len(ok), "ok_share": float(ok.mean()), "keyframes": n_kf,
               "culled": culled, "max_t_err_m": max_err, "band_m": band, "t_err_m": err.tolist(),
               "decoder_kernel_launches": launches,
               "frame_ms_track_only_median": _median([t for t, k in frame_ms[1:] if not k]),
               "frame_ms_keyframe_median": _median([t for t, k in frame_ms[1:] if k]),
               "frame_ms_first": frame_ms[0][0],
               "kf_point_stage_ms": [a for a, _ in kf_ms],
               "local_ba_and_cull_ms": [b for _, b in kf_ms]}
        rep[sensor] = seq
        check(len(ok) == n and ok.mean() >= 0.9 and n_kf >= 2 and np.isfinite(T).all()
              and max_err < band and (sensor != "stereo" or len(culled) >= 1),
              f"{tag} {sensor} sequence: {seq}")
        print(f"phase {tag} {sensor} sequence, full keyframe stage: {n} frames, ok "
              f"{ok.mean():.3f}, {n_kf} keyframes, culled {culled}, largest translation error "
              f"{max_err:.4f} m (band {band} m); median ms per frame "
              f"{seq['frame_ms_track_only_median']:.1f} tracking-only, "
              f"{seq['frame_ms_keyframe_median']:.1f} with a keyframe (first frame "
              f"{seq['frame_ms_first']:.0f} ms); median ms per keyframe: kf_point_stage "
              f"{_median(seq['kf_point_stage_ms'][1:]):.1f}, local_ba_and_cull_step "
              f"{_median(seq['local_ba_and_cull_ms'][1:]):.1f}; decoder kernels launched "
              f"{launches} on {smi}", flush=True)

    # ---- per-part times, syncs, launches, busy: the stereo tracker of 8b
    # on the frames after its checked sequence
    tr, n_kf = trackers["stereo"]
    nxt = pw.gt_x(world, 24)
    img_l = pw.render_u8(world, texture, nxt)
    img_r = pw.render_u8(world, texture, nxt + world.baseline)
    il, ir = orb.to_image(img_l, dev), orb.to_image(img_r, dev)
    fl, fr = orb.extract_pair(il, ir, cfg_orb)
    frame = tr.make_frame(img_l, img_r, timestamp=2.4)
    lf, cam = tr.last_frame, tr.cfg.cam

    def fused():
        return trk._track_frame_fused(
            cam, tr.state, lf.t_cw, tr.velocity, frame.feats.xy, frame.feats.desc,
            frame.feats.level, frame.feats.valid, frame.feats.angle, frame.ur, frame.depth,
            lf.pt_idx, lf.feats.angle, 7.0, tr._th_depth_m(), tr.cfg.map.local_window, True)

    t_cw, pt_idx, stats, _, _ = fused()
    pts_w = tr.state.pt_pos[torch.clamp_min(pt_idx, 0).long()]
    obs = torch.cat([frame.feats.xy, frame.ur[:, None]], -1)
    inv_s2 = 1.0 / (1.2 ** (2.0 * frame.feats.level.float()))
    matched = (pt_idx >= 0) & frame.feats.valid
    parts = {
        "orb_extract_ms_per_image": wall_ms(lambda: orb.extract(il, cfg_orb), 5),
        "stereo_match_ms": wall_ms(lambda: stereo.match_stereo(fl, fr, il, ir, bf,
                                                                min_z=bf / world.fx), 5),
        "fused_tracking_ms": wall_ms(fused, 5),
        "pose_gn_ms": wall_ms(lambda: pose_gn.optimize_pose(cam, lf.t_cw, pts_w, obs, inv_s2,
                                                            matched, stereo=True), 5),
        "fused_stats": stats.tolist()}

    def one_frame(i):
        x = pw.gt_x(world, i)
        out = tr.track(pw.render_u8(world, texture, x), img_right=pw.render_u8(
            world, texture, x + world.baseline), timestamp=i * 0.1)[-1]
        torch.cuda.synchronize()
        return out

    one_frame(24)
    t0 = time.perf_counter()
    one_frame(25)
    untraced = (time.perf_counter() - t0) * 1e3
    syncs = count_syncs(lambda: one_frame(26))
    n_kern, busy = traced(lambda: one_frame(27))
    check(busy > 0, "the profiler saw device time in a tracking frame")
    gn_launches, _ = traced(lambda: pose_gn.optimize_pose(cam, lf.t_cw, pts_w, obs, inv_s2,
                                                          matched, stereo=True))
    parts.update({"frame_ms_untraced": untraced, "host_syncs_per_frame": syncs,
                  "kernel_launches_per_frame": n_kern, "busy_ms": busy,
                  "idle_share": 1.0 - busy / untraced, "pose_gn_launches": gn_launches})
    rep["per_frame"] = parts
    print(f"phase 8 per frame (stereo, KITTI size): ORB extraction {parts['orb_extract_ms_per_image']:.2f}"
          f" ms per image, stereo match {parts['stereo_match_ms']:.2f} ms, fused tracking stage "
          f"{parts['fused_tracking_ms']:.2f} ms, pose GN {parts['pose_gn_ms']:.2f} ms; one frame "
          f"{untraced:.1f} ms untraced: {n_kern} kernel launches ({gn_launches} in one pose GN "
          f"call), {syncs} host syncs, device busy {busy:.2f} ms (idle share "
          f"{parts['idle_share']:.3f}) on {smi}", flush=True)

    # ---- 9a. the keyframe stage at KITTI size, on the stereo tracker's map
    rep["keyframe_stage"] = keyframe_stage_phase(tr, one_frame(28)["frame"], n_kf, smi)
    rep["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 8-9a took {rep['phase_s']:.0f} s", flush=True)
    return rep


def count_syncs(fn):
    """Host syncs of one call of fn (`torch.cuda.set_sync_debug_mode`)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum(1 for w in caught if "synchroniz" in str(w.message))


def traced(fn, top=None):
    """(launches, device busy ms) of one traced call of fn; with `top`,
    also the `top` kernels that took the most device time [(name, ms)]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in p.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    if top is None:
        return len(kern), busy
    by_name = {}
    for e in kern:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 1e3
    return len(kern), busy, sorted(by_name.items(), key=lambda kv: -kv[1])[:top]


def keyframe_stage_phase(tr, frame, kid, smi):
    """Phase 9a: one more keyframe stage on the stereo tracker's map after
    phase 8 (frame 28, keyframe id `kid`, into the first free slot): host
    syncs of the whole stage, launches, busy ms and idle share of each
    half, and the BA window's size.  The per-keyframe medians come from
    8b's run."""
    from dsp_slam_rgbd_tpu_torch.mapping import ba
    from dsp_slam_rgbd_tpu_torch.mapping import local_mapping as lm

    cfg = tr.cfg
    cam, window = cfg.cam, cfg.map.local_window
    th_depth_m = cfg.tracking.th_depth * cam.bf / cam.fx
    state0 = tr.state
    slot = int(np.flatnonzero(~state0.kf_valid.cpu().numpy())[0])

    def point_stage():
        return lm.kf_point_stage(state0, cam, slot, frame, 28, th_depth_m, kid, True,
                                 n_neighbors=10, min_obs_after=4)

    st1 = point_stage()
    counts = lm._ba_counts_device(st1, slot, window, False).cpu().numpy()

    def ba_cull():
        return lm.local_ba_and_cull_step(st1, cam, slot, window)

    def whole():
        return lm.local_ba_and_cull_step(point_stage(), cam, slot, window)

    _, culled = ba_cull()
    torch.cuda.synchronize()
    ms_point = wall_ms(point_stage, 3)
    ms_ba = wall_ms(ba_cull, 3)
    # the BA+cull half's layers, each timed alone
    buckets = lm._bucket_memo[lm._shapes(state0) + (window, False)]
    prob, idx, _ = lm._ba_assemble_device(st1, slot, window, False, *buckets)
    res = ba.local_ba(cam, prob)
    layers = {"assemble_ms": wall_ms(lambda: lm._ba_assemble_device(
                  st1, slot, window, False, *buckets), 3),
              "local_ba_ms": wall_ms(lambda: ba.local_ba(cam, prob), 3),
              "apply_ms": wall_ms(lambda: lm.apply_ba_result(st1, idx, res), 3),
              "cull_ms": wall_ms(lambda: lm._cull_keyframes_device(st1, slot, 0.9, 2), 3),
              "local_ba_launches": traced(lambda: ba.local_ba(cam, prob))[0],
              "fuse_ms": wall_ms(lambda: lm.fuse_neighbors(st1, cam, slot), 3),
              "fuse_busy_ms": traced(lambda: lm.fuse_neighbors(st1, cam, slot))[1]}
    syncs = count_syncs(whole)
    n_point, busy_point, top_point = traced(point_stage, top=4)
    n_ba, busy_ba = traced(ba_cull)
    rep = {"slot": slot, "ba_counts": counts.tolist(),
           "ba_buckets": list(lm._bucket_memo[lm._shapes(state0) + (window, False)]),
           "culled": culled, "host_syncs_per_keyframe_stage": syncs,
           "kf_point_stage_ms": ms_point, "local_ba_and_cull_ms": ms_ba,
           "kf_point_stage_launches": n_point, "kf_point_stage_busy_ms": busy_point,
           "kf_point_stage_top_kernels": top_point,
           "kf_point_stage_idle_share": 1.0 - busy_point / ms_point,
           "local_ba_and_cull_launches": n_ba, "local_ba_and_cull_busy_ms": busy_ba,
           "local_ba_and_cull_idle_share": 1.0 - busy_ba / ms_ba, "layers": layers,
           "card": smi}
    check(busy_point > 0 and busy_ba > 0, "the profiler saw device time in the keyframe stage")
    n_kf, n_pt, n_obs, n_obj, _ = counts
    print(f"phase 9a keyframe stage (stereo KITTI map after 8b, slot {slot}): BA window "
          f"B={n_kf + n_obj} ({n_kf} keyframes), {n_pt} points, {n_obs} edges, buckets "
          f"{rep['ba_buckets']}, culled {culled}; kf_point_stage {ms_point:.1f} ms "
          f"({n_point} launches, busy {busy_point:.2f} ms, idle share "
          f"{rep['kf_point_stage_idle_share']:.3f}), local_ba_and_cull_step {ms_ba:.1f} ms "
          f"({n_ba} launches, busy {busy_ba:.2f} ms, idle share "
          f"{rep['local_ba_and_cull_idle_share']:.3f}; alone: assembly "
          f"{layers['assemble_ms']:.1f} ms, local_ba {layers['local_ba_ms']:.1f} ms in "
          f"{layers['local_ba_launches']} launches, apply {layers['apply_ms']:.1f} ms, cull "
          f"{layers['cull_ms']:.1f} ms; fusion alone {layers['fuse_ms']:.1f} ms, busy "
          f"{layers['fuse_busy_ms']:.2f} ms); {syncs} host syncs per keyframe stage; point stage "
          f"top: " + ", ".join(f"{k} {v:.2f} ms" for k, v in top_point) + f" on {smi}",
          flush=True)
    return rep


def mean_reproj(ba, cam, p):
    """Mean 2-D reprojection error (px) over a BA problem's live edges
    (tests/test_ba_scale.py's metric)."""
    r = ba._reproj_terms(cam, p)[0]
    live = p.obs_mask & p.pt_valid[p.obs_pt.long()] & p.kf_valid[p.obs_kf.long()]
    e = torch.linalg.vector_norm(r[:, :2], dim=-1)
    return float(torch.sum(torch.where(live, e, 0.0)) / torch.sum(live))


def recentered(fields):
    """A BA problem ({field: numpy array}) with the world origin moved to
    its keyframes' mean camera center: the same problem in another gauge.
    Along the corridor the map's coordinates reach 1,000 m, where one f32
    step is 6e-5 m; here they are window-sized."""
    T = fields["kf_pose"].astype(np.float64)
    centers = -np.einsum("kji,kj->ki", T[:, :3, :3], T[:, :3, 3])
    m = centers[fields["kf_valid"]].mean(0)
    T[:, :3, 3] += np.einsum("kij,j->ki", T[:, :3, :3], m)
    obj = fields["obj_pose"].astype(np.float64)
    obj[:, :3, 3] -= m
    return dict(fields, kf_pose=T.astype(np.float32), pts=(fields["pts"] - m).astype(np.float32),
                obj_pose=obj.astype(np.float32))


def ba_scale_phase(dev, smi):
    """Phases 9b and 9c: bundle adjustment on the KITTI-00-scale corridor
    map (`tools/corridor_map.py`: 1,000 keyframes, 200,000 points, 200
    features per keyframe) on the card, held to tests/test_ba_scale.py's
    criteria, then the card against the CPU."""
    from dsp_slam_rgbd_tpu_torch.mapping import ba
    from dsp_slam_rgbd_tpu_torch.mapping import local_mapping as lm
    from dsp_slam_rgbd_tpu_torch.mapping import map_state as ms
    from dsp_slam_rgbd_tpu_torch.tools import corridor_map as cm
    from dsp_slam_rgbd_tpu_torch.weights import (ba_problem_from_numpy, ba_problem_to_numpy,
                                                 map_state_from_numpy)

    cam = cm.CAM
    rep = {"card": smi}
    t0 = time.perf_counter()
    fields, _, _ = cm.build_corridor_map()
    state = map_state_from_numpy(fields, dev)
    rep["build_s"] = time.perf_counter() - t0

    # ---- 9b. local BA at three places along the corridor, then one global
    # BA (matrix-free PCG) over the whole map
    local = []
    for center in (10, 500, 990):
        prob, _ = lm.build_local_ba_problem(state, center, max_kfs=10)
        B = prob.kf_pose.shape[0] + prob.obj_pose.shape[0]
        ms_ = wall_ms(lambda: ba.local_ba(cam, prob), 2)
        res = ba.local_ba(cam, prob)
        launches, busy = traced(lambda: ba.local_ba(cam, prob))
        before = mean_reproj(ba, cam, prob)
        after = mean_reproj(ba, cam, prob._replace(kf_pose=res.kf_pose, pts=res.pts))
        case = {"center": center, "B": B, "points": prob.pts.shape[0],
                "edges": int(prob.obs_mask.sum()), "ms": ms_, "launches": launches,
                "busy_ms": busy, "reproj_px_before": before, "reproj_px_after": after}
        local.append(case)
        check(B <= 64 and np.isfinite(after) and after < 0.7 * before, f"9b local BA {case}")
        print(f"phase 9b local BA at keyframe {center} of the corridor (1,000 KFs, 200,000 "
              f"points): B={B}, {case['points']} point slots, {case['edges']} edges; "
              f"reprojection {before:.3f} -> {after:.3f} px; {ms_:.1f} ms, {launches} launches, "
              f"busy {busy:.2f} ms on {smi}", flush=True)
    gprob, gidx = lm.build_local_ba_problem(state, 0, 0, global_window=True)
    B = gprob.kf_pose.shape[0] + gprob.obj_pose.shape[0]
    n_live = int(ms._obs_ok(state).sum())
    n_in = int(gprob.obs_mask.sum())
    ms_ = wall_ms(lambda: ba.global_ba_pcg(cam, gprob, n_iters=6), 1)
    res = ba.global_ba_pcg(cam, gprob, n_iters=6)
    launches, busy, top = traced(lambda: ba.global_ba_pcg(cam, gprob, n_iters=6), top=4)
    before = mean_reproj(ba, cam, gprob)
    after = mean_reproj(ba, cam, gprob._replace(kf_pose=res.kf_pose, pts=res.pts))
    state2 = lm.apply_ba_result(state, gidx, res)
    glob = {"B": B, "edges": n_in, "live_observations": n_live, "points": gprob.pts.shape[0],
            "ms": ms_, "launches": launches, "busy_ms": busy, "top_kernels": top,
            "reproj_px_before": before, "reproj_px_after": after}
    check(B >= 1000 and n_in == n_live > 150_000 and np.isfinite(after) and after < 0.5 * before
          and bool(torch.isfinite(state2.kf_pose).all()), f"9b global BA {glob}")
    rep.update(local_ba=local, global_ba_pcg=glob)
    print(f"phase 9b global BA (PCG, 6 LM iterations of 48 CG steps): B={B}, {n_in} edges "
          f"(every live observation), {glob['points']} point slots; reprojection {before:.3f} -> "
          f"{after:.3f} px; {ms_:.1f} ms, {launches} launches, busy {busy:.2f} ms; top: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in top) + f" on {smi}", flush=True)

    # ---- 9c. the card against the CPU: one LM step of each local problem,
    # and the dense-vs-PCG agreement on the 24-KF corridor
    cpu = torch.device("cpu")
    steps = []
    for center in (10, 500, 990):
        prob, _ = lm.build_local_ba_problem(state, center, max_kfs=10)
        case = {"center": center}
        for gauge, fields in (("map", ba_problem_to_numpy(prob)),
                              ("local", recentered(ba_problem_to_numpy(prob)))):
            card, _ = ba._assemble_and_solve(cam, ba_problem_from_numpy(fields, dev), 1e-3)
            host, _ = ba._assemble_and_solve(cam, ba_problem_from_numpy(fields, cpu), 1e-3)
            for k in ("kf_pose", "pts"):
                case[f"{gauge}_{k}"] = float((getattr(card, k).cpu() - getattr(host, k)).abs().max())
        steps.append(case)
        check(max(case["local_kf_pose"], case["local_pts"]) <= 1e-4,
              f"9c one LM step, card vs CPU at {center}: {case}")
    fields, _, centers = cm.build_corridor_map(n_kf=24, n_pts=2000, feat_per_kf=120, noise=0.2,
                                               max_kf=32, max_pts=4096)
    small, poses = {}, {}
    for where, d in (("card", dev), ("cpu", cpu)):
        prob, idx = lm.build_local_ba_problem(map_state_from_numpy(fields, d), 0, 0,
                                              global_window=True)
        res_d = ba.global_ba(cam, prob, n_iters=10)
        res_p = ba.global_ba_pcg(cam, prob, n_iters=10, cg_iters=64, damping=1e-3)
        kf = idx.kf_idx.cpu().numpy()
        ok = kf >= 0
        poses[where] = [r.kf_pose.cpu().numpy()[ok] for r in (res_d, res_p)]
        for name, pose in zip(("dense", "pcg"), poses[where]):
            e = float(np.linalg.norm(-pose[:, :3, 3] - centers[kf[ok]], axis=-1).max())
            small[f"{where}_{name}_max_err_m"] = e
            check(e < 0.03, f"9c 24-KF corridor {where} {name}: {e}")
        small[f"{where}_dense_vs_pcg"] = float(np.abs(poses[where][0] - poses[where][1]).max())
        check(small[f"{where}_dense_vs_pcg"] < 5e-3, f"9c dense vs PCG on the {where}: {small}")
    small["card_vs_cpu_dense"] = float(np.abs(poses["card"][0] - poses["cpu"][0]).max())
    small["card_vs_cpu_pcg"] = float(np.abs(poses["card"][1] - poses["cpu"][1]).max())
    check(max(small["card_vs_cpu_dense"], small["card_vs_cpu_pcg"]) < 5e-3,
          f"9c 24-KF corridor card vs CPU: {small}")
    rep.update(step_card_vs_cpu=steps, corridor24=small)
    print(f"phase 9c card vs CPU: one LM step (largest differences in the map's coordinates "
          f"and recentered) {steps}; 24-KF corridor {small} on {smi}", flush=True)
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", help="write the measured numbers to this JSON file")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from dsp_slam_rgbd_tpu_torch.models import deepsdf, mesh
    from dsp_slam_rgbd_tpu_torch.ops.cuda import build, mlp_sdf
    from dsp_slam_rgbd_tpu_torch.recon import optimizer as opt
    from dsp_slam_rgbd_tpu_torch.tools import ellipsoid

    dev = torch.device("cuda")
    report = {}

    # ---- 1. device
    smi = smi_line()
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    name = torch.cuda.get_device_name(0)
    print(f"phase 1 device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| nvcc {nvcc}", flush=True)
    peak_bf16, mem_bw = next(v for k, v in PEAKS.items() if k in name)

    # ---- 2. build
    t0 = time.perf_counter()
    build.load()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in build.ptxas_log.splitlines()
             if "registers" in ln or "spill" in ln]
    report["build"] = {"seconds": build_s, "ptxas": ptxas}
    print(f"phase 2 build: {build_s:.1f} s (nvcc {build.build_seconds} s); "
          f"{' / '.join(ptxas[:8])}", flush=True)
    cfgs = {}
    for kind, kernel, config in (("value", "mlp_sdf_value_tc_kernel", mlp_sdf.value_kernel_config),
                                 ("jacobian", "mlp_sdf_jacobian_tc_kernel",
                                  mlp_sdf.jacobian_kernel_config)):
        cfg_k = cfgs[kind] = config()
        n_hgmma = hgmma_count(build, kernel)
        check(n_hgmma > 0, f"HGMMA instructions in the bf16 {kind} kernel")
        check(cfg_k["local_bytes"] == 0, f"the bf16 {kind} kernel does not spill: {cfg_k}")
        report["build"][f"{kind}_kernel"] = dict(cfg_k, hgmma=n_hgmma)
        print(f"phase 2 bf16 {kind} kernel: {n_hgmma} HGMMA in its SASS; stage "
              f"{cfg_k['stage']}, {cfg_k['smem_bytes']} B shared memory per block, "
              f"{cfg_k['threads']} threads, {cfg_k['rows_per_block']} rows per block, "
              f"{cfg_k['registers']} registers, {cfg_k['local_bytes']} B local", flush=True)
    vcfg, jcfg = cfgs["value"], cfgs["jacobian"]

    # ---- 3. kernels vs plain versions at cars_64 width
    dec = deepsdf.init_decoder(deepsdf.DecoderSpec(), seed=0, device=dev)
    gen = np.random.default_rng(0)
    cases = []
    for n, per_row in ((300, False), (700, True)):
        code = torch.tensor(gen.standard_normal((n, 64) if per_row else 64) * 0.2,
                            dtype=torch.float32, device=dev)
        xyz = torch.tensor(gen.standard_normal((n, 3)) * 0.5, dtype=torch.float32,
                           device=dev)
        res = {}
        for dt in (torch.float32, torch.bfloat16):
            wb = dec.packed(dt)
            tag = f"n={n} {'per-row' if per_row else 'shared'} {dt}"
            v_k = mlp_sdf.sdf_value_fused(wb, code, xyz, dt, dec.value_tiles)
            if dt == torch.float32:
                s_k, g_k = mlp_sdf.sdf_and_input_jacobian_fused(wb, code, xyz, dt)
                s_p, g_p = mlp_sdf.sdf_and_input_jacobian_plain(wb, code, xyz, dt)
                torch.cuda.synchronize()
                for t in (s_k, g_k):
                    check(bool(torch.isfinite(t).all()), f"{tag}: finite kernel output")
                keep = mlp_sdf.relu_margin(wb, code, xyz) >= TIE
                check(float(keep.float().mean()) >= 0.9, f"{tag}: <=10% near-tie rows")
                e_g = float((g_k - g_p)[keep].abs().max())
                case = {"case": tag, "sdf_err": float((s_k - s_p).abs().max()), "jac_err": e_g}
                check(case["sdf_err"] <= SDF_ATOL and e_g <= JAC_ATOL, f"{tag}: {case}")
            else:
                s_k, g_k, _, case = hold_bf16_jacobian(mlp_sdf, wb, dec.jacobian_tiles, code,
                                                       xyz, tag)
                s_p = mlp_sdf.sdf_value_plain(wb, code, xyz, dt)
            check(bool(torch.isfinite(v_k).all()), f"{tag}: finite value kernel output")
            e_v = float((v_k - s_p).abs().max())
            check(e_v <= (SDF_ATOL if dt == torch.float32 else BF16_SDF_ATOL),
                  f"{tag}: value kernel sdf {e_v}")
            case["value_sdf_err"] = e_v
            res[dt] = g_k
            cases.append(case)
        jf, jb = res[torch.float32], res[torch.bfloat16]
        cos = (jf * jb).sum(1) / (jf.norm(dim=1) * jb.norm(dim=1) + 1e-12)
        check(float(cos.min()) >= 0.90 and frob_rel(jb, jf) <= 0.25,
              f"n={n}: bf16 vs f32 cos {float(cos.min())} frob {frob_rel(jb, jf)}")
        cases.append({"case": f"n={n} bf16 vs f32", "cos_min": float(cos.min()),
                      "frob": frob_rel(jb, jf)})
    # the bf16 value kernel at ragged sizes and every code form, random weights
    bf = torch.bfloat16
    for n in VALUE_ROWS:
        for form, code, xyz in code_forms(n, gen, dev):
            v_k = mlp_sdf.sdf_value_fused(dec.packed(bf), code, xyz, bf, dec.value_tiles)
            v_p = mlp_sdf.sdf_value_plain(dec.packed(bf), code, xyz, bf)
            torch.cuda.synchronize()
            tag = f"value n={n} {form} bf16"
            check(v_k.shape == v_p.shape and bool(torch.isfinite(v_k).all()),
                  f"{tag}: finite kernel output of the plain version's shape")
            e_s = float((v_k - v_p).abs().max())
            check(e_s <= BF16_SDF_ATOL, f"{tag}: sdf {e_s}")
            cases.append({"case": tag, "sdf_err": e_s})
    # the bf16 Jacobian kernel likewise
    for n in JAC_ROWS:
        for form, code, xyz in code_forms(n, gen, dev):
            cases.append(hold_bf16_jacobian(mlp_sdf, dec.packed(bf), dec.jacobian_tiles, code,
                                            xyz, f"jacobian n={n} {form} bf16")[3])
    report["kernel_vs_plain"] = cases
    print("phase 3 kernels vs plain: " + "; ".join(
        f"{c['case']}: " + ", ".join(f"{k} {v:.3g}" for k, v in c.items() if k != "case")
        for c in cases), flush=True)

    # ---- 4. the main path: batched reconstruction, bench.py's shapes
    fixture = deepsdf.load_npz(FIXTURE, device=dev)
    probs = [ellipsoid.make_problem(100 + i, N_PTS, N_RAYS) for i in range(B)]

    def stack(k, dtype=None):
        return torch.tensor(np.stack([p[k] for p in probs]), dtype=dtype, device=dev)

    args = (stack("T_init"), stack("pts"), torch.ones(B, N_PTS, dtype=torch.bool, device=dev),
            stack("rays"), torch.ones(B, N_RAYS, dtype=torch.bool, device=dev),
            stack("depth"), stack("fg_mask"))
    cfg = opt.ReconConfig.gpu_fast(num_iterations=ITERS)

    def fit():
        return opt.reconstruct_objects_batched(fixture, cfg, *args,
                                               compute_dtype=opt.FAST_DTYPE)

    mlp_sdf.reset_launch_counts()
    out = fit()
    torch.cuda.synchronize()
    launches = dict(mlp_sdf.LAUNCHES)
    check(all(v > 0 for v in launches.values()), f"both kernels on the main path: {launches}")
    check(bool(out.is_good.all()), f"every fit is_good: {out.is_good.tolist()}")
    check(bool(torch.isfinite(out.t_cam_obj).all()), "finite poses")
    T_fit = out.t_cam_obj.cpu().numpy()
    err0 = np.mean([ellipsoid.pose_errors(p["T_init"], p)[0] for p in probs])
    errs = np.array([ellipsoid.pose_errors(T_fit[i], p) for i, p in enumerate(probs)])
    check(errs[:, 0].mean() < err0, f"mean translation error {errs[:, 0].mean()} < {err0}")
    reps = 3
    fit()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fit()
    torch.cuda.synchronize()
    fit_s = (time.perf_counter() - t0) / reps
    prof = profile_fit(fit, fit_s * 1e3)
    report["main_path"] = {
        "launches": launches, "fits_per_s": B / fit_s, "batch_s": fit_s,
        "t_err_init_mean": float(err0), "errors_mean": errs.mean(0).tolist(),
        "profile": prof, "card": smi}
    print(f"phase 4 main path: B={B} pts={N_PTS} rays={N_RAYS} iters={ITERS} gpu_fast bf16: "
          f"launches {launches}; mean t_err {err0:.4f} -> {errs[:, 0].mean():.4f} m, "
          f"s_err {errs[:, 1].mean():.4f}, r_err {errs[:, 2].mean():.2f} deg; "
          f"{B / fit_s:.2f} fits/s ({fit_s * 1e3:.1f} ms/batch) on {smi}", flush=True)
    print(f"phase 4 profile (one traced fit): traced wall {prof['traced_wall_ms']:.1f} ms, busy "
          f"{prof['busy_ms']:.1f} ms (idle share {prof['idle_share']:.3f}), mlp_sdf kernels "
          f"{prof['mlp_sdf_ms']:.1f} ms, {prof['n_kernels']} kernel launches; top: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in prof["top"]), flush=True)

    # ---- 5. f32 parity: one GN iteration, kernels (card) vs plain (CPU)
    rng = np.random.default_rng(3)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.0, 0.0, 6.0]
    pts = (rng.standard_normal((64, 3)) * 0.4 + [0, 0, 6.0]).astype(np.float32)
    rays = (rng.standard_normal((32, 3)) * 0.03 + [0, 0, 1.0]).astype(np.float32)
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    one = (T, pts, np.ones(64, bool), rays, np.ones(32, bool), np.full(32, 6.0, np.float32),
           np.ones(32, bool))
    cfg1 = opt.ReconConfig(num_iterations=1, num_depth_samples=12, max_grad_points=256,
                           max_valid_samples=512)
    r_k = opt.reconstruct_object(dec, cfg1, *(torch.tensor(a, device=dev) for a in one))
    r_p = opt.reconstruct_object(deepsdf.init_decoder(deepsdf.DecoderSpec(), seed=0, device="cpu"),
                                 cfg1, *(torch.tensor(a) for a in one))
    e_t = float((r_k.t_cam_obj.cpu() - r_p.t_cam_obj).abs().max())
    e_c = float((r_k.code.cpu() - r_p.code).abs().max())
    check(e_t <= 2e-3 and e_c <= 2e-3 and bool(r_k.is_good) == bool(r_p.is_good),
          f"f32 parity pose {e_t} code {e_c}")
    report["f32_parity"] = {"pose_err": e_t, "code_err": e_c}
    print(f"phase 5 f32 parity (1 GN iteration, card kernels vs CPU plain): pose {e_t:.3g} "
          f"code {e_c:.3g}", flush=True)

    # ---- 6. mesh from one fitted code (64^3 decode through the value kernel)
    m = mesh.MeshExtractor(fixture).extract_mesh_from_code(out.code[0])
    nv, nf = len(m["vertices"]), len(m["faces"])
    check(nv > 0 and nf > 0, f"mesh {nv} vertices {nf} faces")
    report["mesh"] = {"vertices": nv, "faces": nf}
    print(f"phase 6 mesh: {nv} vertices, {nf} faces", flush=True)

    # ---- 7. kernel times at the main path's shapes (bf16, as gpu_fast runs)
    wb = fixture.packed(bf)
    w0, W, _ = wb
    fwd_macs = sum(i * o for i, o in fixture.spec.layer_dims())
    w_bytes = sum(t.numel() * t.element_size() for t in wb)

    def timing(kind, rows, n_obj):
        # object codes and points near their ellipsoid surfaces, where
        # tanh is not saturated and the Jacobian is not 0
        g = np.random.default_rng(rows)
        code_np = g.standard_normal((n_obj, 64))
        dirs = g.standard_normal((n_obj, rows // n_obj, 3))
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        xyz_np = (dirs * ellipsoid.code_to_axes(code_np)[:, None]
                  * g.uniform(0.8, 1.2, dirs.shape[:2] + (1,)))
        code = torch.tensor(code_np, dtype=torch.float32, device=dev)
        xyz = torch.tensor(xyz_np, dtype=torch.float32, device=dev)
        jac = kind == "jacobian"
        kern = (functools.partial(mlp_sdf.sdf_and_input_jacobian_fused,
                                  tiles=fixture.jacobian_tiles) if jac else
                functools.partial(mlp_sdf.sdf_value_fused, tiles=fixture.value_tiles))
        plain = mlp_sdf.sdf_and_input_jacobian_plain if jac else mlp_sdf.sdf_value_plain
        # held to the bf16 tolerances at the main path's shapes
        if jac:
            _, g_k, g_m, _ = hold_bf16_jacobian(mlp_sdf, wb, fixture.jacobian_tiles, code, xyz,
                                                f"jacobian at {rows} rows")
            err = float((g_k - g_m).abs().max())
        else:
            err = float((kern(wb, code, xyz, bf) - plain(wb, code, xyz, bf)).abs().max())
            check(err <= BF16_SDF_ATOL, f"value at {rows} rows: sdf {err}")
        rand = torch.Generator(device=dev).manual_seed(rows)
        x = torch.randn(rows, 128, device=dev, dtype=bf, generator=rand)
        h = torch.randn(rows, 512, device=dev, dtype=bf, generator=rand)

        def library():       # the same products, one torch.matmul each
            torch.matmul(x, w0)
            for i in range(8):
                torch.matmul(h, W[i])
            if jac:
                for i in range(8):
                    torch.matmul(h, W[i].T)

        ms = cuda_ms(lambda: kern(wb, code, xyz, bf), 20)
        plain_ms = cuda_ms(lambda: plain(wb, code, xyz, bf), 5)
        library_ms = cuda_ms(library, 20)
        flops = 2.0 * fwd_macs * rows * (2 if jac else 1)
        io = w_bytes + code.numel() * 4 + xyz.numel() * 4 + rows * 4 * (1 + (67 if jac else 0))
        t_ops, t_bytes = flops / peak_bf16 * 1e3, io / mem_bw * 1e3
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "max_abs_err": err, "rows": rows, "dtype": "bf16",
                "tflops": flops / ms / 1e9}

    t_val = timing("value", B * N_RAYS * cfg.coarse_samples, B)
    t_jac = timing("jacobian", B * cfg.max_grad_points, B)
    t_jac_sdf = timing("jacobian", B * N_PTS, B)
    # every block of the value kernel streams the whole packed weight stack from L2
    blocks = -(-t_val["rows"] // vcfg["rows_per_block"])
    t_val["l2_bytes"] = blocks * mlp_sdf.VALUE_STAGES * mlp_sdf.VALUE_STAGE_BYTES
    t_val["l2_tb_per_s"] = t_val["l2_bytes"] / t_val["ms"] / 1e9
    t_val.update({k: vcfg[k] for k in ("stage", "smem_bytes", "registers")})
    # every block of the Jacobian kernel streams both weight streams, one
    # stage after another: at these sizes (one wave) the chain sets the time
    jac_stages = mlp_sdf.VALUE_STAGES + mlp_sdf.BACKWARD_STAGES + mlp_sdf.W0T_STAGES
    for t in (t_jac, t_jac_sdf):
        t.update({k: jcfg[k] for k in ("stage", "smem_bytes", "registers")})
        blocks = -(-t["rows"] // jcfg["rows_per_block"])
        t["l2_bytes"] = blocks * (mlp_sdf.VALUE_STAGES * mlp_sdf.VALUE_STAGE_BYTES
                                  + mlp_sdf.BACKWARD_BYTES)
        t["l2_tb_per_s"] = t["l2_bytes"] / t["ms"] / 1e9
        t["us_per_stage"] = t["ms"] * 1e3 / jac_stages
    report["timing"] = {"value": t_val, "jacobian_render": t_jac, "jacobian_sdf": t_jac_sdf,
                        "card": smi}
    for label, t in (("value", t_val), ("jacobian render", t_jac),
                     ("jacobian sdf", t_jac_sdf)):
        print(f"phase 7 timing {label}: rows {t['rows']} kernel {t['ms']:.3f} ms "
              f"({t['tflops']:.1f} TFLOP/s), plain {t['plain_ms']:.3f} ms, torch.matmul "
              f"{t['library_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
              f"max_abs_err {t['max_abs_err']:.3g} on {smi}", flush=True)
    print(f"phase 7 value kernel: stage {t_val['stage']}, {t_val['smem_bytes']} B shared "
          f"memory per block, {t_val['registers']} registers; weight stream from L2 "
          f"{t_val['l2_bytes'] / 1e9:.3f} GB per launch = {t_val['l2_tb_per_s']:.2f} TB/s",
          flush=True)
    print(f"phase 7 jacobian kernel: stage {jcfg['stage']}, {jcfg['smem_bytes']} B shared "
          f"memory per block, {jcfg['registers']} registers; weight streams from L2 "
          + ", ".join(f"{t['l2_bytes'] / 1e9:.3f} GB = {t['l2_tb_per_s']:.2f} TB/s, "
                      f"{t['us_per_stage']:.3f} us per stage at {t['rows']} rows"
                      for t in (t_jac, t_jac_sdf)), flush=True)
    # ---- 8 / 9a. per-frame tracking and the keyframe stage at KITTI size
    report["tracking"] = tracking_phase(dev, smi)
    # ---- 9b / 9c. bundle adjustment at KITTI-00 scale, and card vs CPU
    t0 = time.perf_counter()
    report["ba_scale"] = ba_scale_phase(dev, smi)
    print(f"phase 9b-9c took {time.perf_counter() - t0:.0f} s", flush=True)

    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "rows", "dtype")
    kernels = [
        dict(name="mlp_sdf_value", route="cuda",
             source="dsp_slam_rgbd_tpu_torch/csrc/mlp_sdf_value_tc.cu",
             replaces="dsp_slam_rgbd_tpu/ops/pallas/mlp_sdf.py:237",
             **{k: v for k, v in dict(t_val, launches=launches["mlp_sdf_value"]).items()
                if k in keys}),
        dict(name="mlp_sdf_jacobian", route="cuda",
             source="dsp_slam_rgbd_tpu_torch/csrc/mlp_sdf_jacobian_tc.cu",
             replaces="dsp_slam_rgbd_tpu/ops/pallas/mlp_sdf.py:159",
             **{k: v for k, v in dict(t_jac, launches=launches["mlp_sdf_jacobian"]).items()
                if k in keys},
             # the main path's other Jacobian launch size (the SDF term)
             small={k: v for k, v in t_jac_sdf.items() if k in keys}),
    ]
    if opts.report:
        os.makedirs(os.path.dirname(os.path.abspath(opts.report)), exist_ok=True)
        with open(opts.report, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
