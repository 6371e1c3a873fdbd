"""Per-frame tracking hot-path benchmark on the card.

Counterpart of `tools/bench_tracking.py`: the reference's per-frame
envelope (SURVEY.md §6) at KITTI image size, 376×1241: ORB extraction of
both images (`OrbConfig()`: 2,000 features, 8 levels), stereo matching
along the rows, and two robust motion-only pose fits over 1,200 points
(the second as TrackLocalMap's, `Tracking.cc:1012`).  The reference runs
this at ~10 FPS on an RTX 2080/3080 (`README.md:3`).

The JAX bench compiles the frame into one program; the port runs it op by
op, as its tracker does.  One warm-up frame, then `--frames` frames
chained through the pose, timed on the host clock between
`torch.cuda.synchronize()` calls.  On the card it first prints (not as
JSON) the kernel launches of one frame, counted by `torch.profiler`.
Then ONE JSON line: fps, ms a frame, and fps over the 10 FPS baseline.

Usage:
  python -m dsp_slam_rgbd_tpu_torch.tools.bench_tracking [--size 376 1241] \
      [--features 2000] [--frames 30] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from dsp_slam_rgbd_tpu_torch.tools.bench import drain


def frame_launches(fn) -> int:
    """CUDA kernels launched by one call of fn (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in p.events() if e.device_type == DeviceType.CUDA)


def main(argv=None):
    """Prints the JSON line; returns (that line as a dict, the launches of
    one frame, None on the CPU)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, nargs=2, default=(376, 1241), metavar=("H", "W"))
    ap.add_argument("--features", type=int, default=2000)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from dsp_slam_rgbd_tpu_torch import device as device_mod
    from dsp_slam_rgbd_tpu_torch.frontend import orb
    from dsp_slam_rgbd_tpu_torch.frontend import stereo as stereo_mod
    from dsp_slam_rgbd_tpu_torch.ops.camera import Intrinsics
    from dsp_slam_rgbd_tpu_torch.solvers import pose_gn

    dev = device_mod.resolve(args.device)
    H, W = args.size
    cfg = orb.OrbConfig(n_features=args.features)
    bf = 386.1448
    cam = Intrinsics(fx=718.856, fy=718.856, cx=607.19, cy=185.22, bf=bf)

    rng = np.random.default_rng(0)
    base = np.abs(rng.standard_normal((H, W)).astype(np.float32)) * 80.0 + 40.0
    # textured image pair (the content does not change the work: every shape is fixed)
    img_l = torch.as_tensor(base, device=dev)
    img_r = torch.as_tensor(np.roll(base, 8, axis=1), device=dev)
    n_pts = 1200   # typical tracked points a frame
    pts_w = torch.as_tensor(rng.standard_normal((n_pts, 3)) * 5 + [0, 0, 15],
                            dtype=torch.float32, device=dev)
    obs = torch.as_tensor(rng.uniform(0, 1, (n_pts, 3)) * [W, H, W], dtype=torch.float32,
                          device=dev)
    inv_s2 = torch.ones(n_pts, device=dev)
    valid = torch.ones(n_pts, dtype=torch.bool, device=dev)

    def frame_step(t0):
        fl = orb.extract(img_l, cfg, device=dev)
        fr = orb.extract(img_r, cfg, device=dev)
        sm = stereo_mod.match_stereo(fl, fr, img_l, img_r, bf, min_z=bf / cam.fx)
        t1 = pose_gn.optimize_pose(cam, t0, pts_w, obs, inv_s2, valid, stereo=True).t_cw
        t2 = pose_gn.optimize_pose(cam, t1, pts_w, obs, inv_s2, valid, stereo=True).t_cw
        # fold a frontend value in, so that the pose depends on every stage
        chk = (fl.desc[:, 0].sum() + fr.desc[:, 0].sum()).float() * 1e-12 \
            + sm.u_right.sum() * 1e-12
        return t2 + chk * 0.0

    eye = torch.eye(4, device=dev)
    frame_step(eye)
    drain(dev)
    launches = None
    if dev.type == "cuda":
        launches = frame_launches(lambda: frame_step(eye))
        print(f"launches of one frame: {launches}", flush=True)
    t = eye
    t0 = time.perf_counter()
    for _ in range(args.frames):
        t = frame_step(t)
    drain(dev)
    dt = (time.perf_counter() - t0) / args.frames
    if not bool(torch.isfinite(t).all()):
        raise RuntimeError("non-finite pose after the timed frames")
    out = {"metric": "kitti_frame_tracking_fps", "value": 1.0 / dt, "unit": "frames/s",
           "per_frame_ms": dt * 1e3, "vs_baseline": 1.0 / dt / 10.0}
    print(json.dumps(out), flush=True)
    return out, launches


if __name__ == "__main__":
    main()
