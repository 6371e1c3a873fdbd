"""Whole-pipeline FPS benchmark: tracking and the keyframe stages interleaved.

Counterpart of `tools/bench_pipeline.py`.  The reference's end-to-end
envelope is ~10 FPS for the whole system: per frame ORB extraction, stereo
matching and two motion-only pose fits, plus, at keyframe rate, map
maintenance, object reconstruction and local BA (`README.md:3`,
`dsp_slam.cc:109-118`).  This runs the port's system loop
(`SLAMSystem.track_frame` on frames from `system/prefetch.FramePrefetcher`,
one object detection a frame) over a synthetic tilted-plane stereo
sequence at KITTI size and reports the frames per second of the median
pass, with the tracking-only and keyframe frames' median times apart.

The world is `bench_pipeline.py`'s: a seeded 4,096² texture on a tilted
plane, 0.35 m a frame, `SystemConfig` with `OrbConfig()` (2,000 features,
8 levels), `ReconConfig.gpu_fast()`, at most 5 frames between keyframes
and its `MapConfig`; the detections take the same `default_rng(0)` draws
in the same order.  At another image size the focal length scales with
the width, so the view stays the same.  The decoder is the trained
fixture (cars_64 layout; random weights make the fit diverge).

Rendering happens up front and is not timed.  One untimed pass over the
whole sequence warms every path; each timed pass starts from a fresh map
(`SLAMSystem.reset`) and ends after `flush` and a `torch.cuda.synchronize()`.

Usage:
  python -m dsp_slam_rgbd_tpu_torch.tools.bench_pipeline [--frames 36] \
      [--passes 3] [--size 376 1241] [--pipelined] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from dsp_slam_rgbd_tpu_torch.tools.bench import drain
from dsp_slam_rgbd_tpu_torch.tools.ellipsoid import FIXTURE

H, W = 376, 1241          # KITTI odometry image size
FX = 718.856              # at width W
BASELINE = 0.537          # KITTI stereo baseline (m)
PLANE_Z = 18.0
PLANE_TILT = 0.3
STEP = 0.35               # forward motion a frame (m)


def render(texture: np.ndarray, cam_x: float, hw=(H, W), tex_scale: float = 40.0) -> np.ndarray:
    """The textured tilted plane seen from camera x = cam_x, (H, W) f32."""
    from scipy.ndimage import map_coordinates

    h, w = hw
    fx = FX * w / W
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    dx = (u - w / 2) / fx
    dy = (v - h / 2) / fx
    t = (PLANE_Z + PLANE_TILT * cam_x) / (1.0 - PLANE_TILT * dx)
    X = cam_x + dx * t
    Y = dy * t
    tx = X * tex_scale / 10.0 + texture.shape[1] / 2
    ty = Y * tex_scale / 10.0 + texture.shape[0] / 2
    return map_coordinates(texture, [ty, tx], order=1, mode="wrap").astype(np.float32)


def run(frames: int = 36, warmup: int = 6, passes: int = 3, pipelined: bool = False,
        hw=(H, W), decoder_path: str = FIXTURE, device="cuda") -> dict:
    """The benchmark's result dict (also the `pipeline_*` keys of
    `tools/bench.py`).  `warmup` is kept for `bench_pipeline.py`'s
    signature: as there, the warm-up is one whole pass."""
    from scipy.ndimage import gaussian_filter

    from dsp_slam_rgbd_tpu_torch import device as device_mod
    from dsp_slam_rgbd_tpu_torch.config import MapConfig, SystemConfig, TrackingConfig
    from dsp_slam_rgbd_tpu_torch.frontend.orb import OrbConfig
    from dsp_slam_rgbd_tpu_torch.models import deepsdf
    from dsp_slam_rgbd_tpu_torch.ops import camera as cam_ops
    from dsp_slam_rgbd_tpu_torch.recon.optimizer import ReconConfig
    from dsp_slam_rgbd_tpu_torch.system.detections import make_detection
    from dsp_slam_rgbd_tpu_torch.system.prefetch import FramePrefetcher
    from dsp_slam_rgbd_tpu_torch.system.slam import SLAMSystem

    dev = device_mod.resolve(device)
    h, w = hw
    fx = FX * w / W
    cam = cam_ops.Intrinsics(fx=fx, fy=fx, cx=w / 2, cy=h / 2, bf=fx * BASELINE)
    cfg = SystemConfig(
        sensor="stereo", cam=cam, orb=OrbConfig(), recon=ReconConfig.gpu_fast(),
        tracking=TrackingConfig(fps=10.0, th_depth=35.0, max_frames_between_kf=5,
                                pipelined=pipelined),
        map=MapConfig(max_kf=48, max_feat=2048, max_pts=32768, max_obj=8, max_oobs=256,
                      local_window=8))
    system = SLAMSystem(cfg, decoder=deepsdf.load_npz(decoder_path, device=dev), device=dev)

    print("rendering synthetic sequence...", flush=True)
    rng = np.random.default_rng(0)
    texture = gaussian_filter(rng.uniform(0, 255, (4096, 4096)), 1.2).astype(np.float32)
    seq = []
    for i in range(frames):
        x = i * STEP
        seq.append((np.clip(render(texture, x, hw), 0, 255).astype(np.uint8),
                    np.clip(render(texture, x + BASELINE, hw), 0, 255).astype(np.uint8)))

    det_t_co_w = np.eye(4, dtype=np.float32)
    det_t_co_w[:3, 3] = [2.0, 0.5, 14.0]

    def dets_for(i):
        t_cw = np.eye(4, dtype=np.float32)
        t_cw[0, 3] = -i * STEP
        t_co = t_cw @ det_t_co_w
        d = rng.standard_normal((200, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        pts_cam = (d * 0.8) @ t_co[:3, :3].T + t_co[:3, 3]
        vis = pts_cam[pts_cam[:, 2] > 0][:128]
        depths = np.linalg.norm(vis, axis=1)
        rays = vis / depths[:, None]
        return [make_detection(t_co, pts=pts_cam, rays=rays, depth=depths, n_fg=len(rays))]

    def frames_of():
        return FramePrefetcher(system.tracker, iter(seq), sensor="stereo", depth=2)

    try:
        print("warmup pass...", flush=True)
        for i, frame in enumerate(frames_of()):
            system.track_frame(frame, detections=dets_for(i))
        system.flush()
        drain(dev)

        results = []
        for p in range(max(passes, 1)):
            print(f"timed pass {p + 1}/{passes}...", flush=True)
            system.reset()
            t_frames = []
            t_pass0 = time.perf_counter()
            for i, frame in enumerate(frames_of()):
                t0 = time.perf_counter()
                out = system.track_frame(frame, detections=dets_for(i))
                if system.tracker._stage_stats is None:
                    drain(dev)   # before tracking starts no stats read ends the frame
                t_frames.append((time.perf_counter() - t0, out["new_kf"]))
            system.flush()
            drain(dev)
            results.append((len(t_frames) / (time.perf_counter() - t_pass0), t_frames))
        n_kf_total = system.n_kf
        objects = int(system.state.obj_valid.sum())
    finally:
        system.shutdown()

    results.sort(key=lambda r: r[0])
    fps, t_frames = results[len(results) // 2]   # the median pass
    kf_frames = [d for d, k in t_frames if k]
    tr_frames = [d for d, k in t_frames if not k]
    return {
        "metric": "pipeline_fps",
        "value": fps,
        "unit": f"frames/s ({w}x{h} stereo, full system loop)",
        "vs_baseline": fps / 10.0,
        "frames": len(t_frames),
        "keyframes": len(kf_frames),
        "track_only_ms": 1e3 * float(np.median(tr_frames)) if tr_frames else None,
        "kf_frame_ms": 1e3 * float(np.median(kf_frames)) if kf_frames else None,
        # the keyframe stage runs on the mapping worker, so its work drains
        # into later frames' wall time: the per-frame split is approximate,
        # the pass's fps exact
        "split_note": "per-frame split approximate (async KF worker)",
        "passes_fps": [r[0] for r in results],
        "n_kf_total": n_kf_total,
        "objects": objects,
        "decoder": os.path.relpath(os.path.abspath(decoder_path)),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=36)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--pipelined", action="store_true",
                    help="one-frame pipelined tracking (TrackingConfig.pipelined)")
    ap.add_argument("--size", type=int, nargs=2, default=(H, W), metavar=("H", "W"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.frames, passes=args.passes, pipelined=args.pipelined, hw=tuple(args.size),
              device=args.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
