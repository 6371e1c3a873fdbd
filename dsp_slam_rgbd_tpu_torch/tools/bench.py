"""Benchmark: object reconstructions per second on the card.

Counterpart of the repo's `bench.py`: the joint Sim(3)+code Gauss-Newton
fit at the reference's KITTI budget (`configs/config_kitti.json`: 10 GN
iterations, 64-d code, 50 depth samples a ray, ≤ 250 LiDAR surface points,
~450 rays) with the cars_64 decoder, batched: B = 8 objects, 256 surface
points, 512 rays, `ReconConfig.gpu_fast()` in bf16
(`recon/optimizer.reconstruct_objects_batched`, the bf16 value and
Jacobian kernels).

The weights are the trained fixture `tests/fixtures/ellipsoid_decoder_64.npz`
(cars_64 layout), not random ones: on random weights the GN loop diverges
chaotically.  Its path is in the output.  The objects are observations of
the fixture's family (`make_batch`, chip_smoke.py phase 4's problems), not
`bench.py`'s random point blob: fitted with the fixture, the blob's fits
diverge (scales past 1e7) and some end not `is_good`.

One warm-up call, then `--reps` calls chained through the pose (a
non-finite pose restarts from the initial one, as in `bench.py`), timed on
the host clock between `torch.cuda.synchronize()` calls.  `mfu` is the
FLOP model's rate (`flops_per_recon`, `bench.py`'s model) over the card's
dense bf16 peak, for the cards in `PEAK_BF16`; null elsewhere.

Baseline: the reference runs the whole pipeline at ~10 FPS on an RTX
2080/3080 (`README.md:3`) with at most one object fit a keyframe: 10 fits
a second is the reference envelope.

Then, unless `--pipeline-frames 0`, the whole-pipeline bench
(`tools/bench_pipeline.run`) adds its `pipeline_*` keys; a failure there
fails the bench.  Prints ONE JSON line.

Usage:
  python -m dsp_slam_rgbd_tpu_torch.tools.bench [--objects 8 --points 256 \
      --rays 512 --iterations 10 --reps 10 --decoder FIXTURE] \
      [--pipeline-frames 36] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from dsp_slam_rgbd_tpu_torch.tools.ellipsoid import FIXTURE

BASELINE_RECON_PER_S = 10.0
# dense bf16 tensor-core FLOP/s by device name (NVIDIA data sheets); the
# first key found in `torch.cuda.get_device_name()` wins
PEAK_BF16 = {"H100 PCIe": 756e12, "H200": 989e12, "H100": 989e12}


def flops_per_recon(spec, cfg, n_pts: int, n_rays: int) -> tuple[float, float]:
    """(FLOPs one fit executes, FLOPs of the reference's dense budget for the
    same fit), `bench.py`'s model.  A decoder forward costs 2·Σ in·out a
    point; a value-and-Jacobian sweep ~3 forwards.  The value pass covers
    both phases (coarse iterations at `coarse_samples` over every ray, fine
    ones at `num_depth_samples` over the active rays); each iteration adds
    the render Jacobian over `max_grad_points`, the SDF term over the
    surface points and the 71-wide normal-equation assembly."""
    f_fwd = sum(2 * i * o for i, o in spec.layer_dims())
    M = cfg.num_depth_samples
    K_grad = cfg.max_grad_points
    D = 7 + cfg.code_len
    nc = min(cfg.coarse_iterations, cfg.num_iterations) if cfg.coarse_samples > 0 else 0
    r_fine = int(np.ceil(n_rays * cfg.active_ray_fraction)) if nc > 0 else n_rays
    value_pts = nc * n_rays * cfg.coarse_samples + (cfg.num_iterations - nc) * r_fine * M
    per_iter = 3 * K_grad * f_fwd + 3 * n_pts * f_fwd + 2 * (K_grad + n_pts) * D * D
    flops = value_pts * f_fwd + cfg.num_iterations * per_iter
    ref_budget = cfg.num_iterations * (n_rays * M * f_fwd + per_iter)
    return float(flops), float(ref_budget)


def make_batch(n_obj: int, n_pts: int, n_rays: int, code_len: int, device) -> dict:
    """`n_obj` seeded observations of the fixture's ellipsoid family
    (`tools/ellipsoid.make_problem(100 + i)`, chip_smoke.py phase 4's
    problems): an object 8 m ahead at scale 2, its surface points, 3/4
    foreground rays with their depths, and a perturbed initial pose."""
    from dsp_slam_rgbd_tpu_torch.tools import ellipsoid

    probs = [ellipsoid.make_problem(100 + i, n_pts, n_rays) for i in range(n_obj)]

    def on(k):
        return torch.as_tensor(np.stack([p[k] for p in probs]), device=device)

    return {"t_cam_obj": on("T_init"), "pts": on("pts"),
            "pts_mask": torch.ones(n_obj, n_pts, dtype=torch.bool, device=device),
            "rays": on("rays"), "ray_mask": torch.ones(n_obj, n_rays, dtype=torch.bool,
                                                       device=device),
            "depth_obs": on("depth"), "fg_mask": on("fg_mask"),
            "code_init": torch.zeros(n_obj, code_len, device=device)}


def drain(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    """Prints the JSON line; returns (that line as a dict, the last timed
    call's ReconResult)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--objects", type=int, default=8)
    ap.add_argument("--points", type=int, default=256)
    ap.add_argument("--rays", type=int, default=512)
    ap.add_argument("--iterations", type=int, default=10, help="GN iterations a fit")
    ap.add_argument("--reps", type=int, default=10, help="timed calls")
    ap.add_argument("--decoder", default=FIXTURE)
    ap.add_argument("--pipeline-frames", type=int, default=36,
                    help="frames of the whole-pipeline bench (0: not run)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from dsp_slam_rgbd_tpu_torch import device as device_mod
    from dsp_slam_rgbd_tpu_torch.models import deepsdf
    from dsp_slam_rgbd_tpu_torch.recon.optimizer import (
        FAST_DTYPE,
        ReconConfig,
        reconstruct_objects_batched,
    )

    dev = device_mod.resolve(args.device)
    decoder = deepsdf.load_npz(args.decoder, device=dev)
    cfg = ReconConfig.gpu_fast(num_iterations=args.iterations)
    B = args.objects
    batch = make_batch(B, args.points, args.rays, cfg.code_len, dev)
    t_batch = batch["t_cam_obj"]
    rest = [batch[k] for k in ("pts", "pts_mask", "rays", "ray_mask", "depth_obs", "fg_mask",
                               "code_init")]

    def step(t):
        res = reconstruct_objects_batched(decoder, cfg, t, *rest, compute_dtype=FAST_DTYPE)
        return torch.where(torch.isfinite(res.t_cam_obj).all(), res.t_cam_obj, t_batch), res

    step(t_batch)
    drain(dev)
    x = t_batch
    t0 = time.perf_counter()
    for _ in range(args.reps):
        x, res = step(x)
    drain(dev)
    recon_per_s = B * args.reps / (time.perf_counter() - t0)

    flops_obj, flops_ref = flops_per_recon(decoder.spec, cfg, args.points, args.rays)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    peak = next((v for k, v in PEAK_BF16.items() if k in kind), None)
    model_tflops = flops_obj * recon_per_s / 1e12
    out = {
        "metric": "kitti_budget_object_reconstructions_per_s",
        "value": recon_per_s,
        "unit": "reconstructions/s",
        "vs_baseline": recon_per_s / BASELINE_RECON_PER_S,
        "model_tflops": model_tflops,
        "mfu": model_tflops * 1e12 / peak if peak else None,
        "device_kind": kind,
        "flops_per_recon_g": flops_obj / 1e9,
        "ref_budget_flops_per_recon_g": flops_ref / 1e9,
    }
    if args.pipeline_frames > 0:
        from dsp_slam_rgbd_tpu_torch.tools import bench_pipeline

        p = bench_pipeline.run(frames=args.pipeline_frames, decoder_path=args.decoder,
                               device=dev)
        out["pipeline_fps"] = p["value"]
        out["pipeline_track_only_ms"] = p["track_only_ms"]
        out["pipeline_kf_frame_ms"] = p["kf_frame_ms"]
        out["pipeline_passes_fps"] = p["passes_fps"]
    out["decoder"] = os.path.relpath(os.path.abspath(args.decoder))
    print(json.dumps(out), flush=True)
    return out, res


if __name__ == "__main__":
    main()
