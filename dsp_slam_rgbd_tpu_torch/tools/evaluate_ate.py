"""ATE-RMSE between two trajectories (TUM or KITTI format).

Counterpart of `tools/evaluate_ate.py`: Sim(3)- or SE(3)-aligns the
estimate to the ground truth (`solvers/sim3.align_trajectories`) and
prints the RMSE, mean, median and largest absolute error, and the scale
under `--scale`.  The alignment runs on `--device` (default the card).

Usage:
  python -m dsp_slam_rgbd_tpu_torch.tools.evaluate_ate <est> <gt> \
      [--format tum|kitti] [--scale] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def load_traj(path: str, fmt: str) -> np.ndarray:
    """(N, 3) camera positions: TUM's tx ty tz, or the translation column of
    KITTI's 3x4 rows."""
    data = np.loadtxt(path, ndmin=2)
    if fmt == "tum":
        return data[:, 1:4]
    return data[:, [3, 7, 11]]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("est")
    ap.add_argument("gt")
    ap.add_argument("--format", default="kitti", choices=["tum", "kitti"])
    ap.add_argument("--scale", action="store_true",
                    help="allow Sim(3) scale in alignment (mono)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from dsp_slam_rgbd_tpu_torch import device as device_mod
    from dsp_slam_rgbd_tpu_torch.ops import lie
    from dsp_slam_rgbd_tpu_torch.solvers import sim3

    dev = device_mod.resolve(args.device)
    est = load_traj(args.est, args.format)
    gt = load_traj(args.gt, args.format)
    n = min(len(est), len(gt))
    est_t = torch.as_tensor(est[:n], dtype=torch.float32, device=dev)
    gt_t = torch.as_tensor(gt[:n], dtype=torch.float32, device=dev)
    T, ate = sim3.align_trajectories(est_t, gt_t, fix_scale=not args.scale)
    aligned = lie.transform_points(T, est_t).cpu().numpy()
    err = np.linalg.norm(aligned - gt[:n], axis=1)
    out = {"n": n, "ate_rmse": float(ate), "mean": float(err.mean()),
           "median": float(np.median(err)), "max": float(err.max())}
    print(f"compared poses: {n}")
    print(f"ate_rmse: {out['ate_rmse']:.4f} m")
    print(f"mean: {out['mean']:.4f} m  median: {out['median']:.4f} m  "
          f"max: {out['max']:.4f} m")
    if args.scale:
        out["scale"] = float(lie.sim3_scale(T))
        print(f"alignment scale: {out['scale']:.4f}")
    return out


if __name__ == "__main__":
    main()
