"""Single-frame object reconstruction: load one frame's detections, fit the
joint shape+pose GN for each, export a mesh, pose and code per good fit.

Counterpart of `tools/reconstruct_frame.py` (the reference's
`reconstruct_frame.py` smoke test, README.md:160-169).

Usage:
  python -m dsp_slam_rgbd_tpu_torch.tools.reconstruct_frame \
      <labels.npz> <deepsdf.npz | experiment dir> <out_dir> [--iters 10] \
      [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("labels")
    ap.add_argument("deepsdf")
    ap.add_argument("out_dir")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from dsp_slam_rgbd_tpu_torch import device as device_mod
    from dsp_slam_rgbd_tpu_torch.models import deepsdf, mesh
    from dsp_slam_rgbd_tpu_torch.recon.optimizer import ReconConfig, reconstruct_object
    from dsp_slam_rgbd_tpu_torch.system import sequence as seq_mod

    dev = device_mod.resolve(args.device)
    decoder = (deepsdf.load_npz(args.deepsdf, device=dev)
               if args.deepsdf.endswith(".npz")
               else deepsdf.load_torch_checkpoint(args.deepsdf, device=dev))
    L = decoder.spec.latent_size
    dets = seq_mod.load_label_file(args.labels)
    cfg = ReconConfig(code_len=L, num_iterations=args.iters)
    os.makedirs(args.out_dir, exist_ok=True)
    extractor = mesh.MeshExtractor(decoder, code_len=L)

    def on_dev(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    for i, det in enumerate(dets):
        t0 = time.perf_counter()
        t_init = np.asarray(det.t_co, np.float32).copy()
        t_init[:3, :3] *= det.scale
        res = reconstruct_object(
            decoder, cfg, on_dev(t_init), on_dev(det.pts, torch.float32),
            on_dev(det.pts_mask), on_dev(det.rays, torch.float32),
            on_dev(det.ray_mask), on_dev(det.depth, torch.float32),
            on_dev(det.fg_mask))
        good = bool(res.is_good)
        dt = time.perf_counter() - t0
        print(f"det {i}: good={good} loss={float(res.loss):.4f} ({dt:.3f} s)")
        if good:
            code = res.code.cpu().numpy()
            m = extractor.extract_mesh_from_code(code)
            mesh.write_ply(os.path.join(args.out_dir, f"det{i}.ply"),
                           m["vertices"], m["faces"])
            np.save(os.path.join(args.out_dir, f"det{i}_pose.npy"),
                    res.t_cam_obj.cpu().numpy())
            np.save(os.path.join(args.out_dir, f"det{i}_code.npy"), code)


if __name__ == "__main__":
    main()
