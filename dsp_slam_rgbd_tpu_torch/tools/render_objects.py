"""Render per-object depth images from a saved map.

Counterpart of `tools/render_objects.py`, the offline role of the
reference's ObjectRenderer/ObjectDrawer (`include/Renderer.hpp:24-80`):
each valid object is drawn from its canonical view (the camera on the
object's -z axis at `--standoff` radii) by `system/renderer.py`'s SDF ray
renderer on `--device` (default the card; the f32 value kernel for the
cars_64 layout).  Writes `object_XXX_depth.png` (nearer is brighter,
through the port's own PNG codec) and `object_XXX_depth.npy` (metres, 0
where the ray misses).

MAP_DIR holds `state.npz` (`utils/checkpoint.save_state`) or the
command line's `MapObjects.txt` (`system/io.save_entire_map`: an id, a
Sim(3) pose row and a code row per object).  The JAX tool reads
MapObjects.txt as one row of 16 + L numbers per object, a layout nothing
writes; this one reads the layout the writers produce.

Usage:
  python -m dsp_slam_rgbd_tpu_torch.tools.render_objects MAP_DIR OUT_DIR \
      [--decoder dec.npz | experiment dir] [--fx 718.856 --fy 718.856 \
      --cx 607.19 --cy 185.22 --size 376 1241] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def load_objects(map_dir: str, device):
    """(ids, scales (N,), codes (N, L)) of the map's valid objects."""
    state_path = os.path.join(map_dir, "state.npz")
    if os.path.isfile(state_path):
        from dsp_slam_rgbd_tpu_torch.utils import checkpoint as ckpt

        state, _ = ckpt.load_state(state_path, device=device)
        ids = np.nonzero(state.obj_valid.cpu().numpy())[0]
        return ids, state.obj_scale.cpu().numpy()[ids], state.obj_code.cpu().numpy()[ids]
    from dsp_slam_rgbd_tpu_torch.system import io as io_mod

    ids, poses, codes = io_mod.load_map_objects(os.path.join(map_dir, "MapObjects.txt"))
    # the scale of a Sim(3) pose row: det(sR)^(1/3)
    return ids, np.cbrt(np.abs(np.linalg.det(np.asarray(poses, np.float64)[:, :3, :3]))), codes


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("map_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--decoder", default=None,
                    help="decoder npz or reference experiment dir (default random weights)")
    ap.add_argument("--fx", type=float, default=718.856)
    ap.add_argument("--fy", type=float, default=718.856)
    ap.add_argument("--cx", type=float, default=607.19)
    ap.add_argument("--cy", type=float, default=185.22)
    ap.add_argument("--size", type=int, nargs=2, default=(376, 1241))
    ap.add_argument("--stride", type=int, default=2)
    ap.add_argument("--standoff", type=float, default=2.5,
                    help="camera distance in object radii for the per-object canonical view")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from dsp_slam_rgbd_tpu_torch import device as device_mod
    from dsp_slam_rgbd_tpu_torch.models import deepsdf
    from dsp_slam_rgbd_tpu_torch.system import png
    from dsp_slam_rgbd_tpu_torch.system.renderer import render_object_depth
    from dsp_slam_rgbd_tpu_torch.tools.extract_map_objects import load_decoder

    dev = device_mod.resolve(args.device)
    if args.decoder:
        decoder = load_decoder(args.decoder, dev)
    else:
        decoder = deepsdf.init_decoder(seed=0, device=dev)
        print("WARNING: no --decoder given, rendering with random weights")
    ids, scales, codes = load_objects(args.map_dir, dev)

    os.makedirs(args.out_dir, exist_ok=True)
    K = np.array([[args.fx, 0, args.cx], [0, args.fy, args.cy], [0, 0, 1]], np.float32)
    depths = {}
    for o, scale, code in zip(ids, scales, codes):
        # canonical view: camera on the object's -z axis at standoff radii
        t_co = np.eye(4, dtype=np.float32)
        t_co[:3, :3] = np.eye(3) * scale
        t_co[2, 3] = args.standoff * scale
        d, h = render_object_depth(decoder, torch.as_tensor(code, dtype=torch.float32),
                                   t_co, K, tuple(args.size), stride=args.stride)
        d, h = d.cpu().numpy(), h.cpu().numpy()
        img = np.zeros_like(d)
        if h.any():
            dmin, dmax = d[h].min(), d[h].max() + 1e-6
            img[h] = 55 + 200 * (1.0 - (d[h] - dmin) / (dmax - dmin))
        png.write_png(os.path.join(args.out_dir, f"object_{o:03d}_depth.png"),
                      img.astype(np.uint8))
        np.save(os.path.join(args.out_dir, f"object_{o:03d}_depth.npy"), d)
        depths[int(o)] = (d, h)
        print(f"object {o}: hit {int(h.sum())} px -> object_{o:03d}_depth.png")
    return depths


if __name__ == "__main__":
    main()
