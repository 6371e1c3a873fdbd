"""Export a combined map visualization (the reference's `visualize_map.py`).

Counterpart of `tools/visualize_map.py`: writes `<map_dir>/scene.ply` with
the map points and, given `--deepsdf`, each object's mesh at its Sim(3)
pose, extracted on a 32³ grid on `--device` (default the card; the f32
value kernel for the cars_64 layout).  `--png` draws the top-down view
(x right, z up): map points in grey, the camera trajectory as a blue
polyline, object centers as red squares.  The JAX tool draws it with
matplotlib; this one rasterizes it into a uint8 array and writes it with
the port's own codec (`system/png.py`).

Usage:
  python -m dsp_slam_rgbd_tpu_torch.tools.visualize_map <map_dir> \
      [--deepsdf dec.npz] [--png out.png] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

POINT_RGB = (150, 150, 150)
TRAJECTORY_RGB = (0, 0, 255)
OBJECT_RGB = (255, 0, 0)


def _load_rows(path: str, width: int) -> np.ndarray:
    return np.loadtxt(path, ndmin=2) if os.path.isfile(path) else np.zeros((0, width))


def top_down_view(pts: np.ndarray, cam_centers: np.ndarray, obj_centers: np.ndarray,
                  size: int = 800, margin: int = 16) -> np.ndarray:
    """(size, size, 3) uint8 RGB on white: the x-z plane of every input,
    one scale for both axes."""
    img = np.full((size, size, 3), 255, np.uint8)
    xz = [a[:, [0, 2]] for a in (pts, cam_centers, obj_centers) if len(a)]
    if not xz:
        return img
    allxz = np.concatenate(xz)
    lo, hi = allxz.min(0), allxz.max(0)
    s = (size - 1 - 2 * margin) / max(float((hi - lo).max()), 1e-9)

    def pix(a):   # (N, 3) -> (N, 2) integer (col, row); z grows upward
        col = margin + (a[:, 0] - lo[0]) * s
        row = size - 1 - margin - (a[:, 2] - lo[1]) * s
        return np.stack([np.rint(col), np.rint(row)], 1).astype(np.int64)

    if len(pts):
        c, r = pix(pts).T
        img[r, c] = POINT_RGB
    if len(cam_centers):
        p = pix(cam_centers)
        if len(p) == 1:
            p = np.concatenate([p, p])
        for a, b in zip(p[:-1], p[1:]):   # each segment sampled at every pixel step
            n = int(np.abs(b - a).max()) + 1
            c, r = np.rint(np.linspace(a, b, n)).astype(np.int64).T
            for dc, dr in ((0, 0), (1, 0), (0, 1)):
                img[np.clip(r + dr, 0, size - 1), np.clip(c + dc, 0, size - 1)] = TRAJECTORY_RGB
    for c, r in pix(obj_centers) if len(obj_centers) else ():
        img[max(r - 3, 0):r + 4, max(c - 3, 0):c + 4] = OBJECT_RGB
    return img


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("map_dir")
    ap.add_argument("--deepsdf", default=None)
    ap.add_argument("--png", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from dsp_slam_rgbd_tpu_torch import device as device_mod
    from dsp_slam_rgbd_tpu_torch.models import mesh as mesh_mod
    from dsp_slam_rgbd_tpu_torch.system import io as io_mod
    from dsp_slam_rgbd_tpu_torch.system import png
    from dsp_slam_rgbd_tpu_torch.tools.extract_map_objects import load_decoder

    dev = device_mod.resolve(args.device)
    pts = _load_rows(os.path.join(args.map_dir, "MapPoints.txt"), 3)
    cams = _load_rows(os.path.join(args.map_dir, "Cameras.txt"), 12)
    cam_centers = cams[:, [3, 7, 11]] if len(cams) else np.zeros((0, 3))

    all_v, all_f = [pts.astype(np.float32)], []
    v_off = len(pts)
    obj_path = os.path.join(args.map_dir, "MapObjects.txt")
    _, poses, codes = (io_mod.load_map_objects(obj_path) if os.path.isfile(obj_path)
                       else ([], np.zeros((0, 4, 4)), []))
    if args.deepsdf and len(poses):
        decoder = load_decoder(args.deepsdf, dev)
        ex =mesh_mod.MeshExtractor(decoder, code_len=decoder.spec.latent_size, voxels_dim=32)
        for T, code in zip(poses, codes):
            m = ex.extract_mesh_from_code(code)
            v = m["vertices"] @ T[:3, :3].T + T[:3, 3]
            all_v.append(v.astype(np.float32))
            all_f.append(m["faces"] + v_off)
            v_off += len(v)

    verts = np.concatenate(all_v)
    faces = np.concatenate(all_f) if all_f else np.zeros((0, 3), np.int32)
    out_ply = os.path.join(args.map_dir, "scene.ply")
    mesh_mod.write_ply(out_ply, verts, faces)
    print(f"wrote {out_ply}: {len(verts)} verts, {len(faces)} faces, "
          f"{len(cam_centers)} cameras")
    out = {"vertices": verts, "faces": faces, "cameras": len(cam_centers)}
    if args.png:
        png.write_png(args.png, top_down_view(pts, cam_centers, poses[:, :3, 3]))
        print(f"wrote {args.png}")
    return out


if __name__ == "__main__":
    main()
