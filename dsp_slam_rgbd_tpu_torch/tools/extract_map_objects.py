"""Regenerate object meshes from a saved map.

Counterpart of `tools/extract_map_objects.py` (the reference's
`extract_map_objects.py`): reads MapObjects.txt and writes one `.ply`
mesh and one `.npy` pose per object into `<map_dir>/meshes/`.  The shape
code is the object's checkpoint: `models/mesh.MeshExtractor` decodes it
on a voxels³ grid on `--device` (default the card; for the cars_64
layout through the f32 value kernel) and triangulates on the host.

Usage:
  python -m dsp_slam_rgbd_tpu_torch.tools.extract_map_objects \
      <map_dir> <deepsdf.npz | experiment dir> [--voxels 64] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def load_decoder(path: str, device):
    """A decoder from an npz (`deepsdf.save_npz`) or a reference experiment
    directory (`deepsdf.load_torch_checkpoint`)."""
    from dsp_slam_rgbd_tpu_torch.models import deepsdf

    return (deepsdf.load_npz(path, device=device) if path.endswith(".npz")
            else deepsdf.load_torch_checkpoint(path, device=device))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("map_dir")
    ap.add_argument("deepsdf")
    ap.add_argument("--voxels", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from dsp_slam_rgbd_tpu_torch import device as device_mod
    from dsp_slam_rgbd_tpu_torch.models import mesh
    from dsp_slam_rgbd_tpu_torch.system import io as io_mod

    decoder = load_decoder(args.deepsdf, device_mod.resolve(args.device))
    ids, poses, codes = io_mod.load_map_objects(os.path.join(args.map_dir, "MapObjects.txt"))
    extractor = mesh.MeshExtractor(decoder, code_len=decoder.spec.latent_size,
                                   voxels_dim=args.voxels)
    out_dir = os.path.join(args.map_dir, "meshes")
    os.makedirs(out_dir, exist_ok=True)
    meshes = {}
    for oid, T, code in zip(ids, poses, codes):
        m = extractor.extract_mesh_from_code(code)
        mesh.write_ply(os.path.join(out_dir, f"{oid}.ply"), m["vertices"], m["faces"])
        np.save(os.path.join(out_dir, f"{oid}.npy"), T)
        meshes[int(oid)] = m
        print(f"object {oid}: {len(m['vertices'])} verts, {len(m['faces'])} faces")
    return meshes


if __name__ == "__main__":
    main()
