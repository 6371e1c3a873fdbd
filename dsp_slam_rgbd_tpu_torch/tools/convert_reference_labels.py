"""Convert the reference's offline detection fixtures to the npz format.

Counterpart of `tools/convert_reference_labels.py`.  The reference's
`detect_online: false` mode reads torch-saved `.lbl` files
(`kitti_sequence.py:106-107,163-165`: a dict or tensor of 3D boxes per
frame).  This tool converts a directory of them into the npz
ObjectDetection fixtures that `system/sequence.py` reads
(`save_label_file`), optionally with each box's LiDAR points cropped from
`--velodyne` scans.  Host only: numpy and torch's loader, no kernel and
no card, so it takes no `--device`.

Usage:
  python -m dsp_slam_rgbd_tpu_torch.tools.convert_reference_labels \
      <lbl_dir> <out_dir> [--velodyne velo_dir]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def boxes_to_detections(boxes: np.ndarray, velo_cam=None) -> list:
    """KITTI-style 3D boxes (N, 7): x, y, z, l, h, w, yaw in camera
    coordinates -> ObjectDetections (the pose with scale l/2, the box's
    bottom center lifted by h/2, and the LiDAR points inside the box),
    as the reference's `kitti_sequence.py:118-146` does."""
    from dsp_slam_rgbd_tpu_torch.system.detections import crop_lidar_to_box, make_detection

    dets = []
    for b in np.atleast_2d(boxes):
        if len(b) < 7:
            continue
        x, y, z, l, h, w, yaw = b[:7]
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        t_co = np.eye(4, dtype=np.float32)
        t_co[:3, :3] = R * (float(l) / 2.0)
        t_co[:3, 3] = [x, y - h / 2.0, z]
        pts = None
        if velo_cam is not None:
            t_se3 = t_co.copy()
            t_se3[:3, :3] = R
            pts = crop_lidar_to_box(velo_cam, t_se3, np.asarray([w, h, l], np.float32))
        dets.append(make_detection(t_co, pts=pts))
    return dets


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("lbl_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--velodyne", default=None)
    args = ap.parse_args(argv)

    from dsp_slam_rgbd_tpu_torch.system.sequence import save_label_file

    os.makedirs(args.out_dir, exist_ok=True)
    counts = {}
    for name in sorted(os.listdir(args.lbl_dir)):
        if not name.endswith(".lbl"):
            continue
        stem = os.path.splitext(name)[0]
        data = torch.load(os.path.join(args.lbl_dir, name), map_location="cpu",
                          weights_only=False)
        boxes = np.asarray(data["boxes"] if isinstance(data, dict) else data)
        velo = None
        if args.velodyne:
            bin_path = os.path.join(args.velodyne, stem + ".bin")
            if os.path.isfile(bin_path):
                velo = np.fromfile(bin_path, np.float32).reshape(-1, 4)[:, :3]
        dets = boxes_to_detections(boxes, velo)
        save_label_file(os.path.join(args.out_dir, stem + ".npz"), dets)
        counts[stem] = len(dets)
        print(f"{stem}: {len(dets)} detections")
    return counts


if __name__ == "__main__":
    main()
