"""Offline detection label files (npz).

The port's own copy of `save_label_file` / `load_label_file` from
`dsp_slam_rgbd_tpu/system/sequence.py`: one frame's `ObjectDetection`s as
a flat npz, `n` plus `{i}_{field}` arrays.
"""
from __future__ import annotations

import os

import numpy as np

from dsp_slam_rgbd_tpu_torch.system.detections import ObjectDetection


def save_label_file(path: str, dets: list[ObjectDetection]) -> None:
    flat = {"n": np.asarray(len(dets))}
    for i, d in enumerate(dets):
        for f in ObjectDetection._fields:
            flat[f"{i}_{f}"] = np.asarray(getattr(d, f))
    np.savez_compressed(path, **flat)


def load_label_file(path: str) -> list[ObjectDetection]:
    """The detections in `path`; an empty list when there is no file."""
    if not os.path.isfile(path):
        return []
    with np.load(path) as z:
        return [ObjectDetection(**{f: z[f"{i}_{f}"] for f in ObjectDetection._fields})
                for i in range(int(z["n"]))]
