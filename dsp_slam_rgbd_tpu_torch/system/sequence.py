"""Dataset sequence loaders and offline detection label files.

Counterpart of `dsp_slam_rgbd_tpu/system/sequence.py`: KITTI stereo +
LiDAR (`KittiSequence`), Redwood-style RGB-D (`RgbdSequence`) and plain
image directories (`MonoSequence`), dispatched by layout in
`get_sequence`; detections come from offline label files (npz per frame:
`n` plus `{i}_{field}` arrays of `ObjectDetection`), from raw detector
outputs assembled in-framework (`detections_from_raw`), or from mask
files for the mono path.

Images are read with the port's own PNG codec (`system/png.py`), on every
machine: gray as PIL's `convert("L")` gives it, kept uint8 (a frame goes to
the card at 1 byte a pixel and is cast there), depth PNGs as f32 times the
depth scale.  The velodyne reader is the port's native library
(`native/runtime.py`); if it cannot be built, reading raises.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from dsp_slam_rgbd_tpu_torch.system import png
from dsp_slam_rgbd_tpu_torch.system.detections import MaskLabel, ObjectDetection


def load_gray(path: str) -> np.ndarray:
    """(H, W) uint8 luma of an image file."""
    return png.to_gray(png.read_png(path))


def load_depth_png(path: str, scale: float = 1.0 / 5000.0) -> np.ndarray:
    """(H, W) f32 depth: the stored values times `scale`."""
    return png.read_png(path).astype(np.float32) * np.float32(scale)


def _read_velodyne(path: str) -> np.ndarray:
    from dsp_slam_rgbd_tpu_torch.native import runtime

    return runtime.read_velodyne(path, max_pts=max(os.path.getsize(path) // 16, 1))


class KittiSequence:
    """KITTI odometry layout: image_2/, image_3/, velodyne/, calib.txt."""

    def __init__(self, root: str, labels_dir: Optional[str] = None,
                 detector_fn: Optional[Callable] = None):
        self.root = root
        left = os.path.join(root, "image_2")
        self.left = sorted(os.listdir(left)) if os.path.isdir(left) else []
        self.labels_dir = labels_dir
        self.detector_fn = detector_fn
        calib_path = os.path.join(root, "calib.txt")
        if os.path.isfile(calib_path):
            self.P2, self.T_cam_velo = self._parse_calib(calib_path)
        else:
            self.P2, self.T_cam_velo = None, np.eye(4, dtype=np.float32)

    @staticmethod
    def _parse_calib(path: str):
        """P2 projection + Tr (velo→cam0) -> (P2, T_cam_velo), the cam0→cam2
        offset +P2[0,3]/P2[0,0] folded in (reference
        `kitti_sequence.py:240-254`)."""
        vals = {}
        with open(path) as f:
            for line in f:
                if ":" not in line:
                    continue
                k, v = line.split(":", 1)
                vals[k.strip()] = np.array(v.split(), np.float64)
        P2 = vals["P2"].reshape(3, 4).astype(np.float32)
        T = np.eye(4, dtype=np.float32)
        if "Tr" in vals:
            T[:3, :] = vals["Tr"].reshape(3, 4)
        offset = np.eye(4, dtype=np.float32)
        offset[0, 3] = P2[0, 3] / P2[0, 0]
        return P2, (offset @ T).astype(np.float32)

    def __len__(self):
        return len(self.left)

    def frame(self, i: int):
        name = self.left[i]
        return (load_gray(os.path.join(self.root, "image_2", name)),
                load_gray(os.path.join(self.root, "image_3", name)))

    def _velodyne_path(self, i: int) -> str:
        return os.path.join(self.root, "velodyne", os.path.splitext(self.left[i])[0] + ".bin")

    def velodyne_cam(self, i: int) -> np.ndarray:
        """Frame i's LiDAR points in the camera frame."""
        pts = _read_velodyne(self._velodyne_path(i))
        return pts @ self.T_cam_velo[:3, :3].T + self.T_cam_velo[:3, 3]

    def detections(self, i: int) -> list:
        if self.labels_dir is not None:
            base = os.path.splitext(self.left[i])[0]
            raw = os.path.join(self.labels_dir, base + "_raw.npz")
            if os.path.isfile(raw):
                return self.detections_from_raw(i, raw)
            return load_label_file(os.path.join(self.labels_dir, base + ".npz"))
        if self.detector_fn is not None:
            return self.detector_fn(self, i)
        return []

    def detections_from_raw(self, i: int, path: str) -> list:
        """Detections assembled from raw detector outputs (`boxes_3d` (N, 7),
        `masks` (M, H, W), `bboxes_2d` (M, 4)) by projected-LiDAR mask voting
        and occlusion masks (the reference's online assembly,
        `kitti_sequence.py:99-216`)."""
        from dsp_slam_rgbd_tpu_torch.system.detections import assemble_kitti_detections

        with np.load(path) as z:
            masks = z["masks"].astype(bool) if "masks" in z.files \
                else np.zeros((0, 1, 1), bool)
            bboxes = z["bboxes_2d"] if "bboxes_2d" in z.files else np.zeros((len(masks), 4))
            boxes = z["boxes_3d"].astype(np.float32)
        img_hw = masks.shape[1:] if len(masks) else (376, 1241)
        K = self.P2[:3, :3]
        dets, _ = assemble_kitti_detections(
            K, np.linalg.inv(K), self.T_cam_velo, _read_velodyne(self._velodyne_path(i)),
            boxes, masks, bboxes, img_hw)
        return dets


class RgbdSequence:
    """Redwood-style layout: rgb/, depth/."""

    def __init__(self, root: str, depth_scale: float = 1.0 / 1000.0,
                 labels_dir: Optional[str] = None):
        self.root = root
        self.rgb = sorted(os.listdir(os.path.join(root, "rgb"))) \
            if os.path.isdir(os.path.join(root, "rgb")) else []
        self.depth = sorted(os.listdir(os.path.join(root, "depth"))) \
            if os.path.isdir(os.path.join(root, "depth")) else []
        self.depth_scale = depth_scale
        self.labels_dir = labels_dir

    def __len__(self):
        return min(len(self.rgb), len(self.depth))

    def frame(self, i: int):
        return (load_gray(os.path.join(self.root, "rgb", self.rgb[i])),
                load_depth_png(os.path.join(self.root, "depth", self.depth[i]),
                               self.depth_scale))

    def detections(self, i: int) -> list:
        if self.labels_dir is not None:
            name = os.path.splitext(self.rgb[i])[0] + ".npz"
            return load_label_file(os.path.join(self.labels_dir, name))
        return []


class MonoSequence:
    """Plain image-directory sequence (Freiburg cars / Redwood chairs)."""

    def __init__(self, root: str, labels_dir: Optional[str] = None):
        self.root = root
        self.images = sorted(f for f in os.listdir(root)
                             if f.lower().endswith((".png", ".jpg", ".jpeg"))) \
            if os.path.isdir(root) else []
        self.labels_dir = labels_dir

    def __len__(self):
        return len(self.images)

    def frame(self, i: int):
        return load_gray(os.path.join(self.root, self.images[i]))

    def detections(self, i: int) -> list:
        if self.labels_dir is not None:
            base = os.path.splitext(self.images[i])[0]
            masks = os.path.join(self.labels_dir, base + "_masks.npz")
            if os.path.isfile(masks):
                # mask-only labels (the reference mono path,
                # `mono_sequence.py:95-107`): the keyframe stage assembles
                # MonoDetections from these with the frame's keypoints
                return load_mask_labels(masks)
            return load_label_file(os.path.join(self.labels_dir, base + ".npz"))
        return []


# ---------------------------------------------------------------------------
# offline label files (npz)
# ---------------------------------------------------------------------------

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


def save_mask_labels(path: str, masks) -> None:
    """Per-frame instance masks ((M, H, W) bool): the mono label format."""
    np.savez_compressed(path, masks=np.asarray(masks, bool))


def load_mask_labels(path: str) -> list:
    if not os.path.isfile(path):
        return []
    with np.load(path) as z:
        return [MaskLabel(m) for m in z["masks"].astype(bool)]


def get_sequence(seq_dir: str, cfg=None):
    """Dispatch by data layout (reference `reconstruct/__init__.py:16`)."""
    if os.path.isdir(os.path.join(seq_dir, "image_2")):
        return KittiSequence(seq_dir)
    if os.path.isdir(os.path.join(seq_dir, "rgb")):
        return RgbdSequence(seq_dir)
    return MonoSequence(seq_dir)
