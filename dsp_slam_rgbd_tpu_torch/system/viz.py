"""Frame and map pictures (host side, offline).

Counterpart of `dsp_slam_rgbd_tpu/system/viz.py`: the roles of
`FrameDrawer` (`src/FrameDrawer.cc`: the current frame with its
keypoints) and of the top-down part of `MapDrawer`, as PNG files.  PNGs
go through the port's codec; matplotlib is imported only inside
`trajectory_figure`, the one function that draws with it.
"""
from __future__ import annotations

import numpy as np

from dsp_slam_rgbd_tpu_torch.system import io as io_mod
from dsp_slam_rgbd_tpu_torch.system import png
from dsp_slam_rgbd_tpu_torch.system.io import to_host


def draw_frame(img: np.ndarray, frame, status: str = "", n_inliers: int = 0) -> np.ndarray:
    """A grayscale frame with its keypoints: tracked ones (with a map point)
    as green squares, the others as dim dots.  -> RGB uint8."""
    g = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
    out = np.stack([g, g, g], axis=-1)
    xy = to_host(frame.feats.xy)
    valid = to_host(frame.feats.valid)
    tracked = to_host(frame.pt_idx) >= 0
    h, w = g.shape

    def mark(x, y, color, r):
        x0, x1 = max(x - r, 0), min(x + r + 1, w)
        y0, y1 = max(y - r, 0), min(y + r + 1, h)
        out[y0:y1, x0, :] = color
        out[y0:y1, x1 - 1, :] = color
        out[y0, x0:x1, :] = color
        out[y1 - 1, x0:x1, :] = color

    for i in np.nonzero(valid)[0]:
        x, y = int(round(xy[i, 0])), int(round(xy[i, 1]))
        if not (0 <= x < w and 0 <= y < h):
            continue
        if tracked[i]:
            mark(x, y, np.asarray([0, 255, 0], np.uint8), 3)
        else:
            out[y, x] = [120, 120, 255]
    return out


def save_frame_png(path: str, img: np.ndarray, frame, status: str = "", n_inliers: int = 0):
    png.write_png(path, draw_frame(img, frame, status, n_inliers))


def camera_centers(poses_cw) -> np.ndarray:
    """(N, 3) camera centers of (N, 4, 4) T_cw poses."""
    poses_cw = to_host(poses_cw)
    return np.stack([io_mod.inv_se3(T)[:3, 3] for T in poses_cw]) if len(poses_cw) \
        else np.zeros((0, 3))


def trajectory_figure(poses_cw, pts=None, out_png: str | None = None):
    """Top-down (x, z) trajectory + map plot (the MapDrawer role)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    centers = camera_centers(poses_cw)
    fig, ax = plt.subplots(figsize=(7, 7))
    if pts is not None and len(pts):
        pts = to_host(pts)
        ax.scatter(pts[:, 0], pts[:, 2], s=0.4, c="gray", alpha=0.4)
    if len(centers):
        ax.plot(centers[:, 0], centers[:, 2], "g-", lw=1.5)
        ax.plot(centers[-1, 0], centers[-1, 2], "ro", ms=5)
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    if out_png:
        fig.savefig(out_png, dpi=130, bbox_inches="tight")
        plt.close(fig)
    return fig
