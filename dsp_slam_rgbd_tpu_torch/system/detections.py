"""Object detection containers + LiDAR/mask preprocessing.

The port's own copy of `dsp_slam_rgbd_tpu/system/detections.py`, numpy
only: `ObjectDetection` (reference `src/ObjectDetection.cc`: a
Sim(3)/SE(3) pose measurement with the scale factored out, surface
points, rays and depths) in fixed-capacity form, the monocular
`MonoDetection`/`MaskLabel`, and the detection assembly of
`reconstruct/kitti_sequence.py:99-216` (box→pose, LiDAR crop + subsample,
mask voting, rays + depth packaging).  Given the same inputs (and the same
`rng`) every function returns the JAX package's arrays byte for byte.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

MAX_SURFACE = 256   # reference caps LiDAR points at 250 (config num_lidar_max)
MAX_RAYS = 512      # fg rays + ≤200 background rays


class ObjectDetection(NamedTuple):
    """One detection, camera frame.  Fixed-size arrays + masks."""
    t_co: np.ndarray      # (4, 4) SE(3) object→camera pose measurement
    scale: float          # object scale (factored out of t_co)
    pts: np.ndarray       # (MAX_SURFACE, 3) surface points (camera frame)
    pts_mask: np.ndarray  # (MAX_SURFACE,)
    rays: np.ndarray      # (MAX_RAYS, 3) ray directions
    ray_mask: np.ndarray  # (MAX_RAYS,)
    depth: np.ndarray     # (MAX_RAYS,) observed depth (fg slots)
    fg_mask: np.ndarray   # (MAX_RAYS,) foreground flags


class MonoDetection(NamedTuple):
    """A monocular mask-only detection: no 3D pose measurement — just the
    keypoints of the current keyframe that fall inside the (eroded)
    instance mask, plus background rays from the inflated box around it
    (reference `ObjectDetection` mono fields + `GetObjectDetectionsMono`,
    `Tracking_util.cc:163-208`).  The 3D pose is recovered downstream from
    the owned map points (PCA cuboid → GN reconstruction)."""
    kp_idx: np.ndarray   # (n,) keypoint indices inside the mask (host, ragged)
    bg_rays: np.ndarray  # (m, 3) background rays (camera frame, z = 1)
    is_good: bool        # ≥ 20 keypoints in the mask (reference :199-202)


class MaskLabel(NamedTuple):
    """A raw per-frame instance-mask label from disk — the mono sequence's
    offline-label format (the reference reads mask files per frame and
    assembles detections with the frame's keypoints,
    `reconstruct/mono_sequence.py:95-107` + `Tracking_util.cc:163-208`).
    The system converts it into a `MonoDetection` at keyframe time via
    `mono_detection_from_mask` with the current frame's keypoints."""
    mask: np.ndarray  # (H, W) bool instance mask


def make_detection(t_co_sim3: np.ndarray, pts=None, rays=None, depth=None,
                   n_fg: int | None = None) -> ObjectDetection:
    """Build a padded detection from ragged inputs.

    t_co_sim3 may be Sim(3): scale = det(R)^(1/3) is factored out
    (reference `ObjectDetection.cc:24-46` SetPoseMeasurementSim3).
    """
    t = np.asarray(t_co_sim3, np.float32).copy()
    scale = float(np.cbrt(np.linalg.det(t[:3, :3])))
    t[:3, :3] /= scale

    P = np.zeros((MAX_SURFACE, 3), np.float32)
    pm = np.zeros(MAX_SURFACE, bool)
    if pts is not None and len(pts):
        n = min(len(pts), MAX_SURFACE)
        P[:n] = pts[:n]
        pm[:n] = True

    R = np.zeros((MAX_RAYS, 3), np.float32)
    rm = np.zeros(MAX_RAYS, bool)
    D = np.zeros(MAX_RAYS, np.float32)
    fg = np.zeros(MAX_RAYS, bool)
    if rays is not None and len(rays):
        n = min(len(rays), MAX_RAYS)
        R[:n] = rays[:n]
        rm[:n] = True
        if depth is not None:
            nf = min(len(depth), n) if n_fg is None else min(n_fg, n)
            D[:nf] = np.asarray(depth)[:nf]
            fg[:nf] = True
    return ObjectDetection(t, scale, P, pm, R, rm, D, fg)


def crop_lidar_to_box(velo_cam: np.ndarray, t_co: np.ndarray, extent,
                      margin: float = 1.1, max_pts: int = MAX_SURFACE):
    """Select LiDAR points inside an (inflated) 3D box and subsample
    (reference `kitti_sequence.py:124-143`)."""
    t_oc = np.linalg.inv(t_co)
    local = velo_cam @ t_oc[:3, :3].T + t_oc[:3, 3]
    half = np.asarray(extent) * 0.5 * margin
    inside = np.all(np.abs(local) <= half, axis=1)
    sel = np.nonzero(inside)[0]
    if len(sel) > max_pts:
        sel = sel[np.linspace(0, len(sel) - 1, max_pts).astype(int)]
    return velo_cam[sel]


def mono_detection_from_mask(mask: np.ndarray, invK: np.ndarray,
                             feats_xy=None, erode: int = 2,
                             n_bg: int = 200, rng=None):
    """Assemble a monocular detection from a 2D instance mask
    (reference `Tracking::GetObjectDetectionsMono`, Tracking_util.cc:163-208:
    mask erosion, keypoints-in-mask, background-pixel rays).

    Returns a MonoDetection (keypoint indices in mask, bg rays, is_good);
    the pose is seeded downstream from the PCA cuboid of the owned map
    points (mono path).
    """
    m = np.asarray(mask, bool)
    if erode > 0:
        from scipy.ndimage import binary_erosion

        m = binary_erosion(m, iterations=erode)
    ys, xs = np.nonzero(m)
    if len(xs) == 0:
        return MonoDetection(np.zeros(0, np.int64),
                             np.zeros((0, 3), np.float32), False)
    # background pixels come from an inflated bbox around the mask (the
    # detector's 2D box in the reference is larger than the instance mask)
    h_img, w_img = m.shape
    bw, bh = xs.max() - xs.min(), ys.max() - ys.min()
    mx, my = max(int(0.2 * bw), 4), max(int(0.2 * bh), 4)
    bbox = (max(xs.min() - mx, 0), max(ys.min() - my, 0),
            min(xs.max() + 1 + mx, w_img), min(ys.max() + 1 + my, h_img))
    bg = sample_background_rays(bbox, m, invK, n_bg=n_bg, rng=rng)

    kp_in = np.zeros(0, np.int64)
    if feats_xy is not None:
        pix = np.round(np.asarray(feats_xy)).astype(int)
        ok = (
            (pix[:, 0] >= 0) & (pix[:, 0] < m.shape[1])
            & (pix[:, 1] >= 0) & (pix[:, 1] < m.shape[0])
        )
        inside = np.zeros(len(pix), bool)
        inside[ok] = m[pix[ok, 1], pix[ok, 0]]
        kp_in = np.nonzero(inside)[0]
    return MonoDetection(kp_in, bg, len(kp_in) >= 20)


def box_to_t_velo_obj(trans, size, theta) -> np.ndarray:
    """SE(3) from a KITTI-style 3D box (velodyne frame).

    Convention (reference `kitti_sequence.py:115-121,131`): `size` is
    **(w, l, h)** — width, length, height — and `trans` is the box
    *bottom* center, so the object origin is lifted by half the height
    (`trans[2] + size[2] / 2`).  The rotation maps the object's up axis
    (y) onto velodyne +z, object x (width) into the velodyne xy-plane at
    yaw theta, and object z (length) perpendicular to it."""
    return np.array([
        [np.cos(theta), 0, -np.sin(theta), trans[0]],
        [-np.sin(theta), 0, -np.cos(theta), trans[1]],
        [0, 1, 0, trans[2] + size[2] / 2],
        [0, 0, 0, 1],
    ], np.float32)


def assemble_kitti_detections(K, invK, t_cam_velo, velo_pts, boxes_3d,
                              masks_2d, bboxes_2d, img_hw,
                              max_lidar_pts: int = MAX_SURFACE,
                              min_mask_area: int = 2000,
                              downsample_ratio: int = 8,
                              n_bg: int = 200):
    """Raw 3D boxes + 2D instance masks -> packaged detections, the full
    reference assembly (`kitti_sequence.py::get_detections`, :99-216):

      * boxes sorted by forward distance; per box: LiDAR crop to a 3 m
        radius then the 1.1x-inflated box in object frame, <=max_lidar_pts
        even subsample, scale l folded into T_cam_obj;
      * 2D association by projected-LiDAR mask voting: the mask containing
        >50% of the in-FOV projected surface points wins (:185-196);
      * background pixels grid-sampled from the inflated 2D bbox outside
        the mask (`pixels_sampler` :70-92), <=n_bg;
      * occlusion mask per instance = union of all closer instances' masks
        (:177-216).

    boxes_3d: (N, 7) [x, y, z, w, l, h, theta] velodyne-frame rows exactly
    as the reference's PointPillars detector emits (trans=box[:3] = bottom
    center, size=box[3:6] = (width, length, height), theta=box[6] — see
    `kitti_sequence.py:115-132`).  masks_2d: (M, H, W) bool.
    bboxes_2d: (M, 4) l,t,r,b.
    Returns (detections, occ_masks): parallel lists; occ_masks entries are
    (H, W) bool or None for unassociated boxes.
    """
    img_h, img_w = img_hw
    order = np.argsort(boxes_3d[:, 0])
    boxes_3d = boxes_3d[order]

    dets, occs = [], []
    occ = np.zeros((img_h, img_w), bool)
    prev_mask = None
    for det3 in boxes_3d:
        trans, size, theta = det3[:3], det3[3:6], det3[6]
        T_velo_obj = box_to_t_velo_obj(trans, size, theta)
        T_obj_velo = np.linalg.inv(T_velo_obj)
        x, y, z = trans
        r = 3.0
        nearby = (
            (velo_pts[:, 0] > x - r) & (velo_pts[:, 0] < x + r)
            & (velo_pts[:, 1] > y - r) & (velo_pts[:, 1] < y + r)
            & (velo_pts[:, 2] > z - r) & (velo_pts[:, 2] < z + r)
        )
        pn = velo_pts[nearby, :3]
        po = pn @ T_obj_velo[:3, :3].T + T_obj_velo[:3, 3]
        # size = (w, l, h); object frame: x = width, y = height (up),
        # z = length (reference kitti_sequence.py:131-139)
        w, l, h = size / 2.0
        w, l = w * 1.1, l * 1.1  # reference inflates w and l only
        on_surf = (
            (po[:, 0] > -w) & (po[:, 0] < w)
            & (po[:, 1] > -h) & (po[:, 1] < h)
            & (po[:, 2] > -l) & (po[:, 2] < l)
        )
        pts_velo = pn[on_surf]
        if len(pts_velo) > max_lidar_pts:
            pts_velo = pts_velo[np.linspace(0, len(pts_velo) - 1,
                                            max_lidar_pts).astype(int)]
        pts_cam = pts_velo @ t_cam_velo[:3, :3].T + t_cam_velo[:3, 3]
        T_cam_obj = (t_cam_velo @ T_velo_obj).astype(np.float32)
        T_cam_obj[:3, :3] *= l  # scale = inflated half-length (reference)
        if T_cam_obj[2, 3] <= 0.0 or len(pts_cam) == 0:
            continue  # behind the camera

        # ---- 2D mask association by projected-point voting ----
        uv_hom = pts_cam @ np.asarray(K).T
        uv = uv_hom[:, :2] / uv_hom[:, 2:3]
        in_fov = (
            (uv[:, 0] > 0) & (uv[:, 0] < img_w)
            & (uv[:, 1] > 0) & (uv[:, 1] < img_h)
        )
        pix = uv[in_fov].astype(np.int32)
        rays = depth = None
        my_occ = None
        if len(masks_2d) and len(pix):
            votes = np.array([
                int(masks_2d[m][pix[:, 1], pix[:, 0]].sum())
                for m in range(len(masks_2d))
            ])
            if votes.max() > 0.5 * len(pix):
                m = int(np.argmax(votes))
                mask = np.asarray(masks_2d[m], bool)
                if mask.sum() > min_mask_area:
                    bg_pix = _pixels_sampler(np.asarray(bboxes_2d[m]), mask,
                                             img_hw, downsample_ratio)
                    if len(bg_pix) > n_bg:
                        bg_pix = bg_pix[np.linspace(
                            0, len(bg_pix) - 1, n_bg).astype(int)]
                    all_pix = np.concatenate([uv, bg_pix], axis=0)
                    hom = np.concatenate(
                        [all_pix, np.ones((len(all_pix), 1))], -1)
                    rays = (hom @ np.asarray(invK).T).astype(np.float32)
                    depth = pts_cam[:, 2].astype(np.float32)
                if prev_mask is not None:
                    occ = occ | prev_mask
                my_occ = occ.copy()
                prev_mask = mask
        if rays is not None:
            d = make_detection(T_cam_obj, pts=pts_cam, rays=rays,
                               depth=depth, n_fg=len(uv))
        else:
            d = make_detection(T_cam_obj, pts=pts_cam)
        dets.append(d)
        occs.append(my_occ)
    return dets, occs


def _pixels_sampler(bbox_2d, mask, img_hw, alpha: int = 8,
                    expand: int = 5):
    """Grid-sample non-mask pixels from the expanded 2D box (reference
    `pixels_sampler`, `kitti_sequence.py:70-92`)."""
    img_h, img_w = img_hw
    max_w, max_h = img_w - 1, img_h - 1
    l, t, r, b = [int(v) for v in bbox_2d]
    l = l - expand if l > expand else 0
    t = t - expand if t > expand else 0
    r = r + expand if r < max_w - expand else max_w
    b = b + expand if b < max_h - expand else max_h
    crop_h, crop_w = b - t + 1, r - l + 1
    hh = np.linspace(t, b, max(int(crop_h / alpha), 1)).astype(np.int32)
    ww = np.linspace(l, r, max(int(crop_w / alpha), 1)).astype(np.int32)
    vv, uu = np.meshgrid(hh, ww, indexing="ij")
    vv, uu = vv.ravel(), uu.ravel()
    non_surf = ~mask[vv, uu]
    return np.stack([uu[non_surf], vv[non_surf]], -1)


def sample_background_rays(bbox, mask, invK, n_bg: int = 200, rng=None):
    """Sample non-object pixels inside the 2D box and lift to rays
    (reference `pixels_sampler` `kitti_sequence.py:70-92`)."""
    rng = rng or np.random.default_rng(0)
    x0, y0, x1, y1 = [int(v) for v in bbox]
    ys, xs = np.mgrid[y0:y1, x0:x1]
    m = mask[y0:y1, x0:x1] if mask is not None else np.zeros_like(xs, bool)
    bg = ~m.astype(bool)
    pix = np.stack([xs[bg], ys[bg]], -1)
    if len(pix) > n_bg:
        pix = pix[rng.choice(len(pix), n_bg, replace=False)]
    hom = np.concatenate([pix, np.ones((len(pix), 1))], -1)
    return (hom @ invK.T).astype(np.float32)
