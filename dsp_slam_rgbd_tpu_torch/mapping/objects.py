"""Map-object logic: data association, cuboid init, dynamics, NBV.

Counterpart of `dsp_slam_rgbd_tpu/mapping/objects.py`, the object-level
algorithms of the reference outside the GN fit:

  * `associate_detections` — `Tracking::ObjectDataAssociation`
    (`Tracking_util.cc:60-153`): 2D ground-plane distance between predicted
    object centers and detections, dynamic objects predicted by velocity,
    best detection per object within a gate;
  * `cuboid_from_points_pca` — `MapObject::ComputeCuboidPCA_onlyformono`
    (`MapObject.cc:330-443`): PCA box with ShapeNet axis convention,
    5–95 percentile extent, pose seed with 0.4·l scale;
  * `update_dynamics` — velocity estimate + dynamic flag
    (`MapObject.cc:459-505`, `LocalMapping_util.cc:84-154` innovation test);
  * `compute_nbv` — the fork's centroid-reflection next-best-view heuristic
    (`MapObject_util.cc:71-106`).

Every function works on tensors of any device and reads nothing back to
the host.  `update_dynamics` takes a batch directly (the JAX package
vmaps it).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from dsp_slam_rgbd_tpu_torch.ops import lie


def associate_detections(obj_centers_w, obj_valid, obj_dynamic, obj_velocity,
                         det_t_co, det_valid, t_cw, dt: float = 1.0,
                         gate: float = 4.0):
    """Greedy best-detection-per-object by planar distance.

    obj_centers_w: (O, 3) object centers in world; det_t_co: (D, 4, 4)
    detection poses (camera frame).  Returns (assoc (O,) int32 detection
    index or −1, unmatched_det (D,) bool).

    Distance is on the camera ground plane (x, z) like the reference's
    2D check; dynamic objects are advanced by their velocity first.  In a
    conflict the closest object wins the detection; an exact tie lets
    every tied object keep it, as in the JAX package.
    """
    D = det_valid.shape[0]
    t_wc = lie.inv_se3(t_cw)
    det_c_w = det_t_co[:, :3, 3] @ t_wc[:3, :3].T + t_wc[:3, 3]   # (D, 3) centers in world
    pred = obj_centers_w + torch.where(obj_dynamic[:, None], obj_velocity * dt, 0.0)
    d = pred[:, None, :] - det_c_w[None, :, :]                    # (O, D, 3)
    dist = torch.sqrt(d[..., 0] ** 2 + d[..., 2] ** 2)            # ground-plane (x, z)
    dist = torch.where(obj_valid[:, None] & det_valid[None, :], dist, torch.inf)

    best_d, best = torch.min(dist, dim=1)   # first index of the minimum
    assoc = torch.where(obj_valid & (best_d <= gate), best, -1)
    # resolve conflicts: the closest object wins a detection (dump row D)
    dist_best = torch.where(assoc >= 0, best_d, torch.inf)
    tgt = torch.where(assoc >= 0, assoc, D)
    claimed = torch.full((D + 1,), torch.inf, device=dist.device).scatter_reduce_(
        0, tgt, dist_best, "amin")
    win = dist_best <= claimed[tgt]
    assoc = torch.where(win, assoc, -1)
    matched = torch.zeros(D + 1, dtype=torch.bool, device=dist.device).index_fill_(
        0, torch.where(assoc >= 0, assoc, D), True)[:D]
    return assoc.to(torch.int32), det_valid & ~matched


class Cuboid(NamedTuple):
    t_wo: torch.Tensor    # (4, 4) pose seed (SE3)
    scale: torch.Tensor   # scalar (0.4·l, reference seed)
    extent: torch.Tensor  # (3,) full box dims (w, h, l)
    outlier: torch.Tensor # (N,) bool — outside the 1.2× PCA box


def remove_outliers_simple(pts_w: torch.Tensor, owned: torch.Tensor,
                           max_dist: float = 1.0) -> torch.Tensor:
    """Points farther than `max_dist` from the owned-set centroid are
    released (reference `MapObject::RemoveOutliersSimple`,
    `MapObject.cc:249-283`).  Returns the surviving owned mask."""
    w = owned.float()
    n = torch.clamp_min(w.sum(), 1.0)
    c = (w @ pts_w) / n
    return owned & (torch.linalg.vector_norm(pts_w - c, dim=-1) <= max_dist)


def cuboid_from_points_pca(pts_w: torch.Tensor, mask: torch.Tensor,
                           ground_normal=None) -> Cuboid:
    """PCA cuboid seed from owned map points (mono path), with the
    reference's exact conventions (`MapObject::ComputeCuboidPCA_onlyformono`,
    `MapObject.cc:330-443`):

      * eigenvectors of the centered covariance, ascending;
      * ShapeNet axes: x = middle axis, y = smallest (up), z = −largest
        (car length), det fixed by flipping x, y forced toward camera-up
        (world −y);
      * box = 5–95 percentile extents of UNCENTERED coords along the axes,
        centre = percentile midpoints;
      * scale seed = 0.40·l (z extent); outliers = outside the 1.2× box.

    The sign of an eigenvector is the solver's choice, and `ez` is taken
    as it comes (as in the JAX package and the reference): another sign
    of the largest axis turns the box 180° about its y axis.  The mono
    path's flip test (`mono_objects.process_detected_objects`) absorbs it.
    """
    w = mask.float()
    n = torch.clamp_min(w.sum(), 1.0)
    c_mean = (w @ pts_w) / n
    q = (pts_w - c_mean) * w[:, None]
    C = q.T @ q
    _, vecs = torch.linalg.eigh(C)  # ascending eigenvalues
    R = torch.stack([vecs[:, 1], vecs[:, 0], -vecs[:, 2]], dim=1)  # columns = object axes
    # det(R) = −1 → flip x (reference :376-377)
    flip = torch.sign(torch.linalg.det(R))
    # y must point up (dot with world −y ≥ 0): flip x and y (:380-386)
    upflip = torch.where(R[1, 1] > 0.0, -1.0, 1.0)
    one = torch.ones_like(flip)
    R = R * torch.stack([flip * upflip, upflip, one])
    # percentile box over UNCENTERED local coords (reference :388-405);
    # padding slots become NaN so they cannot drag the quantiles
    local = pts_w @ R  # = R⁻¹ · x (R orthonormal)
    local_masked = torch.where(mask[:, None], local, torch.nan)
    lo = torch.nanquantile(local_masked, 0.05, dim=0)
    hi = torch.nanquantile(local_masked, 0.95, dim=0)
    ok = torch.isfinite(hi - lo)
    extent = torch.where(ok, hi - lo, 0.0)
    centre_o = torch.where(ok, 0.5 * (hi + lo), 0.0)
    centre_w = R @ centre_o
    scale = 0.4 * extent[2]  # 0.40·l (reference :436)
    # outliers: outside the 1.2× box (reference :409-431 SetOutlierFlag)
    d = torch.abs(local - centre_o)
    outlier = mask & torch.any(d > 1.2 * 0.5 * extent, dim=-1)
    return Cuboid(lie.rt_to_mat(R, centre_w), scale, extent, outlier)


def inflate_bbox(bb: torch.Tensor) -> torch.Tensor:
    """A decoded-shape bbox (…, 3) inflated per axis by (1.2, 1.5, 1.2)
    (reference `MapObject.cc:301-303`), without copying the factors from
    the host (which blocks the host on the card)."""
    return torch.stack([bb[..., 0] * 1.2, bb[..., 1] * 1.5, bb[..., 2] * 1.2], dim=-1)


def model_outliers(pts_w: torch.Tensor, owned: torch.Tensor, t_wo: torch.Tensor,
                   scale, bbox_min: torch.Tensor, bbox_max: torch.Tensor
                   ) -> torch.Tensor:
    """Model-based outlier gating with the decoded shape's bbox
    (reference `MapObject::RemoveOutliersModel`, `MapObject.cc:285-328`):
    points outside the per-axis inflated (1.2, 1.5, 1.2)× bbox of the
    reconstructed mesh, in normalized object coordinates, are outliers."""
    T_ow = lie.inv_se3(t_wo)
    scale = torch.as_tensor(scale, dtype=pts_w.dtype, device=pts_w.device)
    local = lie.transform_points(T_ow, pts_w) / torch.clamp_min(scale, 1e-6)
    out = (local > inflate_bbox(bbox_max)) | (local < inflate_bbox(bbox_min))
    return owned & torch.any(out, dim=-1)


def update_dynamics(prev_center, new_center, dt, prev_velocity,
                    innovation_th: float = 0.3, alpha: float = 0.6):
    """Velocity filter + dynamic classification by innovation
    (reference `LocalMapping_util.cc:84-154`).  Centers and velocities
    (…, 3); returns (velocity (…, 3), dynamic (…,), innovation (…,))."""
    v_obs = (new_center - prev_center) / max(dt, 1e-6)
    innovation = torch.linalg.vector_norm(new_center - prev_center, dim=-1)
    dynamic = innovation > innovation_th
    v = alpha * prev_velocity + (1 - alpha) * v_obs
    return v, dynamic, innovation


def compute_nbv(obj_center_w, cam_center_w, standoff: float = None):
    """Next-best-view: reflect the current viewpoint through the object
    centroid at equal standoff (reference `MapObject_util.cc:71-106`).
    Returns T_wc (4, 4) of the suggested view."""
    d = obj_center_w - cam_center_w
    dist = torch.linalg.vector_norm(d)
    if standoff is None:
        standoff = dist
    dir_ = d / torch.clamp_min(dist, 1e-9)
    nbv_pos = obj_center_w + dir_ * standoff  # opposite side
    look = -dir_
    # camera z looks at the object; build a rotation with y down-ish
    up = torch.tensor([0.0, -1.0, 0.0], device=d.device)
    z = look / torch.clamp_min(torch.linalg.vector_norm(look), 1e-9)
    x = torch.linalg.cross(up, z)
    x = x / torch.clamp_min(torch.linalg.vector_norm(x), 1e-9)
    y = torch.linalg.cross(z, x)
    return lie.rt_to_mat(torch.stack([x, y, z], dim=1), nbv_pos)


def cull_objects(obj_valid, obj_n_obs, obj_last_kf, current_kf,
                 min_obs: int = 2, max_age: int = 20):
    """MapObjectCulling role (`LocalMapping_util.cc:29-82`): drop objects
    with too few observations that went stale."""
    stale = (current_kf - obj_last_kf) > max_age
    return obj_valid & ~(stale & (obj_n_obs < min_obs))
