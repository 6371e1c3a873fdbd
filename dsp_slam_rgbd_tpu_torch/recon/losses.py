"""Shape/pose reconstruction losses with analytic GN Jacobians.

Counterpart of `dsp_slam_rgbd_tpu/recon/losses.py` (reference
`reconstruct/loss.py`: compute_sdf_loss :22-43, compute_render_loss
:60-166, compute_rotation_loss_sim3 :169-192), in masked fixed-shape
PyTorch.  Every function takes optional leading batch dimensions (one per
object), so the batched optimizer runs each term once over all objects and
each decoder query is one launch over all of their rows.

Variable-length gathers are masks or fixed-capacity compactions built with
a cumulative sum and a scatter (no `torch.nonzero`, which syncs the host).

`compute_render_loss(group=...)` splits the decoder rows over the ranks of
a process group (the mesh's `ray` axis, `parallel/mesh.py`): each rank
queries its share of the samples and the values are gathered, so every
rank compacts and selects over the object's whole sample set; then each
rank takes its share of the compacted gradient points.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from dsp_slam_rgbd_tpu_torch.ops import lie
from dsp_slam_rgbd_tpu_torch.parallel import distributed as dist


def sdf_to_occupancy(sdf: torch.Tensor, th: float = 0.01) -> torch.Tensor:
    """Linear SDF→occupancy ramp on ±th (reference `loss_utils.py:40-48`)."""
    return 0.5 - torch.clamp(sdf, -th, th) / (2.0 * th)


def compact_indices(mask: torch.Tensor, size: int, fill_value: int) -> torch.Tensor:
    """The first `size` positions of True along the last axis of `mask`,
    padded with `fill_value`: `jnp.nonzero(mask, size=size,
    fill_value=fill_value)` per row, without a host sync."""
    n = mask.shape[-1]
    pos = torch.cumsum(mask.long(), dim=-1) - 1
    slot = torch.where(mask & (pos < size), pos, size)   # slot `size`: dropped
    src = torch.arange(n, device=mask.device).expand(mask.shape)
    idx = torch.full(mask.shape[:-1] + (size + 1,), fill_value,
                     dtype=torch.long, device=mask.device)
    return idx.scatter(-1, slot, src)[..., :size]


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (…, P, C), idx (…, K) -> (…, K, C)."""
    return torch.gather(x, -2, idx[..., None].expand(idx.shape + x.shape[-1:]))


def _query_split(decoder, code, pts, dtype, group):
    """`decoder.query` over pts (…, n, 3): each rank of `group` queries its
    share of the n rows, and every rank gets all n values."""
    if group is None:
        return decoder.query(code, pts, dtype)
    n = pts.shape[-2]
    start, stop, n_pad = dist.shard_range(n, group)
    local = dist.pad_rows(pts, n_pad, -2).narrow(-2, start, stop - start)
    return dist.gather_rows(decoder.query(code, local, dtype), group, -1)[..., :n]


def _value_dtype(decoder, fast_value_pass: bool, compute_dtype):
    """The value pass's dtype.  On the fused-kernel route it is bf16 when
    `fast_value_pass`, else f32 (the JAX package's Pallas route,
    `losses.py:189`); the plain decoder uses the compute dtype."""
    if decoder.fused:
        return torch.bfloat16 if fast_value_pass else torch.float32
    return compute_dtype


class SdfLossResult(NamedTuple):
    jac_pose: torch.Tensor   # (…, N, 7) d res / d sim3(t_obj_cam), tangent [v,w,s]
    jac_code: torch.Tensor   # (…, N, L)
    res: torch.Tensor        # (…, N)
    mask: torch.Tensor       # (…, N) live surface points


def compute_sdf_loss(decoder, pts_surface_cam, mask, t_obj_cam, code,
                     compute_dtype=torch.float32) -> SdfLossResult:
    """Surface-point SDF term: residual = SDF(T_oc · p_cam; z).

    `t_obj_cam` (…, 4, 4) may be Sim(3); jac_pose is with respect to its
    left-perturbation tangent (7,).
    """
    pts_obj = lie.transform_points(t_obj_cam, pts_surface_cam)
    res, jac_in = decoder.query_with_jacobian(code, pts_obj, compute_dtype)
    dxo_dT = lie.points_to_pose_jacobian_sim3(pts_obj)          # (…, N, 3, 7)
    jac_pose = torch.einsum("...ni,...nij->...nj", jac_in[..., -3:], dxo_dT)
    return SdfLossResult(jac_pose, jac_in[..., :-3], res, mask)


class RenderLossResult(NamedTuple):
    jac_pose: torch.Tensor     # (…, K, 7)
    jac_code: torch.Tensor     # (…, K, L)
    res: torch.Tensor          # (…, K)
    mask: torch.Tensor         # (…, K) live gradient points
    n_valid: torch.Tensor      # (…,) in-sphere sample count (failure check)
    res_ray: torch.Tensor      # (…, R) clamped depth residual
    min_abs_sdf: torch.Tensor  # (…, R) min |SDF| over in-sphere samples


def chord_sample_depths(t_obj_cam, ray_dirs, num_samples: int,
                        eps: float = 1e-4):
    """Per-ray depth samples spanning exactly the ray ∩ unit-sphere chord
    (the decoder's support), from the closed-form |A·d·t + c| = 1 roots.

    Returns (depths (…, R, M), hit (…, R)); depths are garbage where ~hit.
    """
    A = t_obj_cam[..., :3, :3]
    c = t_obj_cam[..., :3, 3]
    u = ray_dirs @ A.transpose(-1, -2)                  # (…, R, 3)
    a = torch.sum(u * u, dim=-1)
    b = 2.0 * torch.sum(u * c[..., None, :], dim=-1)
    cc = (torch.sum(c * c, dim=-1) - 1.0)[..., None]
    disc = b * b - 4.0 * a * cc
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    a_safe = torch.clamp_min(a, 1e-12)
    t0 = (-b - sq) / (2.0 * a_safe)
    t1 = (-b + sq) / (2.0 * a_safe)
    t0 = torch.clamp_min(t0, eps)                       # in front of the camera
    hit = (disc > 0.0) & (t1 > t0)
    frac = torch.linspace(0.0, 1.0, num_samples, device=ray_dirs.device)
    depths = t0[..., None] + (t1 - t0)[..., None] * frac
    return depths, hit


def compute_render_loss(decoder, ray_dirs, ray_mask, depth_obs, t_obj_cam,
                        sampled_depths, code, th: float = 0.01,
                        max_grad_points: int = 2048,
                        max_valid_samples: int = 8192,
                        fast_value_pass: bool = False,
                        compute_dtype=torch.float32,
                        d_max=None, group=None) -> RenderLossResult:
    """Depth-rendering term via ray termination probabilities.

    Samples R rays × M depths; occupancy o = ramp(SDF) inside the unit
    sphere (value-only pass); transmittance T_l = Π_{j≤l}(1−o_j);
    termination p_l = o_l·T_{l−1}; rendered depth Σ d̂_l p_l with a
    background bin at 1.1·d_max; ∂e/∂o_m = (Σ_{l≥m} T_l)/(1−o_m).  Gradient
    points (|SDF| < th, ∂e/∂o > 1e-2) are compacted to K = max_grad_points
    and only they get the decoder Jacobian pass.  The residual is clamped
    to ±0.30 m.

    `sampled_depths` is (…, M), the reference's global linspace (values are
    then compacted to `max_valid_samples` in-sphere samples first), or
    (…, R, M) per-ray chord samples (`chord_sample_depths`).  `d_max`
    (scalar or (…,)): the far plane of the background bin; derived from
    the samples when None.  `group`: a process group whose ranks split the
    decoder rows; the K gradient rows (jac_pose, jac_code, res, mask) are
    then this rank's share of them, the other fields whole.
    """
    R = ray_dirs.shape[-2]
    batch = ray_dirs.shape[:-2]
    chord_mode = sampled_depths.dim() == ray_dirs.dim()
    M = sampled_depths.shape[-1]
    if chord_mode:
        d_per_ray = sampled_depths
        if d_max is None:
            d_max = torch.amax(torch.where(ray_mask, d_per_ray[..., -1], 0.0), dim=-1)
        delta_d = (d_per_ray[..., -1] - d_per_ray[..., 0]) / (M - 1)
    else:
        d_per_ray = sampled_depths[..., None, :].expand(batch + (R, M))
        if d_max is None:
            d_max = sampled_depths[..., -1]
        delta_d = ((sampled_depths[..., -1] - sampled_depths[..., 0])
                   / (M - 1))[..., None].expand(batch + (R,))
    d_max = torch.as_tensor(d_max, dtype=torch.float32, device=ray_dirs.device)
    pts_cam = ray_dirs[..., :, None, :] * d_per_ray[..., None]          # (…, R, M, 3)
    pts_obj = lie.transform_points(t_obj_cam, pts_cam.reshape(batch + (R * M, 3)))
    valid = ((torch.linalg.vector_norm(pts_obj, dim=-1) < 1.0).reshape(batch + (R, M))
             & ray_mask[..., None])

    val_dtype = _value_dtype(decoder, fast_value_pass, compute_dtype)
    if chord_mode:
        # chord samples are in-support by construction: dense value pass
        sdf_vals = _query_split(decoder, code, pts_obj, val_dtype, group) \
            .reshape(batch + (R, M))
    else:
        # global linspace: compact in-sphere samples to a static capacity;
        # samples past it count as empty space
        flat_valid = valid.reshape(batch + (R * M,))
        idx_val = compact_indices(flat_valid, max_valid_samples, R * M)
        pts_val = _gather_rows(pts_obj, torch.clamp_max(idx_val, R * M - 1))
        sdf_val = _query_split(decoder, code, pts_val, val_dtype, group)
        sdf_vals = torch.zeros(batch + (R * M + 1,), device=ray_dirs.device) \
            .scatter(-1, idx_val, sdf_val)[..., :-1].reshape(batch + (R, M))
        covered = torch.zeros(batch + (R * M + 1,), dtype=torch.bool,
                              device=ray_dirs.device) \
            .scatter(-1, idx_val, True)[..., :-1].reshape(batch + (R, M))
        valid = valid & covered
    occ = torch.where(valid, sdf_to_occupancy(sdf_vals, th), 0.0)       # (…, R, M)
    acc_trans = torch.cumprod(1.0 - occ, dim=-1)                         # T_1..T_M
    acc_aug = torch.cat([torch.ones_like(occ[..., :1]), acc_trans], dim=-1)
    o_aug = torch.cat([occ, torch.ones_like(occ[..., :1])], dim=-1)
    d_bg = (1.1 * d_max)[..., None, None].expand(batch + (R, 1))
    d_aug = torch.cat([d_per_ray, d_bg], dim=-1)
    d_u = torch.sum(d_aug * o_aug * acc_aug, dim=-1)                     # (…, R)

    # de/do_m = (Σ_{l≥m} T_l) / (1 − o_m)
    rev_cumsum = torch.flip(torch.cumsum(torch.flip(acc_trans, [-1]), dim=-1), [-1])
    de_do = rev_cumsum / torch.clamp_min(1.0 - occ, 1e-6)

    with_grad = valid & (torch.abs(sdf_vals) < th) & (de_do > 1e-2)
    n_valid = torch.sum(valid, dim=(-2, -1))
    res_ray = torch.clamp(depth_obs - d_u, -0.30, 0.30)                  # (…, R)
    de_ds = de_do * delta_d[..., None] * (-1.0 / (2.0 * th))             # (…, R, M)

    # fixed-capacity compaction of gradient points.  The padding slots point
    # at sample 0 and `live` reads the mask there, as `jnp.nonzero(size=K,
    # fill_value=0)` does: if sample 0 is itself a gradient point, the
    # padding repeats it as live (a fault of the reference kept for parity).
    flat_mask = with_grad.reshape(batch + (R * M,))
    idx = compact_indices(flat_mask, max_grad_points, 0)
    live = torch.gather(flat_mask, -1, idx)
    if group is not None:   # this rank's share of the K gradient rows
        start, stop, k_pad = dist.shard_range(max_grad_points, group)
        idx = dist.pad_rows(idx, k_pad, -1).narrow(-1, start, stop - start)
        live = dist.pad_rows(live, k_pad, -1, False).narrow(-1, start, stop - start)
    pts_sel = _gather_rows(pts_obj, idx)                                 # (…, K, 3)
    de_ds_sel = torch.gather(de_ds.reshape(batch + (R * M,)), -1, idx)
    res_sel = torch.gather(res_ray, -1, idx // M)

    _, ds_di = decoder.query_with_jacobian(code, pts_sel, compute_dtype)
    de_di = de_ds_sel[..., None] * ds_di                                 # (…, K, L+3)
    dxo_dT = lie.points_to_pose_jacobian_sim3(pts_sel)
    jac_pose = torch.einsum("...ni,...nij->...nj", de_di[..., -3:], dxo_dT)
    min_abs = torch.amin(torch.where(valid, torch.abs(sdf_vals), torch.inf), dim=-1)
    return RenderLossResult(jac_pose, de_di[..., :-3], res_sel, live, n_valid,
                            res_ray, min_abs)


def compute_rotation_loss_sim3(t_obj_cam):
    """Vertical-axis prior E = 1 − r_y · n_g (reference `loss.py:169-192`).

    Returns (J_sim3 (…, 7), res (…,)); both zero when already aligned.
    """
    t_cam_obj = lie.inv_sim3(t_obj_cam)
    sR = t_cam_obj[..., :3, :3]
    r_co = sR / lie.cbrt(torch.linalg.det(sR))[..., None, None]
    # built on the device: a constant copied from the host blocks the host
    ey = torch.eye(3, device=sR.device)[1]
    ng = -ey
    ry = r_co @ ey
    res = 1.0 - ry @ ng
    r_oc_ng = ng @ r_co                                  # r_coᵀ n_g
    J_rot = torch.linalg.cross(r_oc_ng, ey.expand_as(r_oc_ng), dim=-1)
    zeros3 = torch.zeros_like(J_rot)
    J = torch.cat([zeros3, J_rot, zeros3[..., :1]], dim=-1)
    zero = res < 1e-7
    return torch.where(zero[..., None], 0.0, J), torch.where(zero, 0.0, res)
