"""Object shape+pose Gauss-Newton optimizer (the FLOPs core).

Counterpart of `dsp_slam_rgbd_tpu/recon/optimizer.py` (reference
`reconstruct/optimizer.py`):

  * `reconstruct_objects_batched` (:90-205): joint Sim(3)-pose + latent-code
    GN over a batch of objects.  Per iteration: depth samples from the
    current pose, SDF surface term, differentiable-render depth term,
    rotation prior; H = k1·H_render + k2·H_sdf (+ k3 Tikhonov on the code,
    k4 rotation block, +1·I pose damping, +s_damp on scale); solve; update
    by exp_sim3(lr·δp)·T and z += lr·δc.  The batch is a tensor dimension:
    each decoder query is one launch over the rows of all objects.
    `reconstruct_object` is the batch of one.
  * `estimate_pose_cam_obj` (:46-87): SE(3) pose-only GN on the SDF term
    with inlier re-gating at iteration 4.

Failure modes (NaN loss, singular solve, too few render samples) are a
per-object `good` tensor that freezes further updates; nothing in the
loop reads a value back to the host.

With a process group (`group=`, the mesh's `ray` axis) the ranks split an
object's decoder rows: the surface points, the render term's samples
(values gathered, so every rank selects and compacts over the whole ray
set) and its gradient points.  Each rank sums JᵀJ, Jᵀr, Σr² and the live
count over its rows; one all_reduce adds them up and the normalization
follows, so every rank solves the same system.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from dsp_slam_rgbd_tpu_torch.ops import lie, robust
from dsp_slam_rgbd_tpu_torch.ops.cuda import mlp_sdf, normal_solve
from dsp_slam_rgbd_tpu_torch.parallel import distributed as dist
from dsp_slam_rgbd_tpu_torch.recon import losses
from dsp_slam_rgbd_tpu_torch.utils import timers


class ReconConfig(NamedTuple):
    """Mirror of the reference json `optimizer` block
    (`configs/config_kitti.json`).  On the card the decoder route is fixed:
    the fused kernels for their layouts (latent 64 or 256, 8x512, latent_in
    (4,)), the plain decoder for any other."""
    code_len: int = 64
    num_depth_samples: int = 50
    cut_off_threshold: float = 0.01
    k1: float = 1.0
    k2: float = 100.0
    k3: float = 0.25
    k4: float = 1.0e7
    b1: float = 0.20
    b2: float = 0.025
    num_iterations: int = 10
    learning_rate: float = 1.0
    scale_damping: float = 1.0
    pose_only_iterations: int = 5
    max_grad_points: int = 2048     # render-term Jacobian compaction capacity
    max_valid_samples: int = 8192   # render-term value-pass compaction capacity
    # bf16 value pass (no gradient flows through it)
    fast_value_pass: bool = False
    # coarse-to-fine: the first `coarse_iterations` run the render term at
    # `coarse_samples` depth samples per ray; 0 disables
    coarse_iterations: int = 0
    coarse_samples: int = 0
    # per-ray chord sampling inside the unit sphere (True), or the
    # reference's global linspace over d_center ± scale (False)
    chord_sampling: bool = True
    # after the coarse phase keep ceil(R·fraction) rays: foreground rays and
    # rays whose chord nears the surface first, then by |residual|
    active_ray_fraction: float = 1.0

    @classmethod
    def gpu_fast(cls, **overrides) -> "ReconConfig":
        """The production preset, with the knobs of the JAX package's
        `tpu_fast`: bf16 value pass, halved compaction capacities,
        coarse-to-fine sampling (6 iterations at 25 samples per ray) and
        fine-phase active-ray compaction to half the rays.  Use with
        compute_dtype=FAST_DTYPE."""
        base = dict(fast_value_pass=True, max_grad_points=1024,
                    max_valid_samples=4096, coarse_iterations=6,
                    coarse_samples=25, active_ray_fraction=0.5)
        base.update(overrides)
        return cls(**base)


FAST_DTYPE = torch.bfloat16   # compute dtype companion to gpu_fast()


class ReconResult(NamedTuple):
    t_cam_obj: torch.Tensor  # (…, 4, 4) Sim(3)
    code: torch.Tensor       # (…, L)
    is_good: torch.Tensor    # (…,) bool
    loss: torch.Tensor       # (…,)


def _gather_rays(x: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """x (B, R, …) rows picked by sel (B, R') along the ray axis."""
    idx = sel.reshape(sel.shape + (1,) * (x.dim() - 2)).expand(sel.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


def select_active_rays(res_ray, min_abs, fg_mask, ray_mask, th: float,
                       n_active: int) -> torch.Tensor:
    """(B, n_active) indices of the fine phase's rays: foreground rays and
    rays whose chord nears the surface (min |SDF| < 5·th) first, then by
    |residual|.  A stable descending sort keeps equal scores in index
    order, as `jax.lax.top_k` does; ties are common, since the residual is
    clamped to ±0.30."""
    interact = fg_mask | (min_abs < 5.0 * th)
    score = torch.where(ray_mask, 1e3 * interact.float() + torch.abs(res_ray), -1.0)
    return torch.sort(score, dim=-1, descending=True, stable=True)[1][:, :n_active]


def _gn_iteration(decoder, cfg: ReconConfig, compute_dtype, carry, rays,
                  ray_mask, depth_obs, fg_mask, pts_surface, pts_mask,
                  n_samples: int, group=None, span=timers.OFF):
    """One batched GN iteration over the given ray set at the given sample
    density.  carry = (t_obj_cam, code, good, loss, res_ray, min_abs).
    `group`: the ranks that split the decoder rows (pts_surface is this
    rank's share).  `span`: the iteration's `recon.gn` span, given the
    render term's Jacobian slots and live rows of this rank."""
    t_obj_cam, code, good, loss_prev = carry[:4]
    B, L = code.shape
    t_co = lie.inv_sim3(t_obj_cam)
    scale = lie.sim3_scale(t_co)
    d_center = t_co[:, 2, 3]
    d_max = d_center + scale
    if cfg.chord_sampling:
        sampled, hit = losses.chord_sample_depths(t_obj_cam, rays, n_samples)
    else:
        frac = torch.linspace(0.0, 1.0, n_samples, device=code.device)
        sampled = (d_center - scale)[:, None] + (2.0 * scale)[:, None] * frac
        hit = torch.ones_like(ray_mask)
    depth_eff = torch.where(fg_mask, depth_obs, (1.1 * d_max)[:, None])

    sdf_t = losses.compute_sdf_loss(decoder, pts_surface, pts_mask, t_obj_cam,
                                    code, compute_dtype)
    rr_sdf = robust.robust_residuals(sdf_t.res, cfg.b2, sdf_t.mask)[0]
    ren = losses.compute_render_loss(
        decoder, rays, ray_mask & hit, depth_eff, t_obj_cam, sampled, code,
        th=cfg.cut_off_threshold, max_grad_points=cfg.max_grad_points,
        max_valid_samples=cfg.max_valid_samples,
        fast_value_pass=cfg.fast_value_pass, compute_dtype=compute_dtype,
        d_max=d_max,   # same far plane as depth_eff: background residual 0
        group=group)
    rr_ren = robust.robust_residuals(ren.res, cfg.b1, ren.mask)[0]
    drot, res_rot = losses.compute_rotation_loss_sim3(t_obj_cam)

    # normal equations and solve (reference :163-186): the span `recon.normal`,
    # 7 + L unknowns an object over J's rows of each term, `path` the route
    # ("kernels" or "ops")
    with timers.span("recon.normal", params=7 + L,
                     rows={"sdf": sdf_t.jac_pose.shape[-2], "render": ren.jac_pose.shape[-2]},
                     path=normal_solve.route(code.device, 7 + L)):
        dx, info, loss = normal_solve.solve(
            cfg, code, (sdf_t.jac_pose, sdf_t.jac_code, sdf_t.mask, rr_sdf),
            (ren.jac_pose, ren.jac_code, ren.mask, rr_ren), drot, res_rot, group, span)
    t_new = lie.exp_sim3(cfg.learning_rate * dx[:, :7]) @ t_obj_cam
    code_new = code + cfg.learning_rate * dx[:, 7:]
    ok = (good & torch.isfinite(loss) & torch.isfinite(dx).all(-1) & (info == 0)
          & (ren.n_valid >= 10))
    return (torch.where(ok[:, None, None], t_new, t_obj_cam),
            torch.where(ok[:, None], code_new, code), ok,
            torch.where(ok, loss, loss_prev), ren.res_ray, ren.min_abs_sdf)


@torch.no_grad()
def reconstruct_objects_batched(decoder, cfg: ReconConfig, t_cam_obj,
                                pts_surface, pts_mask, rays, ray_mask,
                                depth_obs, fg_mask, code_init=None,
                                compute_dtype=torch.float32, group=None) -> ReconResult:
    """Joint Sim(3) pose + shape code GN fit of B objects at once.

    Args (tensors on the decoder's device):
      t_cam_obj: (B, 4, 4) initial object-to-camera Sim(3).
      pts_surface: (B, N, 3) surface points in camera frame, pts_mask (B, N).
      rays: (B, R, 3) ray directions (camera frame), ray_mask (B, R);
        depth_obs: (B, R) observed depths of foreground rays (background
        depth is recomputed to 1.1·d_max each iteration, reference :128);
        fg_mask: (B, R) foreground flags.
      code_init: optional (B, L) start codes (zero if None).
      group: a process group whose ranks split each object's decoder rows
        (every rank passes the whole batch and gets the whole result).

    The fit is the span `recon.fit` (attributes `B`, `latent` L), with the
    decoder rows and launches of each kernel inside it (`ops/cuda/mlp_sdf.py`'s
    `ROWS`, `LAUNCHES`); each GN iteration a `recon.gn` inside it, and in
    each its normal equations and solve a `recon.normal`.
    """
    B = t_cam_obj.shape[0]
    with timers.span("recon.fit", B=B, latent=cfg.code_len) as fit:
        fit.count("rows", mlp_sdf.ROWS)
        fit.count("launches", mlp_sdf.LAUNCHES)
        dev = decoder.device
        L = cfg.code_len
        code0 = (torch.zeros(B, L, device=dev) if code_init is None
                 else code_init[:, :L].float())
        t_obj_cam0 = lie.inv_sim3(t_cam_obj.float())
        M = cfg.num_depth_samples
        nc = min(cfg.coarse_iterations, cfg.num_iterations) if cfg.coarse_samples > 0 else 0
        R = rays.shape[1]
        if group is not None:   # this rank's share of the surface points
            start, stop, n_pad = dist.shard_range(pts_surface.shape[1], group)
            pts_surface = dist.pad_rows(pts_surface, n_pad, 1).narrow(1, start, stop - start)
            pts_mask = dist.pad_rows(pts_mask, n_pad, 1, False).narrow(1, start, stop - start)

        def step(carry, rays_p, mask_p, depth_p, fg_p, n_samples, phase):
            with timers.span("recon.gn", phase=phase, samples=n_samples,
                             rays=rays_p.shape[1]) as sp:
                return _gn_iteration(decoder, cfg, compute_dtype, carry, rays_p, mask_p,
                                     depth_p, fg_p, pts_surface, pts_mask, n_samples, group, sp)

        carry = (t_obj_cam0, code0, torch.ones(B, dtype=torch.bool, device=dev),
                 torch.zeros(B, device=dev), torch.zeros(B, R, device=dev),
                 torch.full((B, R), torch.inf, device=dev))
        for _ in range(nc):      # coarse phase: all rays, reduced depth density
            carry = step(carry, rays, ray_mask, depth_obs, fg_mask, cfg.coarse_samples, "coarse")
        rays_f, mask_f, depth_f, fg_f = rays, ray_mask, depth_obs, fg_mask
        if nc > 0 and cfg.active_ray_fraction < 1.0:
            R_act = max(int(math.ceil(R * cfg.active_ray_fraction)), 1)
            sel = select_active_rays(carry[4], carry[5], fg_mask, ray_mask,
                                     cfg.cut_off_threshold, R_act)
            rays_f, mask_f, depth_f, fg_f = (_gather_rays(x, sel) for x in
                                             (rays, ray_mask, depth_obs, fg_mask))
        if cfg.num_iterations > nc:
            R_f = rays_f.shape[1]
            carry = carry[:4] + (torch.zeros(B, R_f, device=dev),
                                 torch.full((B, R_f), torch.inf, device=dev))
            for _ in range(nc, cfg.num_iterations):
                carry = step(carry, rays_f, mask_f, depth_f, fg_f, M, "fine")
        t_obj_cam, code, good, loss = carry[:4]
        return ReconResult(lie.inv_sim3(t_obj_cam), code, good, loss)


def reconstruct_object(decoder, cfg: ReconConfig, t_cam_obj, pts_surface,
                       pts_mask, rays, ray_mask, depth_obs, fg_mask,
                       code_init=None, compute_dtype=torch.float32) -> ReconResult:
    """One object's fit: `reconstruct_objects_batched` over a batch of one.
    Shapes as there without the leading B."""
    args = (t_cam_obj, pts_surface, pts_mask, rays, ray_mask, depth_obs, fg_mask)
    out = reconstruct_objects_batched(
        decoder, cfg, *(a[None] for a in args),
        code_init=None if code_init is None else code_init[None],
        compute_dtype=compute_dtype)
    return ReconResult(*(x[0] for x in out))


@torch.no_grad()
def estimate_pose_cam_obj(decoder, cfg: ReconConfig, t_co_se3, scale, pts,
                          pts_mask, code, compute_dtype=torch.float32):
    """Pose-only SE(3) GN on the SDF term (reference `optimizer.py:46-87`).

    `t_co_se3` (…, 4, 4) SE(3); `scale` (…,) folds into the rotation block
    for the optimization and is removed again at the end (reference :54-56,
    :84-86).  Inliers are re-gated at iteration 4 (|res| ≤ 0.05, reference
    :77-79).  Returns (t_cam_obj SE(3), final mean robust SDF loss).
    """
    scale = torch.as_tensor(scale, dtype=torch.float32, device=t_co_se3.device)
    t_cam_obj = t_co_se3.float().clone()
    t_cam_obj[..., :3, :3] *= scale[..., None, None]
    t_oc = lie.inv_sim3(t_cam_obj)
    mask = pts_mask
    loss = torch.zeros(t_oc.shape[:-2], device=t_oc.device)
    eye = torch.eye(6, device=t_oc.device)
    for e in range(cfg.pose_only_iterations):
        sdf_t = losses.compute_sdf_loss(decoder, pts, mask, t_oc, code, compute_dtype)
        _, sdf_loss, _ = robust.robust_residuals(sdf_t.res, 0.05, mask)
        J = torch.where(mask[..., None], sdf_t.jac_pose[..., :6], 0.0)
        n = torch.clamp_min(mask.sum(-1), 1).float()[..., None]
        H = (J.transpose(-1, -2) @ J) / n[..., None] + 1e-2 * eye
        b = -(J.transpose(-1, -2) @ torch.where(mask, sdf_t.res, 0.0)[..., None])[..., 0] / n
        dx, info = torch.linalg.solve_ex(H, b)
        t_new = lie.exp_se3(dx) @ t_oc
        if e == 4:
            mask = mask & (torch.abs(sdf_t.res) <= 0.05)
        ok = torch.isfinite(dx).all(-1) & (info == 0)
        t_oc = torch.where(ok[..., None, None], t_new, t_oc)
        loss = torch.where(ok, sdf_loss, loss)
    t_cam_obj = lie.inv_sim3(t_oc)
    t_cam_obj[..., :3, :3] /= scale[..., None, None]
    return t_cam_obj, loss


@torch.no_grad()
def mean_sdf_loss(decoder, pts_obj, mask, code, compute_dtype=torch.float32):
    """Mean SDF over live object-frame points (reference
    `optimizer.py:207-213`)."""
    vals = decoder.query(code, pts_obj, compute_dtype)
    n = torch.clamp_min(mask.sum(-1), 1)
    return torch.sum(torch.where(mask, vals, 0.0), dim=-1) / n
