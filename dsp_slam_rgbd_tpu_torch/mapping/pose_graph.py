"""Sim(3)/SE(3) pose-graph optimization (essential graph).

Counterpart of `dsp_slam_rgbd_tpu/mapping/pose_graph.py` (reference
`Optimizer::OptimizeEssentialGraph`, `src/Optimizer.cc:780`: Sim3 vertices
over all keyframes, relative-Sim3 edges from the spanning tree /
covisibility / loop closures, scale fixed for stereo).

All edge residuals e = log_sim3(S_ji · S_i · S_j⁻¹) and their Jacobians
come from one `torch.func.vmap` of `torch.func.jacfwd` (exact, no
hand-derived adjoints), the normal equations assemble by scatter-add in a
fixed order (`ops/scatter.py`: the same bits on every run), and
the dense (7K, 7K) system solves in f32 by `linalg.solve_ex` (TF32 plays
no part in an LU solve).  The Levenberg-Marquardt accept/reject runs on
the device: no host sync.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from dsp_slam_rgbd_tpu_torch.ops import lie
from dsp_slam_rgbd_tpu_torch.ops import scatter


def _edge_error(xi, Si, Sj, Sji, fix_scale: bool):
    """Residual of one edge with perturbations xi = [ξi (7) | ξj (7)]."""
    if fix_scale:
        # scale component of the perturbation forced to zero
        xi = xi * (torch.arange(14, device=xi.device) % 7 != 6).to(xi.dtype)
    # (1, ·) batches: under forward AD, 0-d intermediates mixed with Python
    # scalars give f64 tangents
    Si_p = lie.exp_sim3(xi[None, :7]) @ Si
    Sj_p = lie.exp_sim3(xi[None, 7:]) @ Sj
    return lie.log_sim3(Sji @ Si_p @ lie.inv_sim3(Sj_p))[0]


def edge_errors_and_jacobians(Si, Sj, Sji, fix_scale: bool):
    """(E, 4, 4) ×3 -> (e (E, 7), J (E, 7, 14)) at zero perturbation."""
    zero = torch.zeros(14, dtype=Si.dtype, device=Si.device)

    def one(Si, Sj, Sji):
        return (_edge_error(zero, Si, Sj, Sji, fix_scale),
                jacfwd(_edge_error)(zero, Si, Sj, Sji, fix_scale))

    return vmap(one)(Si, Sj, Sji)


class PoseGraphResult(NamedTuple):
    poses: torch.Tensor   # (K, 4, 4) optimized Sim(3)
    cost: torch.Tensor


def optimize_pose_graph(poses, valid, fixed, edge_i, edge_j, edge_meas,
                        edge_mask, edge_weight=None, n_iters: int = 20,
                        fix_scale: bool = False,
                        damping: float = 1e-6) -> PoseGraphResult:
    """Levenberg-Marquardt over Sim(3) poses.

    poses: (K, 4, 4) initial Sim(3) estimates (S_cw convention, like the
    reference's vScw).  edge_meas: (E, 4, 4) measured S_ji such that ideally
    S_ji = S_j · S_i⁻¹.  fixed: (K,) bool — the loop keyframe is held.
    """
    K = poses.shape[0]
    dev = poses.device
    ei, ej = edge_i.long(), edge_j.long()
    w = edge_mask.float() * valid[ei].float() * valid[ej].float()
    if edge_weight is not None:
        w = w * edge_weight
    fix7 = torch.repeat_interleave(fixed | ~valid, 7)
    keep7 = (torch.arange(7, device=dev) != 6).float() if fix_scale \
        else torch.ones(7, device=dev)

    def edge_cost(poses):
        e, _ = edge_errors_and_jacobians(poses[ei], poses[ej], edge_meas, fix_scale)
        return torch.einsum("ed,ed,e->", e, e, w)

    # Levenberg-Marquardt (the reference optimizes the essential graph with
    # g2o's OptimizationAlgorithmLevenberg): a loop closure on a long drift
    # puts large residuals on every edge crossing the warped-group
    # boundary, where pure GN with fixed tiny damping oscillates
    lam = torch.full((), 1e-4, device=dev)
    cost_prev = edge_cost(poses)
    # the edges stay fixed through the iterations: plan their scatters once
    ii, ij, ji, jj = (scatter.plan(a * K + c, K * K)
                      for a, c in ((ei, ei), (ei, ej), (ej, ei), (ej, ej)))
    pi, pj = scatter.plan(ei, K), scatter.plan(ej, K)
    for _ in range(n_iters):
        e, J = edge_errors_and_jacobians(poses[ei], poses[ej], edge_meas, fix_scale)
        Ji, Jj = J[:, :, :7], J[:, :, 7:]
        Hij = torch.einsum("edi,edj,e->eij", Ji, Jj, w)
        H, b = scatter.scatter_adds(
            (K * K, (ii, torch.einsum("edi,edj,e->eij", Ji, Ji, w)),
             (jj, torch.einsum("edi,edj,e->eij", Jj, Jj, w)), (ij, Hij),
             (ji, Hij.transpose(-1, -2))),
            (K, (pi, -torch.einsum("edi,ed,e->ei", Ji, e, w)),
             (pj, -torch.einsum("edi,ed,e->ei", Jj, e, w))))

        Hd = H.reshape(K, K, 7, 7).permute(0, 2, 1, 3).reshape(K * 7, K * 7)
        Hd = torch.where(fix7[:, None] | fix7[None, :], 0.0, Hd)
        diag = torch.where(fix7, 1.0, damping + lam * torch.clamp_min(torch.diagonal(Hd), 1e-9))
        Hd = Hd + torch.diag(diag)
        bf = torch.where(fix7, 0.0, b.reshape(-1))
        dx = torch.linalg.solve_ex(Hd, bf)[0].reshape(K, 7) * keep7
        dx = torch.where(torch.isfinite(dx), dx, 0.0)
        cand = lie.exp_sim3(dx) @ poses
        cost_new = edge_cost(cand)
        accept = cost_new < cost_prev
        poses = torch.where(accept, cand, poses)
        lam = torch.where(accept, torch.clamp_min(lam * 0.5, 1e-8), lam * 4.0)
        cost_prev = torch.minimum(cost_new, cost_prev)
    return PoseGraphResult(poses, cost_prev)


def relative_sim3(S_j, S_i):
    """Measured S_ji from two absolute poses: S_j · S_i⁻¹."""
    return S_j @ lie.inv_sim3(S_i)
