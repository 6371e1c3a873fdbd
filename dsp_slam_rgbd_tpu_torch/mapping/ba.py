"""Bundle adjustment: batched Schur-complement Gauss-Newton with LM control.

Counterpart of `dsp_slam_rgbd_tpu/mapping/ba.py` (the reference's g2o
solvers, `src/Optimizer.cc` / `Optimizer_util.cc`):

  * `local_ba`: LocalBundleAdjustment / LocalJointBundleAdjustment
    (`Optimizer_util.cc:309-771`): KF SE(3) vertices, marginalized point
    vertices, object SE(3) vertices with relative-pose edges (error
    log(Z⁻¹·T_cw·T_wo), information 1e3·I₆, Huber δ = √(0.10·1e3)),
    fixed-frontier keyframes, two stages with χ² gating between them;
  * `global_ba`: the same machinery over a whole (small) map;
  * `global_ba_pcg`: the at-scale path, the reduced system solved
    matrix-free by block-Jacobi-preconditioned CG.

Observations are COO triplets with static capacity and masks.  The LM and
CG loops are Python loops over tensors: accept/reject by `torch.where`,
solves by `linalg.solve_ex`/`inv_ex`, non-finite steps zeroed, and no host
read anywhere.  Normal-equation assembly scatters with
`ops/scatter.py::index_add`, which sums in source order on every device:
two runs give the same bits, and the card gives the CPU's.  The scatters'
index arrays stay fixed through a problem's LM and CG iterations, so their
plans are built once per problem (`_dense_plans`, `_pcg_plans`).

Sharded edges (`parallel/sharded_ba.py`): with `group=`, the edge arrays
of the problem are this rank's share and the state is replicated.  Every
edge-derived sum crosses the group: one all_reduce merges the assembled
blocks (and, in PCG, one more the Schur corrections, one per CG matvec
side, one the back-substitution), the robust cost is summed over it, and
every rank takes the same step.  Gating stays edgewise and shard-local.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dsp_slam_rgbd_tpu_torch.ops import camera as cam_ops
from dsp_slam_rgbd_tpu_torch.ops import lie
from dsp_slam_rgbd_tpu_torch.ops import scatter
from dsp_slam_rgbd_tpu_torch.parallel import distributed as dist

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
OBJ_INFO = 1.0e3                     # information of object edges (1e3·I6)
OBJ_HUBER = (0.10 * 1.0e3) ** 0.5    # Huber δ (reference :80-84)
OBJ_CHI2_PRUNE = 1.0e3               # object-edge prune threshold (:647-657)
# Huber δ of the reprojection edges: the f32 square roots of the f32
# thresholds, as the JAX package takes them
DELTA_MONO = float(np.sqrt(np.float32(CHI2_MONO)))
DELTA_STEREO = float(np.sqrt(np.float32(CHI2_STEREO)))


class BAProblem(NamedTuple):
    """Static-capacity BA problem. K poses, P points, O objects."""
    kf_pose: torch.Tensor      # (K, 4, 4) T_cw
    kf_fixed: torch.Tensor     # (K,) bool — fixed frontier / first KF
    kf_valid: torch.Tensor     # (K,) bool
    pts: torch.Tensor          # (P, 3) world
    pt_valid: torch.Tensor     # (P,) bool
    # reprojection edges (N,)
    obs_kf: torch.Tensor       # (N,) int -> K
    obs_pt: torch.Tensor       # (N,) int -> P
    obs_uv: torch.Tensor       # (N, 3) (u, v, uR); uR = −1 for mono edges
    obs_info: torch.Tensor     # (N,) 1/σ² per edge
    obs_mask: torch.Tensor     # (N,) bool
    # object pose edges (M,)
    obj_pose: torch.Tensor     # (O, 4, 4) T_wo
    obj_valid: torch.Tensor    # (O,) bool
    oobs_kf: torch.Tensor      # (M,) int -> K
    oobs_obj: torch.Tensor     # (M,) int -> O
    oobs_t_co: torch.Tensor    # (M, 4, 4) measured camera→object SE(3)
    oobs_mask: torch.Tensor    # (M,) bool


class BAResult(NamedTuple):
    kf_pose: torch.Tensor
    pts: torch.Tensor
    obj_pose: torch.Tensor
    obs_mask: torch.Tensor     # post-gating reprojection inliers
    oobs_mask: torch.Tensor    # post-gating object edges
    cost: torch.Tensor


def _reproj_terms(cam, prob: BAProblem):
    """Per-edge residuals res (N, 3), J_c (N, 3, 6), J_p (N, 3, 3) and the
    row mask (N, 3) (third row zeroed for mono edges)."""
    Tk = prob.kf_pose[prob.obs_kf.long()]           # (N, 4, 4)
    pw = prob.pts[prob.obs_pt.long()]               # (N, 3)
    pc = torch.einsum("nij,nj->ni", Tk[:, :3, :3], pw) + Tk[:, :3, 3]
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    zi = 1.0 / torch.clamp_min(z, 1e-6)
    zi2 = zi * zi
    u = cam.fx * x * zi + cam.cx
    v = cam.fy * y * zi + cam.cy
    ur = u - cam.bf * zi
    res = torch.stack([u, v, ur], dim=-1) - prob.obs_uv
    stereo = prob.obs_uv[:, 2] >= 0.0
    one = torch.ones_like(stereo)
    row_mask = torch.stack([one, one, stereo], dim=-1).float()
    res = res * row_mask

    zero = torch.zeros_like(z)
    du = torch.stack([cam.fx * zi, zero, -cam.fx * x * zi2], dim=-1)
    dv = torch.stack([zero, cam.fy * zi, -cam.fy * y * zi2], dim=-1)
    dur = du + torch.stack([zero, zero, cam.bf * zi2], dim=-1)
    dpred_dpc = torch.stack([du, dv, dur], dim=-2) * row_mask[..., None]  # (N, 3, 3)
    Jc = torch.einsum("ndk,nkj->ndj", dpred_dpc, lie.points_to_pose_jacobian_se3(pc))
    Jp = torch.einsum("ndk,nkj->ndj", dpred_dpc, Tk[:, :3, :3])
    return res, Jc, Jp, row_mask


def _object_terms(prob: BAProblem):
    """Object relative-pose edges e = log(Z⁻¹ · T_cw · T_wo) ∈ se(3) with
    the Jacobians wrt left perturbations of T_cw (Ad(Z⁻¹), the reference's
    first-order J_l⁻¹ ≈ I) and of T_wo (Ad(Z⁻¹)·Ad(T_cw))."""
    Tk = prob.kf_pose[prob.oobs_kf.long()]          # (M, 4, 4) T_cw
    To = prob.obj_pose[prob.oobs_obj.long()]        # (M, 4, 4) T_wo
    Z_inv = lie.inv_se3(prob.oobs_t_co)
    T_co = torch.einsum("nij,njk->nik", Tk, To)
    e = lie.log_se3(torch.einsum("nij,njk->nik", Z_inv, T_co))   # (M, 6)
    Ad_Zinv = lie.adjoint_se3(Z_inv)
    Jo = torch.einsum("nij,njk->nik", Ad_Zinv, lie.adjoint_se3(Tk))
    return e, Ad_Zinv, Jo


def _edge_weights(prob: BAProblem, res):
    """(χ², Huber-weighted information w) of the reprojection edges."""
    chi2 = torch.sum(res * res, dim=-1) * prob.obs_info
    en = torch.sqrt(torch.clamp_min(chi2, 1e-12))
    stereo = prob.obs_uv[:, 2] >= 0.0
    delta = torch.where(stereo, DELTA_STEREO, DELTA_MONO)
    w_rob = torch.where(en <= delta, 1.0, delta / en)
    w = prob.obs_info * w_rob * prob.obs_mask
    w = w * prob.pt_valid[prob.obs_pt.long()] * prob.kf_valid[prob.obs_kf.long()]
    return chi2, w


def _object_weights(prob: BAProblem, e_o):
    chi2_o = OBJ_INFO * torch.sum(e_o * e_o, dim=-1)
    en_o = torch.sqrt(torch.clamp_min(chi2_o, 1e-12))
    w_rob_o = torch.where(en_o <= OBJ_HUBER, 1.0, cam_ops.rdiv(OBJ_HUBER, en_o))
    w_o = OBJ_INFO * w_rob_o * prob.oobs_mask \
        * prob.obj_valid[prob.oobs_obj.long()] * prob.kf_valid[prob.oobs_kf.long()]
    return chi2_o, w_o


class BAPlans(NamedTuple):
    """The scatter plans of one problem's fixed index arrays (`ops/scatter.py`):
    reprojection edges onto the B = K + O pose blocks and onto the P points,
    object edges onto their keyframe and object blocks, and, for the dense
    reduced system only, the flat (kf, pt) and (block, block) pairs.  They
    sum the edges whose mask is set when the problem is built: a masked
    edge's weight is 0 through every iteration (the gate only clears
    masks), and the bucket's padding rows, all aimed at block 0 and point
    0, would make one long serial segment there."""
    kf: scatter.ScatterPlan
    pt: scatter.ScatterPlan
    okf: scatter.ScatterPlan
    oobj: scatter.ScatterPlan
    kf_pt: scatter.ScatterPlan | None = None
    pairs: scatter.ScatterPlan | None = None


def _object_index(prob: BAProblem):
    """(object edges' keyframe blocks, their object blocks K+o)."""
    return prob.oobs_kf.long(), prob.kf_pose.shape[0] + prob.oobs_obj.long()


def _pcg_plans(prob: BAProblem) -> BAPlans:
    B = prob.kf_pose.shape[0] + prob.obj_pose.shape[0]
    okf, oobj = _object_index(prob)
    m, om = prob.obs_mask, prob.oobs_mask
    return BAPlans(scatter.plan(prob.obs_kf, B, m),
                   scatter.plan(prob.obs_pt, prob.pts.shape[0], m),
                   scatter.plan(okf, B, om), scatter.plan(oobj, B, om))


def _dense_plans(prob: BAProblem) -> BAPlans:
    P = prob.pts.shape[0]
    B = prob.kf_pose.shape[0] + prob.obj_pose.shape[0]
    okf, oobj = _object_index(prob)
    return _pcg_plans(prob)._replace(
        kf_pt=scatter.plan(prob.obs_kf.long() * P + prob.obs_pt.long(), B * P, prob.obs_mask),
        pairs=scatter.plan(torch.cat([okf * B + oobj, oobj * B + okf]), B * B,
                           prob.oobs_mask.repeat(2)))


def _object_blocks(prob: BAProblem, plans: BAPlans):
    """The object edges' terms.  Returns (edge keyframe blocks, edge object
    blocks K+o, the coupling blocks Jkᵀ·w·Jo (M, 6, 6), the edges' χ², the
    (plan, src) scatters of their diagonal blocks onto Hcc and of their
    gradients onto bc, each to follow the reprojection edges' scatter onto
    the same output (`scatter.scatter_adds`))."""
    e_o, Jk_o, Jo_o = _object_terms(prob)
    chi2_o, w_o = _object_weights(prob, e_o)
    okf, oobj = _object_index(prob)
    onto_H = ((plans.okf, torch.einsum("ndi,ndj,n->nij", Jk_o, Jk_o, w_o)),
              (plans.oobj, torch.einsum("ndi,ndj,n->nij", Jo_o, Jo_o, w_o)))
    onto_b = ((plans.okf, -torch.einsum("ndi,nd->ni", Jk_o, e_o * w_o[:, None])),
              (plans.oobj, -torch.einsum("ndi,nd->ni", Jo_o, e_o * w_o[:, None])))
    return okf, oobj, torch.einsum("ndi,ndj,n->nij", Jk_o, Jo_o, w_o), chi2_o, onto_H, onto_b


def _fixed_blocks(prob: BAProblem):
    """(B,) bool: fixed keyframes, invalid keyframes and invalid objects
    take no update."""
    return torch.cat([prob.kf_fixed | ~prob.kf_valid, ~prob.obj_valid])


def _apply_step(prob: BAProblem, dx, dp):
    K = prob.kf_pose.shape[0]
    return prob._replace(kf_pose=lie.exp_se3(dx[:K]) @ prob.kf_pose,
                         obj_pose=lie.exp_se3(dx[K:]) @ prob.obj_pose,
                         pts=prob.pts + dp)


def _point_step(Hpp_inv, rhs, pt_live):
    """dp = Hpp⁻¹·rhs, zeroed on dead points and non-finite rows."""
    dp = torch.einsum("pij,pj->pi", Hpp_inv, rhs)
    return torch.where(pt_live[:, None] & torch.all(torch.isfinite(dp), dim=-1, keepdim=True),
                       dp, 0.0)


def _hpp_inverse(Hpp, pt_live):
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    Hpp_d = torch.where(pt_live[:, None, None], Hpp + 1e-6 * eye3, eye3)
    return torch.linalg.inv_ex(Hpp_d)[0]


def _assemble_and_solve(cam, prob: BAProblem, damping, group=None, plans=None):
    """One GN step over (K+O) pose blocks with marginalized points.
    `damping`: the LM λ (a float or a 0-d tensor).  Returns (stepped
    problem, cost at the input state).  `group`: the ranks whose edge
    shards are summed (one all_reduce of the assembled blocks).  `plans`:
    `_dense_plans(prob)` (built here if not given)."""
    plans = _dense_plans(prob) if plans is None else plans
    K = prob.kf_pose.shape[0]
    P = prob.pts.shape[0]
    O = prob.obj_pose.shape[0]
    B = K + O
    obs_kf, obs_pt = prob.obs_kf.long(), prob.obs_pt.long()

    res, Jc, Jp, _ = _reproj_terms(cam, prob)
    chi2, w = _edge_weights(prob, res)

    JcT_Jc = torch.einsum("ndi,ndj,n->nij", Jc, Jc, w)
    JpT_Jp = torch.einsum("ndi,ndj,n->nij", Jp, Jp, w)
    JcT_Jp = torch.einsum("ndi,ndj,n->nij", Jc, Jp, w)
    JcT_r = torch.einsum("ndi,nd,n->ni", Jc, res, w)
    JpT_r = torch.einsum("ndi,nd,n->ni", Jp, res, w)

    # object edges couple pose blocks k and K+o inside the reduced system;
    # each (kf, pt) pair occurs at most once: a flat accumulate on (B·P)
    _, _, ko, chi2_o, onto_H, onto_b = _object_blocks(prob, plans)
    Hcc, bc, Hpp, bp, Hcp, S = scatter.scatter_adds(
        (B, (plans.kf, JcT_Jc), *onto_H), (B, (plans.kf, -JcT_r), *onto_b),
        (P, (plans.pt, JpT_Jp)), (P, (plans.pt, -JpT_r)), (B * P, (plans.kf_pt, JcT_Jp)),
        (B * B, (plans.pairs, torch.cat([ko, ko.transpose(-1, -2)]))))
    Hcp, S = Hcp.view(B, P, 6, 3), S.view(B, B, 6, 6)
    live = prob.obs_mask & prob.pt_valid[obs_pt] & prob.kf_valid[obs_kf]
    cost = torch.sum(torch.where(live, chi2, 0.0)) \
        + torch.sum(torch.where(prob.oobs_mask, chi2_o, 0.0))
    if group is not None:
        Hcc, bc, Hpp, bp, Hcp, S, cost = dist.psum((Hcc, bc, Hpp, bp, Hcp, S, cost), group)

    # marginalize points: S −= Hcp Hpp⁻¹ Hcpᵀ ; bc −= Hcp Hpp⁻¹ bp, with the
    # (B·6)² product as one f32 matmul in the flattened [block, row] layout
    pt_live = prob.pt_valid
    Hpp_inv = _hpp_inverse(Hpp, pt_live)
    HcpHinv = torch.einsum("bpij,pjk->bpik", Hcp, Hpp_inv)            # (B, P, 6, 3)
    schur = HcpHinv.permute(0, 2, 1, 3).reshape(B * 6, P * 3) \
        @ Hcp.permute(0, 2, 1, 3).reshape(B * 6, P * 3).T
    bc_red = bc - torch.einsum("bpik,pk->bi", HcpHinv, bp)
    eyeB = torch.eye(B, dtype=Hcc.dtype, device=Hcc.device)
    Sd = S.permute(0, 2, 1, 3).reshape(B * 6, B * 6) - schur \
        + (eyeB[:, None, :, None] * Hcc[:, :, None, :]).reshape(B * 6, B * 6)

    # fixed blocks: identity rows, no update; LM multiplicative damping
    fix6 = torch.repeat_interleave(_fixed_blocks(prob), 6)
    Sd = torch.where(fix6[:, None] | fix6[None, :], 0.0, Sd)
    dg = torch.clamp_min(torch.diagonal(Sd), 1e-6)
    Sd = Sd + torch.diag(torch.where(fix6, 1.0, damping * dg + 1e-4))
    bflat = torch.where(fix6, 0.0, bc_red.reshape(B * 6))

    dx = torch.linalg.solve_ex(Sd, bflat)[0]
    dx = torch.where(torch.isfinite(dx), dx, 0.0).reshape(B, 6)

    # back-substitute points: dp = Hpp⁻¹ (bp − Hcpᵀ dc)
    Hcp_dc = torch.einsum("bpik,bi->pk", Hcp, dx)
    dp = _point_step(Hpp_inv, bp - Hcp_dc, pt_live)
    return _apply_step(prob, dx, dp), cost


def _gate(cam, prob: BAProblem):
    """χ² outlier gating of both edge types (reference :647-736), with the
    reference's positive-depth requirement."""
    res, _, _, _ = _reproj_terms(cam, prob)
    chi2 = torch.sum(res * res, dim=-1) * prob.obs_info
    stereo = prob.obs_uv[:, 2] >= 0.0
    th = torch.where(stereo, CHI2_STEREO, CHI2_MONO)
    Tk = prob.kf_pose[prob.obs_kf.long()]
    pc = torch.einsum("nij,nj->ni", Tk[:, :3, :3], prob.pts[prob.obs_pt.long()]) \
        + Tk[:, :3, 3]
    obs_mask = prob.obs_mask & (chi2 <= th) & (pc[:, 2] > 0)

    e_o, _, _ = _object_terms(prob)
    chi2_o = OBJ_INFO * torch.sum(e_o * e_o, dim=-1)
    oobs_mask = prob.oobs_mask & (chi2_o <= OBJ_CHI2_PRUNE)
    return prob._replace(obs_mask=obs_mask, oobs_mask=oobs_mask)


def _robust_cost(cam, prob: BAProblem, group=None):
    """Huber-robustified total cost — the LM acceptance metric (summed
    over the edge shards of `group`)."""
    res, _, _, _ = _reproj_terms(cam, prob)
    chi2 = torch.sum(res * res, dim=-1) * prob.obs_info
    en = torch.sqrt(torch.clamp_min(chi2, 1e-12))
    stereo = prob.obs_uv[:, 2] >= 0.0
    delta = torch.where(stereo, DELTA_STEREO, DELTA_MONO)
    rho = torch.where(en <= delta, chi2, 2.0 * delta * en - delta * delta)
    live = prob.obs_mask & prob.pt_valid[prob.obs_pt.long()] \
        & prob.kf_valid[prob.obs_kf.long()]
    e_o, _, _ = _object_terms(prob)
    chi2_o = OBJ_INFO * torch.sum(e_o * e_o, dim=-1)
    en_o = torch.sqrt(torch.clamp_min(chi2_o, 1e-12))
    rho_o = torch.where(en_o <= OBJ_HUBER, chi2_o,
                        2.0 * OBJ_HUBER * en_o - OBJ_HUBER * OBJ_HUBER)
    live_o = prob.oobs_mask & prob.obj_valid[prob.oobs_obj.long()] \
        & prob.kf_valid[prob.oobs_kf.long()]
    cost = torch.sum(torch.where(live, rho, 0.0)) + torch.sum(torch.where(live_o, rho_o, 0.0))
    return cost if group is None else dist.psum([cost], group)[0]


def _lm_run(cam, prob: BAProblem, n: int, damping: float, step_fn, group=None):
    """n Levenberg-Marquardt iterations: a step is accepted only if the
    Huber cost does not rise (λ halves), otherwise the state is kept and λ
    grows 8×.  Returns (problem, cost)."""
    lam = torch.full((), damping, dtype=torch.float32, device=prob.kf_pose.device)
    cost = _robust_cost(cam, prob, group)
    for _ in range(n):
        cand, _ = step_fn(prob, lam)
        cost_c = _robust_cost(cam, cand, group)
        accept = cost_c <= cost
        prob = BAProblem(*[torch.where(accept, a, b) for a, b in zip(cand, prob)])
        lam = torch.where(accept, torch.clamp_min(lam * 0.5, 1e-5),
                          torch.clamp_max(lam * 8.0, 1e3))
        cost = torch.where(accept, cost_c, cost)
    return prob, cost


def _two_stage(cam, prob: BAProblem, stage1_iters: int, stage2_iters: int,
               damping: float, step_fn, group=None) -> BAResult:
    prob, _ = _lm_run(cam, prob, stage1_iters, damping, step_fn, group)
    prob = _gate(cam, prob)
    prob, cost = _lm_run(cam, prob, stage2_iters, damping, step_fn, group)
    prob = _gate(cam, prob)
    return BAResult(prob.kf_pose, prob.pts, prob.obj_pose, prob.obs_mask,
                    prob.oobs_mask, cost)


def local_ba(cam, prob: BAProblem, stage1_iters: int = 5,
             stage2_iters: int = 10, damping: float = 1e-3, group=None) -> BAResult:
    """Two-stage robust BA (reference `LocalJointBundleAdjustment`
    :309-771: 5 iterations → gate outliers → 10 iterations → final gate),
    each stage true Levenberg-Marquardt on the dense reduced system.
    `group`: the ranks whose edge shards `prob` holds (the result's edge
    masks are then this rank's share)."""
    plans = _dense_plans(prob)
    return _two_stage(cam, prob, stage1_iters, stage2_iters, damping,
                      lambda p, lam: _assemble_and_solve(cam, p, lam, group, plans), group)


def global_ba(cam, prob: BAProblem, n_iters: int = 20, damping: float = 1e-3) -> BAResult:
    """Global (joint) BA on the dense reduced system (reference
    `GlobalJointBundleAdjustemnt`, `Optimizer_util.cc:36-42`): for small
    maps (≲ 100 pose blocks); `global_ba_pcg` is the at-scale path."""
    return local_ba(cam, prob, stage1_iters=n_iters // 2,
                    stage2_iters=n_iters - n_iters // 2, damping=damping)


# ---------------------------------------------------------------------------
# Matrix-free PCG Schur solver — the at-scale global BA path.  The reduced
# system S is never formed: every S·x product is edgewise gathers/scatters
# over the COO observation list (O(N) work and memory), preconditioned with
# the exact Schur block diagonal (exact because each (kf, pt) pair appears
# at most once).
# ---------------------------------------------------------------------------


def _pcg_gn_step(cam, prob: BAProblem, damping, cg_iters: int, group=None, plans=None):
    """One GN step of the reduced (pose+object) system via PCG.  Returns
    (stepped problem, cost at the input state).  `plans`: `_pcg_plans(prob)`
    (built here if not given).

    `group` (JAX `axis`, `mapping/ba.py:345-356`): the edge arrays of
    `prob` are this rank's share, and every edge-derived sum crosses the
    group: one all_reduce merges the normal-equation blocks, one the
    edgewise Schur corrections, two each CG matvec's coupling terms (the
    point side, then the pose side), one the back-substitution and one
    the cost.  Pose and point state stay replicated."""
    def ps(*ts):
        return ts if group is None else dist.psum(ts, group)

    plans = _pcg_plans(prob) if plans is None else plans
    K = prob.kf_pose.shape[0]
    P = prob.pts.shape[0]
    O = prob.obj_pose.shape[0]
    B = K + O
    obs_kf, obs_pt = prob.obs_kf.long(), prob.obs_pt.long()

    res, Jc, Jp, _ = _reproj_terms(cam, prob)
    chi2, w = _edge_weights(prob, res)

    # per-edge weighted blocks (the only O(N) state PCG needs)
    Ccc = torch.einsum("ndi,ndj,n->nij", Jc, Jc, w)   # (N, 6, 6)
    Cpp = torch.einsum("ndi,ndj,n->nij", Jp, Jp, w)   # (N, 3, 3)
    Ccp = torch.einsum("ndi,ndj,n->nij", Jc, Jp, w)   # (N, 6, 3)
    gc = torch.einsum("ndi,nd,n->ni", Jc, res, w)
    gp = torch.einsum("ndi,nd,n->ni", Jp, res, w)

    okf, oobj, ko, chi2_o, onto_H, onto_b = _object_blocks(prob, plans)
    Hcc, bc, Hpp, bp = ps(*scatter.scatter_adds(
        (B, (plans.kf, Ccc), *onto_H), (B, (plans.kf, -gc), *onto_b),
        (P, (plans.pt, Cpp)), (P, (plans.pt, -gp))))

    pt_live = prob.pt_valid
    Hpp_inv = _hpp_inverse(Hpp, pt_live)

    # reduced RHS: bc − Hcp Hpp⁻¹ bp, and the exact Schur block diagonal
    # (one edge per (kf, pt) pair), both edgewise
    hb = torch.einsum("pij,pj->pi", Hpp_inv, bp)
    contrib = torch.einsum("nij,njk,nlk->nil", Ccp, Hpp_inv[obs_pt], Ccp)
    corr_b, corr_S = ps(*scatter.scatter_adds(
        (B, (plans.kf, torch.einsum("nij,nj->ni", Ccp, hb[obs_pt]))), (B, (plans.kf, contrib))))
    bc_red = bc - corr_b

    free = ~_fixed_blocks(prob)
    Sdiag0 = Hcc - corr_S
    dvec = torch.clamp_min(torch.diagonal(Sdiag0, dim1=-2, dim2=-1), 1e-6)   # (B, 6)
    damp_vec = damping * dvec + 1e-4
    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    Sdiag = Sdiag0 + torch.diag_embed(damp_vec)
    Minv = torch.linalg.inv_ex(torch.where(free[:, None, None], Sdiag, eye6))[0]

    def matvec(x):
        x = torch.where(free[:, None], x, 0.0)
        y = torch.einsum("bij,bj->bi", Hcc, x)
        u, = ps(scatter.scatter_add(P, plans.pt, torch.einsum("nij,ni->nj", Ccp, x[obs_kf])))
        v = torch.einsum("pij,pj->pi", Hpp_inv, u)
        y_edge, = ps(*scatter.scatter_adds(
            (B, (plans.kf, -torch.einsum("nij,nj->ni", Ccp, v[obs_pt])),
             (plans.okf, torch.einsum("mij,mj->mi", ko, x[oobj])),
             (plans.oobj, torch.einsum("mij,mi->mj", ko, x[okf])))))
        y = y + y_edge + damp_vec * x
        return torch.where(free[:, None], y, 0.0)

    b = torch.where(free[:, None], bc_red, 0.0)
    x = torch.zeros_like(b)
    r = b
    z = torch.einsum("bij,bj->bi", Minv, b)
    p = z
    rz = torch.sum(b * z)
    for _ in range(cg_iters):
        Ap = matvec(p)
        alpha = rz / torch.clamp_min(torch.sum(p * Ap), 1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        z = torch.einsum("bij,bj->bi", Minv, r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.clamp_min(rz, 1e-20)
        p = z + beta * p
        rz = rz_new
    dx = torch.where(torch.isfinite(x), x, 0.0)

    # back-substitute points: dp = Hpp⁻¹ (bp − Hcpᵀ dc), edgewise
    u, = ps(scatter.scatter_add(P, plans.pt, torch.einsum("nij,ni->nj", Ccp, dx[obs_kf])))
    dp = _point_step(Hpp_inv, bp - u, pt_live)

    live = prob.obs_mask & prob.pt_valid[obs_pt] & prob.kf_valid[obs_kf]
    cost, = ps(torch.sum(torch.where(live, chi2, 0.0))
               + torch.sum(torch.where(prob.oobs_mask, chi2_o, 0.0)))
    return _apply_step(prob, dx, dp), cost


def global_ba_pcg(cam, prob: BAProblem, n_iters: int = 10,
                  cg_iters: int = 48, damping: float = 3e-3) -> BAResult:
    """Global joint BA at scale: two-stage robust LM (gate between stages,
    like the reference's 5+10 scheme), each step's reduced system solved
    matrix-free by block-Jacobi-preconditioned CG."""
    plans = _pcg_plans(prob)
    return _two_stage(cam, prob, max(n_iters // 2, 1), max(n_iters - n_iters // 2, 1),
                      damping, lambda p, lam: _pcg_gn_step(cam, p, lam, cg_iters, plans=plans))
