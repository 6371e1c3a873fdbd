"""Plain global bundle adjustment over a whole map (no object edges).

The reference's global BA (`Optimizer.cc` GlobalBundleAdjustemnt, its
joint form in `Optimizer_util.cc`) as the port runs it at scale: every
valid keyframe and every observed point enters; the oldest keyframe is the
gauge anchor; a point is optimised only where its edges determine it (two
observations, or one stereo edge); Huber-robust stereo/mono reprojection
edges with information 1/1.2^(2·level); two Levenberg-Marquardt stages
(n/2 and n - n/2 steps, a step kept only where the robust cost does not
rise) with chi-square gating after each; each step's reduced pose system
solved matrix-free by block-Jacobi-preconditioned conjugate gradients
over the points' Schur complement.  Sums over edges are `index_add_`.

It reads the map's fields as the benchmark generated them (numpy arrays)
and computes in float32 with every product's operands in the precision
given (`precision.py`).  Keyframes and points stay in the map's own index
space: invalid keyframes are fixed, unobserved points have no edges.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import lie
from benchmark.reference.precision import Products, set_exact_matmul

CHI2_MONO, CHI2_STEREO = 5.991, 7.815
DELTA_MONO = float(np.sqrt(np.float32(CHI2_MONO)))
DELTA_STEREO = float(np.sqrt(np.float32(CHI2_STEREO)))


class Problem:
    """The map's edges and state on a device."""

    def __init__(self, fields: dict, cam: dict, device):
        t = lambda a, dt=None: torch.as_tensor(np.asarray(a), dtype=dt, device=device)  # noqa: E731
        if bool(np.any(fields["oobs_valid"])) or bool(np.any(fields["obj_valid"])):
            raise ValueError("the reference global BA takes maps without objects")
        kf_valid = t(fields["kf_valid"])
        pt_valid = t(fields["pt_valid"])
        fpt = t(fields["kf_feat_pt"]).long()
        sel = (fpt >= 0) & t(fields["kf_feat_valid"]) & kf_valid[:, None] \
            & pt_valid[fpt.clamp_min(0)]
        k, f = torch.nonzero(sel, as_tuple=True)       # (keyframe, feature) row-major
        self.K, self.P = kf_valid.shape[0], pt_valid.shape[0]
        self.obs_kf, self.obs_pt = k, fpt[k, f]
        self.uv = torch.cat([t(fields["kf_xy"])[k, f], t(fields["kf_ur"])[k, f][:, None]], -1)
        self.info = 1.0 / (1.2 ** (2.0 * t(fields["kf_level"])[k, f].float()))
        self.stereo = self.uv[:, 2] >= 0.0
        n_obs = torch.zeros(self.P, dtype=torch.long, device=device).index_add_(
            0, self.obs_pt, torch.ones_like(self.obs_pt))
        has_stereo = torch.zeros(self.P, dtype=torch.bool, device=device)
        has_stereo[self.obs_pt[self.stereo]] = True
        self.pt_live = pt_valid & ((n_obs >= 2) | has_stereo)
        self.observed = n_obs > 0
        frame = t(fields["kf_frame_id"]).long()
        anchor = int(torch.argmin(torch.where(kf_valid, frame, torch.iinfo(torch.long).max)))
        fixed = ~kf_valid
        fixed[anchor] = True
        self.free = ~fixed
        self.kf_valid = kf_valid
        self.cam = cam
        self.kf_pose0 = t(fields["kf_pose"]).float()
        self.pts0 = t(fields["pt_pos"]).float()


def _reproj(pm: Products, pr: Problem, kf_pose, pts):
    Tk = kf_pose[pr.obs_kf]
    pc = pm.einsum("nij,nj->ni", Tk[:, :3, :3], pts[pr.obs_pt]) + Tk[:, :3, 3]
    c = pr.cam
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    zi = 1.0 / torch.clamp_min(z, 1e-6)
    zi2 = zi * zi
    u = c["fx"] * x * zi + c["cx"]
    v = c["fy"] * y * zi + c["cy"]
    row = torch.stack([torch.ones_like(zi), torch.ones_like(zi), pr.stereo.to(zi.dtype)], -1)
    res = (torch.stack([u, v, u - c["bf"] * zi], -1) - pr.uv) * row
    zero = torch.zeros_like(z)
    du = torch.stack([c["fx"] * zi, zero, -c["fx"] * x * zi2], -1)
    dv = torch.stack([zero, c["fy"] * zi, -c["fy"] * y * zi2], -1)
    dur = du + torch.stack([zero, zero, c["bf"] * zi2], -1)
    dp = torch.stack([du, dv, dur], -2) * row[..., None]
    Jc = pm.einsum("ndk,nkj->ndj", dp, lie.pose_jacobian_se3(pc))
    Jp = pm.einsum("ndk,nkj->ndj", dp, Tk[:, :3, :3])
    return res, Jc, Jp, pc


def _chi2(pr, res):
    return torch.sum(res * res, -1) * pr.info


def _live(pr, mask):
    return mask & pr.pt_live[pr.obs_pt] & pr.kf_valid[pr.obs_kf]


def robust_cost(pm: Products, pr: Problem, kf_pose, pts, mask):
    chi2 = _chi2(pr, _reproj(pm, pr, kf_pose, pts)[0])
    en = torch.sqrt(torch.clamp_min(chi2, 1e-12))
    d = torch.where(pr.stereo, DELTA_STEREO, DELTA_MONO)
    rho = torch.where(en <= d, chi2, 2.0 * d * en - d * d)
    return torch.sum(torch.where(_live(pr, mask), rho, 0.0))


def _gate(pm, pr, kf_pose, pts, mask):
    res, _, _, pc = _reproj(pm, pr, kf_pose, pts)
    th = torch.where(pr.stereo, CHI2_STEREO, CHI2_MONO)
    return mask & (_chi2(pr, res) <= th) & (pc[:, 2] > 0)


def _scatter(n, idx, src):
    return torch.zeros((n,) + src.shape[1:], dtype=src.dtype, device=src.device) \
        .index_add_(0, idx, src)


def _pcg_step(pm: Products, pr: Problem, kf_pose, pts, mask, damping, cg_iters):
    K, P = pr.K, pr.P
    ok, op = pr.obs_kf, pr.obs_pt
    res, Jc, Jp, _ = _reproj(pm, pr, kf_pose, pts)
    chi2 = _chi2(pr, res)
    en = torch.sqrt(torch.clamp_min(chi2, 1e-12))
    d = torch.where(pr.stereo, DELTA_STEREO, DELTA_MONO)
    w = pr.info * torch.where(en <= d, 1.0, d / en) * _live(pr, mask)
    Ccc = pm.einsum("ndi,ndj,n->nij", Jc, Jc, w)
    Cpp = pm.einsum("ndi,ndj,n->nij", Jp, Jp, w)
    Ccp = pm.einsum("ndi,ndj,n->nij", Jc, Jp, w)
    gc = pm.einsum("ndi,nd,n->ni", Jc, res, w)
    gp = pm.einsum("ndi,nd,n->ni", Jp, res, w)
    Hcc, bc = _scatter(K, ok, Ccc), -_scatter(K, ok, gc)
    Hpp, bp = _scatter(P, op, Cpp), -_scatter(P, op, gp)
    eye3 = torch.eye(3, device=Hpp.device)
    Hpp_inv = torch.linalg.inv_ex(torch.where(pr.pt_live[:, None, None], Hpp + 1e-6 * eye3,
                                              eye3))[0]
    hb = pm.einsum("pij,pj->pi", Hpp_inv, bp)
    contrib = pm.einsum("nij,njk,nlk->nil", Ccp, Hpp_inv[op], Ccp)
    bc_red = bc - _scatter(K, ok, pm.einsum("nij,nj->ni", Ccp, hb[op]))
    S0 = Hcc - _scatter(K, ok, contrib)
    free = pr.free
    damp = damping * torch.clamp_min(torch.diagonal(S0, dim1=-2, dim2=-1), 1e-6) + 1e-4
    eye6 = torch.eye(6, device=S0.device)
    Minv = torch.linalg.inv_ex(torch.where(free[:, None, None], S0 + torch.diag_embed(damp),
                                           eye6))[0]

    def matvec(x):
        x = torch.where(free[:, None], x, 0.0)
        u = _scatter(P, op, pm.einsum("nij,ni->nj", Ccp, x[ok]))
        v = pm.einsum("pij,pj->pi", Hpp_inv, u)
        y = pm.einsum("bij,bj->bi", Hcc, x) - _scatter(K, ok, pm.einsum("nij,nj->ni", Ccp, v[op])) \
            + damp * x
        return torch.where(free[:, None], y, 0.0)

    b = torch.where(free[:, None], bc_red, 0.0)
    x = torch.zeros_like(b)
    r = b
    z = pm.einsum("bij,bj->bi", Minv, b)
    p, rz = z, torch.sum(b * z)
    for _ in range(cg_iters):
        Ap = matvec(p)
        alpha = rz / torch.clamp_min(torch.sum(p * Ap), 1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        z = pm.einsum("bij,bj->bi", Minv, r)
        rz_new = torch.sum(r * z)
        p = z + rz_new / torch.clamp_min(rz, 1e-20) * p
        rz = rz_new
    dx = torch.where(torch.isfinite(x), x, 0.0)
    u = _scatter(P, op, pm.einsum("nij,ni->nj", Ccp, dx[ok]))
    dp = pm.einsum("pij,pj->pi", Hpp_inv, bp - u)
    dp = torch.where(pr.pt_live[:, None] & torch.isfinite(dp).all(-1, keepdim=True), dp, 0.0)
    return lie.exp_se3(dx) @ kf_pose, pts + dp


def _lm(pm, pr, kf_pose, pts, mask, n, damping, cg_iters):
    lam = torch.tensor(damping, device=pts.device)
    cost = robust_cost(pm, pr, kf_pose, pts, mask)
    for _ in range(n):
        kf_c, pts_c = _pcg_step(pm, pr, kf_pose, pts, mask, lam, cg_iters)
        cost_c = robust_cost(pm, pr, kf_c, pts_c, mask)
        acc = cost_c <= cost
        kf_pose, pts = torch.where(acc, kf_c, kf_pose), torch.where(acc, pts_c, pts)
        lam = torch.where(acc, torch.clamp_min(lam * 0.5, 1e-5), torch.clamp_max(lam * 8.0, 1e3))
        cost = torch.where(acc, cost_c, cost)
    return kf_pose, pts


@torch.no_grad()
def solve(pr: Problem, n_iters: int, cg_iters: int, damping: float, products: str = "f32"):
    """-> (keyframe poses (K, 4, 4), point positions (P, 3), the final
    inlier mask of the edges): the map after the global BA."""
    set_exact_matmul()
    pm = Products(products)
    kf_pose, pts = pr.kf_pose0, pr.pts0
    mask = torch.ones_like(pr.stereo)
    n1 = max(n_iters // 2, 1)
    for n in (n1, max(n_iters - n1, 1)):
        kf_pose, pts = _lm(pm, pr, kf_pose, pts, mask, n, damping, cg_iters)
        mask = _gate(pm, pr, kf_pose, pts, mask)
    kf_out = torch.where(pr.kf_valid[:, None, None], lie.orthonormalize_se3(kf_pose), pr.kf_pose0)
    pts_out = torch.where(pr.observed[:, None], pts, pr.pts0)
    return kf_out, pts_out, mask
