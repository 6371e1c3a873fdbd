"""Plain joint Sim(3) pose + shape-code Gauss-Newton fit of DSP-SLAM.

The reference's `reconstruct/optimizer.py` (`reconstruct_object`, its
batched form) with its losses (`reconstruct/loss.py`: the SDF term over
surface points, the differentiable depth-rendering term over ray samples,
the vertical-axis rotation prior), as the port runs it: per-ray chord
sampling inside the unit sphere, an optional coarse-to-fine schedule with
active-ray selection, and fixed-capacity compaction of the render term's
gradient points.  Objects are independent: a batch is a leading dimension.

Inputs are the benchmark's own (the generated observations and the raw
decoder file); nothing of the program is read.  `PlainDecoder` gives the
decoder in the configuration's precision, `Products` the precision of the
fit's own products (float32 here; the control's lower one).
"""
from __future__ import annotations

import math

import torch

from benchmark.reference import lie
from benchmark.reference.precision import Products, set_exact_matmul


def _compact(mask, size: int, fill: int):
    """First `size` True positions of each row of mask, padded with fill."""
    n = mask.shape[-1]
    pos = torch.cumsum(mask.long(), -1) - 1
    slot = torch.where(mask & (pos < size), pos, size)
    src = torch.arange(n, device=mask.device).expand(mask.shape)
    idx = torch.full(mask.shape[:-1] + (size + 1,), fill, dtype=torch.long, device=mask.device)
    return idx.scatter(-1, slot, src)[..., :size]


def _huber(res, b, mask):
    x = torch.clamp_min(torch.abs(res), 1e-12)
    rho = torch.where(torch.abs(res) <= b, x * x, 2.0 * b * x - b * b)
    return torch.where(mask, torch.sqrt(rho) / x * res, 0.0)


def _transform(pm: Products, T, pts):
    return pm.mm(pts, T[..., :3, :3].transpose(-1, -2)) + T[..., None, :3, 3]


def _chord(pm: Products, T_oc, rays, M):
    A, c = T_oc[..., :3, :3], T_oc[..., :3, 3]
    u = pm.mm(rays, A.transpose(-1, -2))
    a = torch.sum(u * u, -1)
    b = 2.0 * torch.sum(u * c[..., None, :], -1)
    cc = (torch.sum(c * c, -1) - 1.0)[..., None]
    disc = b * b - 4.0 * a * cc
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    a_safe = torch.clamp_min(a, 1e-12)
    t0 = torch.clamp_min((-b - sq) / (2.0 * a_safe), 1e-4)
    t1 = (-b + sq) / (2.0 * a_safe)
    frac = torch.linspace(0.0, 1.0, M, device=rays.device)
    return t0[..., None] + (t1 - t0)[..., None] * frac, (disc > 0.0) & (t1 > t0)


def _sdf_term(dec, pm, pts_cam, T_oc, code):
    p = _transform(pm, T_oc, pts_cam)
    res, jin = dec.value_and_jacobian(code, p)
    jac_pose = pm.einsum("bni,bnij->bnj", jin[..., -3:], lie.pose_jacobian_sim3(p))
    return jac_pose, jin[..., :-3], res


def _render_term(dec, pm, cfg, rays, ray_mask, depth_obs, T_oc, depths, code, d_max):
    B, R, M = depths.shape
    th = cfg["cut_off_threshold"]
    pts_cam = rays[:, :, None, :] * depths[..., None]
    p = _transform(pm, T_oc, pts_cam.reshape(B, R * M, 3))
    valid = (torch.linalg.vector_norm(p, dim=-1) < 1.0).reshape(B, R, M) & ray_mask[..., None]
    sdf = dec.value(code, p).reshape(B, R, M)
    occ = torch.where(valid, 0.5 - torch.clamp(sdf, -th, th) / (2.0 * th), 0.0)
    trans = torch.cumprod(1.0 - occ, -1)
    trans_aug = torch.cat([torch.ones_like(occ[..., :1]), trans], -1)
    occ_aug = torch.cat([occ, torch.ones_like(occ[..., :1])], -1)
    d_aug = torch.cat([depths, (1.1 * d_max)[:, None, None].expand(B, R, 1)], -1)
    d_u = torch.sum(d_aug * occ_aug * trans_aug, -1)
    rev = torch.flip(torch.cumsum(torch.flip(trans, [-1]), -1), [-1])
    de_do = rev / torch.clamp_min(1.0 - occ, 1e-6)
    with_grad = valid & (torch.abs(sdf) < th) & (de_do > 1e-2)
    n_valid = valid.sum((-2, -1))
    res_ray = torch.clamp(depth_obs - d_u, -0.30, 0.30)
    delta = (depths[..., -1] - depths[..., 0]) / (M - 1)
    de_ds = de_do * delta[..., None] * (-1.0 / (2.0 * th))
    flat = with_grad.reshape(B, R * M)
    K = cfg["max_grad_points"]
    idx = _compact(flat, K, 0)
    live = torch.gather(flat, -1, idx)
    p_sel = torch.gather(p, 1, idx[..., None].expand(B, K, 3))
    de_sel = torch.gather(de_ds.reshape(B, R * M), -1, idx)
    res_sel = torch.gather(res_ray, -1, idx // M)
    _, jin = dec.value_and_jacobian(code, p_sel)
    de_di = de_sel[..., None] * jin
    jac_pose = pm.einsum("bni,bnij->bnj", de_di[..., -3:], lie.pose_jacobian_sim3(p_sel))
    min_abs = torch.amin(torch.where(valid, torch.abs(sdf), torch.inf), -1)
    return jac_pose, de_di[..., :-3], res_sel, live, n_valid, res_ray, min_abs


def _rotation_prior(T_oc):
    T_co = lie.inv_sim3(T_oc)
    sR = T_co[..., :3, :3]
    r = sR / lie.cbrt(lie.det3(sR))[..., None, None]
    ey = torch.tensor([0.0, 1.0, 0.0], device=sR.device)
    ng = -ey
    res = 1.0 - (r @ ey) @ ng
    J_rot = torch.linalg.cross(ng @ r, ey.expand(r.shape[:-2] + (3,)), dim=-1)
    z = torch.zeros_like(J_rot)
    J = torch.cat([z, J_rot, z[..., :1]], -1)
    zero = res < 1e-7
    return torch.where(zero[..., None], 0.0, J), torch.where(zero, 0.0, res)


def _gn_step(dec, pm, cfg, carry, rays, ray_mask, depth_obs, fg_mask, pts, pts_mask, M):
    T_oc, code, good, loss_prev = carry[:4]
    B, L = code.shape
    T_co = lie.inv_sim3(T_oc)
    scale = lie.sim3_scale(T_co)
    d_max = T_co[:, 2, 3] + scale
    depths, hit = _chord(pm, T_oc, rays, M)
    depth_eff = torch.where(fg_mask, depth_obs, (1.1 * d_max)[:, None])
    sj_pose, sj_code, s_res = _sdf_term(dec, pm, pts, T_oc, code)
    s_rr = _huber(s_res, cfg["b2"], pts_mask)
    rj_pose, rj_code, r_res, r_mask, n_valid, res_ray, min_abs = _render_term(
        dec, pm, cfg, rays, ray_mask & hit, depth_eff, T_oc, depths, code, d_max)
    r_rr = _huber(r_res, cfg["b1"], r_mask)
    drot, res_rot = _rotation_prior(T_oc)

    H = torch.zeros(B, 7 + L, 7 + L, device=code.device)
    b = torch.zeros(B, 7 + L, device=code.device)
    terms = []
    for k, jp, jc, mask, rr in ((cfg["k2"], sj_pose, sj_code, pts_mask, s_rr),
                                (cfg["k1"], rj_pose, rj_code, r_mask, r_rr)):
        J = torch.where(mask[..., None], torch.cat([jp, jc], -1), 0.0)
        Jt = J.transpose(1, 2)
        count = mask.sum(-1)
        n = torch.clamp_min(count, 1).float()
        H = H + k * pm.mm(Jt, J) / n[:, None, None]
        b = b - k * pm.mm(Jt, torch.where(mask, rr, 0.0)[..., None])[..., 0] / n[:, None]
        terms.append(torch.sum(rr * rr, -1) / torch.clamp_min(count, 1))
    loss = cfg["k1"] * terms[1] + cfg["k2"] * terms[0]
    H[:, 7:, 7:] += cfg["k3"] * torch.eye(L, device=code.device)
    b[:, 7:] -= cfg["k3"] * code
    H[:, :7, :7] += cfg["k4"] * drot[:, :, None] * drot[:, None, :]
    b[:, :7] += cfg["k4"] * drot * res_rot[:, None]
    H[:, :7, :7] += torch.eye(7, device=code.device)
    H[:, 6, 6] += cfg["scale_damping"]
    dx, info = torch.linalg.solve_ex(H, b)
    lr = cfg["learning_rate"]
    T_new = lie.exp_sim3(lr * dx[:, :7]) @ T_oc
    code_new = code + lr * dx[:, 7:]
    ok = (good & torch.isfinite(loss) & torch.isfinite(dx).all(-1) & (info == 0)
          & (n_valid >= 10))
    return (torch.where(ok[:, None, None], T_new, T_oc), torch.where(ok[:, None], code_new, code),
            ok, torch.where(ok, loss, loss_prev), res_ray, min_abs)


def _gather_rays(x, sel):
    idx = sel.reshape(sel.shape + (1,) * (x.dim() - 2)).expand(sel.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


@torch.no_grad()
def fit(dec, cfg: dict, T_init, pts, pts_mask, rays, ray_mask, depth_obs, fg_mask,
        products: str = "f32"):
    """B objects' fits -> (T_cam_obj (B, 4, 4), code (B, L), is_good (B,),
    loss (B,)).  cfg: the configuration's optimizer and preset keys."""
    if not cfg["chord_sampling"]:
        raise ValueError("the reference fits with chord sampling only")
    set_exact_matmul()
    pm = Products(products)
    dev = T_init.device
    B, L, R = T_init.shape[0], cfg["code_len"], rays.shape[1]
    n_it = cfg["num_iterations"]
    nc = min(cfg["coarse_iterations"], n_it) if cfg["coarse_samples"] > 0 else 0
    carry = (lie.inv_sim3(T_init.float()), torch.zeros(B, L, device=dev),
             torch.ones(B, dtype=torch.bool, device=dev), torch.zeros(B, device=dev),
             torch.zeros(B, R, device=dev), torch.full((B, R), torch.inf, device=dev))
    for _ in range(nc):
        carry = _gn_step(dec, pm, cfg, carry, rays, ray_mask, depth_obs, fg_mask, pts, pts_mask,
                         cfg["coarse_samples"])
    sets = (rays, ray_mask, depth_obs, fg_mask)
    if nc > 0 and cfg["active_ray_fraction"] < 1.0:
        n_act = max(int(math.ceil(R * cfg["active_ray_fraction"])), 1)
        interact = fg_mask | (carry[5] < 5.0 * cfg["cut_off_threshold"])
        score = torch.where(ray_mask, 1e3 * interact.float() + torch.abs(carry[4]), -1.0)
        sel = torch.sort(score, dim=-1, descending=True, stable=True)[1][:, :n_act]
        sets = tuple(_gather_rays(x, sel) for x in sets)
    for _ in range(nc, n_it):
        carry = _gn_step(dec, pm, cfg, carry, *sets, pts, pts_mask, cfg["num_depth_samples"])
    T_oc, code, good, loss = carry[:4]
    return lie.inv_sim3(T_oc), code, good, loss
