"""Sim(3) helpers of the plain references (frozen from the port's
`ops/lie.py`): tangent [v, w, s], left perturbation T' = exp(dx) @ T,
(..., 4, 4) matrices acting on column vectors."""
from __future__ import annotations

import torch


def cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def det3(A):
    return torch.sum(A[..., :, 0] * torch.linalg.cross(A[..., :, 1], A[..., :, 2], dim=-1), -1)


def _norm(w):
    return torch.sqrt(torch.clamp_min(torch.sum(w * w, -1), 1e-24))


def _sinc(theta):
    small = theta < 1e-5
    t2 = theta * theta
    safe = torch.where(small, torch.ones_like(theta), theta)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(safe) / safe)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(safe)) / (safe * safe))
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (safe - torch.sin(safe)) / safe ** 3)
    return a, b, c


def _eye(w, W):
    return torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)


def exp_so3(w):
    a, b, _ = _sinc(_norm(w))
    W = hat(w)
    return _eye(w, W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def rt(R, t):
    top = torch.cat([R, t[..., None]], -1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], -2)


def exp_se3(x):
    v, w = x[..., :3], x[..., 3:6]
    _, b, c = _sinc(_norm(w))
    W = hat(w)
    J = _eye(w, W) + b[..., None, None] * W + c[..., None, None] * (W @ W)
    return rt(exp_so3(w), (J @ v[..., None])[..., 0])


def _sim3_J(w, s, e_s):
    theta = _norm(w)
    one = torch.ones_like(s)
    s_small = torch.abs(s) < 1e-5
    safe_s = torch.where(s_small, one, s)
    c = torch.where(s_small, 1.0 + s / 2.0 + s * s / 6.0, (e_s - 1.0) / safe_s)
    t_small = theta < 1e-5
    safe_t = torch.where(t_small, one, theta)
    s2t2 = s * s + theta * theta
    safe_d = torch.where(s2t2 < 1e-12, one, s2t2)
    a_, b_ = e_s * torch.sin(safe_t), e_s * torch.cos(safe_t)
    k1 = (a_ * s + (1.0 - b_) * safe_t) / safe_d
    k2 = c - ((b_ - 1.0) * s + a_ * safe_t) / safe_d
    k1t = torch.where(t_small, torch.where(s_small, 0.5 + s / 3.0,
                                           (e_s * s + 1.0 - e_s) / (safe_s * safe_s)),
                      k1 / safe_t)
    k2t = torch.where(t_small, torch.where(s_small, torch.full_like(s, 1.0 / 6.0),
                                           (e_s * (s - 1.0) - s * s / 2.0 + 1.0)
                                           / safe_s ** 3),
                      k2 / (safe_t * safe_t))
    W = hat(w)
    return c[..., None, None] * _eye(w, W) + k1t[..., None, None] * W \
        + k2t[..., None, None] * (W @ W)


def exp_sim3(x):
    v, w, s = x[..., :3], x[..., 3:6], x[..., 6]
    e_s = torch.exp(s)
    return rt(e_s[..., None, None] * exp_so3(w), (_sim3_J(w, s, e_s) @ v[..., None])[..., 0])


def inv_sim3(T):
    sR = T[..., :3, :3]
    inv = sR.transpose(-1, -2) / (cbrt(det3(sR)) ** 2)[..., None, None]
    return rt(inv, -(inv @ T[..., :3, 3, None])[..., 0])


def sim3_scale(T):
    return cbrt(det3(T[..., :3, :3]))


def pose_jacobian_sim3(p):
    """d(exp(x) p)/dx at 0: (..., 3) -> (..., 3, 7) = [I | -p^ | p]."""
    I = torch.eye(3, dtype=p.dtype, device=p.device).expand(p.shape[:-1] + (3, 3))
    return torch.cat([I, -hat(p), p[..., None]], -1)


def pose_jacobian_se3(p):
    I = torch.eye(3, dtype=p.dtype, device=p.device).expand(p.shape[:-1] + (3, 3))
    return torch.cat([I, -hat(p)], -1)


def orthonormalize_se3(T):
    R = T[..., :3, :3]
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    for _ in range(2):
        R = 0.5 * (R @ (3.0 * eye - R.transpose(-1, -2) @ R))
    out = T.clone()
    out[..., :3, :3] = R
    return out
