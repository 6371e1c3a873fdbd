"""Lie-group operations for SE(3) / Sim(3) / SO(3), batched, on tensors.

Counterpart of `dsp_slam_rgbd_tpu/ops/lie.py`, same semantics: tangent
ordering (translation v, rotation w[, log-scale s]), left perturbation
T' = exp(dx) @ T, branch-free small-angle limits with `torch.where` on
safe operands so nothing is NaN at θ = 0.

Conventions:
  * Transforms are (…, 4, 4) row-major homogeneous matrices acting on
    column vectors: y = T @ [x; 1].
  * se3 tangent x = [v (3), w (3)];  sim3 tangent x = [v (3), w (3), s (1)].
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def _eye3(like: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(shape)


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root (torch has no cbrt): sign(x)·|x|^(1/3)."""
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (…, 3) -> (…, 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (…, 3, 3) -> (…, 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _safe_norm(w: torch.Tensor) -> torch.Tensor:
    """‖w‖ with a finite gradient at w = 0."""
    return torch.sqrt(torch.clamp_min(torch.sum(w * w, dim=-1), 1e-24))


def _sinc_coeffs(theta):
    """Return (sin θ/θ, (1-cos θ)/θ², (θ-sin θ)/θ³) with Taylor fallbacks."""
    small = theta < 1e-5
    t2 = theta * theta
    safe = torch.where(small, torch.ones_like(theta), theta)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(safe) / safe)
    b = torch.where(small, 0.5 - t2 / 24.0,
                    (1.0 - torch.cos(safe)) / (safe * safe))
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (safe - torch.sin(safe)) / (safe ** 3))
    return a, b, c


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (…, 3) -> (…, 3, 3)."""
    theta = _safe_norm(w)
    a, b, _ = _sinc_coeffs(theta)
    W = hat(w)
    return _eye3(w, W.shape) + a[..., None, None] * W \
        + b[..., None, None] * (W @ W)


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J of SO(3): exp_se3 translation = J @ v."""
    theta = _safe_norm(w)
    _, b, c = _sinc_coeffs(theta)
    W = hat(w)
    return _eye3(w, W.shape) + b[..., None, None] * W \
        + c[..., None, None] * (W @ W)


def exp_se3(x: torch.Tensor) -> torch.Tensor:
    """se(3) exponential, tangent ordered [v, w]: (…, 6) -> (…, 4, 4)."""
    v, w = x[..., :3], x[..., 3:6]
    R = exp_so3(w)
    t = (so3_left_jacobian(w) @ v[..., None])[..., 0]
    return _rt_to_mat(R, t)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """SO(3) log map: (…, 3, 3) -> (…, 3). Valid for θ < π (arctan2 form)."""
    v = vee(R - R.transpose(-1, -2)) * 0.5  # = sin θ · axis
    sin_theta = _safe_norm(v)
    trace = R.diagonal(dim1=-2, dim2=-1).sum(-1)
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.atan2(sin_theta, cos_theta)
    small = sin_theta < 1e-5
    safe_sin = torch.where(small, torch.ones_like(sin_theta), sin_theta)
    k = torch.where(small, 1.0 + theta * theta / 6.0, theta / safe_sin)
    return k[..., None] * v


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """SE(3) log map -> tangent [v, w]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    w = log_so3(R)
    v = (_so3_left_jacobian_inv(w) @ t[..., None])[..., 0]
    return torch.cat([v, w], dim=-1)


def _so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    theta = _safe_norm(w)
    small = theta < 1e-5
    safe = torch.where(small, torch.ones_like(theta), theta)
    # k = 1/θ² - (1+cosθ)/(2θ sinθ) ; Taylor: 1/12 + θ²/720
    k = torch.where(
        small,
        1.0 / 12.0 + theta * theta / 720.0,
        1.0 / (safe * safe)
        - (1.0 + torch.cos(safe)) / (2.0 * safe * torch.sin(safe)),
    )
    W = hat(w)
    return _eye3(w, W.shape) - 0.5 * W + k[..., None, None] * (W @ W)


def _sim3_J(w, s, e_s):
    """The Sim(3) "W" matrix mapping v to the translation of exp_sim3."""
    theta = _safe_norm(w)
    one = torch.ones_like(s)
    s_small = torch.abs(s) < 1e-5
    safe_s = torch.where(s_small, one, s)
    # c = (e^s - 1)/s, Taylor: 1 + s/2 + s²/6
    c = torch.where(s_small, 1.0 + s / 2.0 + s * s / 6.0, (e_s - 1.0) / safe_s)
    t_small = theta < 1e-5
    safe_t = torch.where(t_small, one, theta)
    s2t2 = s * s + theta * theta
    safe_d = torch.where(s2t2 < 1e-12, one, s2t2)
    a_ = e_s * torch.sin(safe_t)
    b_ = e_s * torch.cos(safe_t)
    # J = c·I + (k1/θ)·W + (k2/θ²)·W² with closed-form θ→0 / s→0 limits
    k1 = (a_ * s + (1.0 - b_) * safe_t) / safe_d
    k2 = c - ((b_ - 1.0) * s + a_ * safe_t) / safe_d
    k1_over_t = torch.where(
        t_small,
        torch.where(s_small, 0.5 + s / 3.0,
                    (e_s * s + 1.0 - e_s) / (safe_s * safe_s)),
        k1 / safe_t,
    )
    k2_over_t2 = torch.where(
        t_small,
        torch.where(s_small, torch.full_like(s, 1.0 / 6.0),
                    (e_s * (s - 1.0) - (s * s) / 2.0 + 1.0)
                    / (safe_s * safe_s * safe_s)),
        k2 / (safe_t * safe_t),
    )
    W = hat(w)
    return c[..., None, None] * _eye3(w, W.shape) \
        + k1_over_t[..., None, None] * W + k2_over_t2[..., None, None] * (W @ W)


def exp_sim3(x: torch.Tensor) -> torch.Tensor:
    """Sim(3) exponential, tangent [v, w, s]: (…, 7) -> (…, 4, 4).

    Rotation block is e^s * exp_so3(w); translation uses the Sim(3) "W"
    matrix (closed form of reference `loss_utils.py:198-243`).
    """
    v, w, s = x[..., :3], x[..., 3:6], x[..., 6]
    e_s = torch.exp(s)
    t = (_sim3_J(w, s, e_s) @ v[..., None])[..., 0]
    return _rt_to_mat(e_s[..., None, None] * exp_so3(w), t)


def det3(A: torch.Tensor) -> torch.Tensor:
    """Determinant of (…, 3, 3) matrices as a1·(a2×a3): elementwise, so
    `torch.func.vmap` of `jacfwd` through it is exact (through
    `linalg.det` it is not)."""
    return torch.sum(A[..., :, 0] * torch.linalg.cross(A[..., :, 1], A[..., :, 2], dim=-1), dim=-1)


def _solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with A x = b for (…, 3, 3) A by Cramer's rule: elementwise, so no
    error check (no host sync on the card), and `torch.func.vmap` of
    `jacfwd` through it is exact (through `linalg.solve_ex` it is not)."""
    a1, a2, a3 = A[..., :, 0], A[..., :, 1], A[..., :, 2]
    c23 = torch.linalg.cross(a2, a3, dim=-1)
    det = torch.sum(a1 * c23, dim=-1)
    x = torch.stack([torch.sum(b * c23, dim=-1),
                     torch.sum(a1 * torch.linalg.cross(b, a3, dim=-1), dim=-1),
                     torch.sum(a1 * torch.linalg.cross(a2, b, dim=-1), dim=-1)], dim=-1)
    return x / det[..., None]


def log_sim3(T: torch.Tensor) -> torch.Tensor:
    """Sim(3) log map -> tangent [v, w, s] (inverse of exp_sim3)."""
    sR = T[..., :3, :3]
    t = T[..., :3, 3]
    e_s = cbrt(det3(sR))
    s = torch.log(e_s)
    w = log_so3(sR / e_s[..., None, None])
    v = _solve3(_sim3_J(w, s, e_s), t)
    return torch.cat([v, w, s[..., None]], dim=-1)


def _rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    # assembled by concatenation: writing the scalar 1 into a view would
    # copy it from the host and block the host on the card
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.nn.functional.pad(torch.zeros_like(top[..., :1, :3]), (0, 1), value=1.0)
    return torch.cat([top, bottom], dim=-2)


def rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble homogeneous (…, 4, 4) from rotation and translation."""
    return _rt_to_mat(R, t)


def inv_se3(T: torch.Tensor) -> torch.Tensor:
    """Fast inverse of an SE(3) matrix (R orthonormal)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return _rt_to_mat(Rt, -(Rt @ T[..., :3, 3, None])[..., 0])


def inv_sim3(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a Sim(3) matrix (rotation block is s·R)."""
    sR = T[..., :3, :3]
    s2 = cbrt(det3(sR)) ** 2
    inv_sR = sR.transpose(-1, -2) / s2[..., None, None]
    return _rt_to_mat(inv_sR, -(inv_sR @ T[..., :3, 3, None])[..., 0])


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (…, 4, 4) transforms to (…, N, 3) points (an unbatched (4, 4)
    T broadcasts over any leading point dimensions)."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def sim3_scale(T: torch.Tensor) -> torch.Tensor:
    """Scale factor of a Sim(3) matrix: det(sR)^(1/3)."""
    return cbrt(det3(T[..., :3, :3]))


def adjoint_se3(T: torch.Tensor) -> torch.Tensor:
    """SE(3) adjoint in [v, w] tangent ordering: (…, 6, 6)."""
    R = T[..., :3, :3]
    tR = hat(T[..., :3, 3]) @ R
    top = torch.cat([R, tR], dim=-1)
    bottom = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def points_to_pose_jacobian_se3(pts: torch.Tensor) -> torch.Tensor:
    """d(exp(x)·p)/dx at x=0 for SE(3): (N, 3) -> (N, 3, 6) = [I | -p^]."""
    I = _eye3(pts, pts.shape[:-1] + (3, 3))
    return torch.cat([I, -hat(pts)], dim=-1)


def points_to_pose_jacobian_sim3(pts: torch.Tensor) -> torch.Tensor:
    """d(exp(x)·p)/dx at x=0 for Sim(3): (N, 3) -> (N, 3, 7) = [I | -p^ | p]."""
    I = _eye3(pts, pts.shape[:-1] + (3, 3))
    return torch.cat([I, -hat(pts), pts[..., None]], dim=-1)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> rotation matrix (…, 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                         2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                         2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                         1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z), branch-free: the
    4-candidate construction, picking the best-conditioned with argmax."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                      1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    qw = torch.sqrt(torch.clamp_min(qw, 1e-12)) * 0.5
    q0, q1, q2, q3 = qw[..., 0], qw[..., 1], qw[..., 2], qw[..., 3]
    cand = torch.stack(
        [
            torch.stack([q0, (m21 - m12) / (4 * q0), (m02 - m20) / (4 * q0),
                         (m10 - m01) / (4 * q0)], -1),
            torch.stack([(m21 - m12) / (4 * q1), q1, (m01 + m10) / (4 * q1),
                         (m02 + m20) / (4 * q1)], -1),
            torch.stack([(m02 - m20) / (4 * q2), (m01 + m10) / (4 * q2), q2,
                         (m12 + m21) / (4 * q2)], -1),
            torch.stack([(m10 - m01) / (4 * q3), (m02 + m20) / (4 * q3),
                         (m12 + m21) / (4 * q3), q3], -1),
        ],
        dim=-2,
    )
    best = torch.argmax(qw, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.take_along_dim(cand, idx, dim=-2)[..., 0, :]
    # canonical sign: w >= 0
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def orthonormalize_so3(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation back onto SO(3): two Newton iterations of the
    symmetric orthogonalization R ← R·(3I − RᵀR)/2."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    for _ in range(2):
        RtR = R.transpose(-1, -2) @ R
        R = 0.5 * (R @ (3.0 * eye - RtR))
    return R


def orthonormalize_se3(T: torch.Tensor) -> torch.Tensor:
    """Re-project the rotation block of (…, 4, 4) SE(3) matrices onto
    SO(3); translation untouched."""
    out = T.clone()
    out[..., :3, :3] = orthonormalize_so3(T[..., :3, :3])
    return out
