"""Robust-norm reweighting (Huber) for masked batched residuals.

Counterpart of `dsp_slam_rgbd_tpu/ops/robust.py` (reference
`loss_utils.py:246-275`): every residual slot carries a validity mask and
invalid slots contribute exactly zero.  Residuals may carry leading batch
dimensions; the mean is over the last axis.
"""
from __future__ import annotations

import torch


def huber_weights(res_norm: torch.Tensor, b: float) -> torch.Tensor:
    """w(x) with x = |residual|: sqrt(ρ(x))/x for the Huber ρ
    (ρ(x) = x² for x ≤ b, 2bx − b² otherwise).  w → 1 as x → 0."""
    x = torch.clamp_min(res_norm, 1e-12)
    rho = torch.where(res_norm <= b, x * x, 2.0 * b * x - b * b)
    return torch.sqrt(rho) / x


def robust_residuals(res: torch.Tensor, b: float,
                     mask: torch.Tensor | None = None):
    """Return (robust_res, mean_loss, weights) à la `get_robust_res`.

    `res` (…, N); `mask` (…, N) bool selects live residuals.  mean_loss
    averages robust_res² over live slots of the last axis.
    """
    w = huber_weights(torch.abs(res), b)
    rr = w * res
    if mask is None:
        return rr, torch.mean(rr * rr, dim=-1), w
    n = torch.clamp_min(mask.sum(-1), 1)
    rr = torch.where(mask, rr, 0.0)
    return rr, torch.sum(rr * rr, dim=-1) / n, w


def tukey_weights(res_norm: torch.Tensor, c: float) -> torch.Tensor:
    """Tukey biweight IRLS weights (hard rejection beyond c)."""
    r = res_norm / c
    return torch.where(r < 1.0, (1.0 - r * r) ** 2, 0.0)
