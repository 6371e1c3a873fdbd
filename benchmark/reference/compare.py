"""The numbers that decide `correct`: gaps between what the program (or a
control) produced and what the plain reference produced from the same
inputs."""
from __future__ import annotations

import torch


def fit_object_gaps(ref, outs) -> dict:
    """ref: the reference's (T (n, 4, 4), code (n, L), good (n,), loss (n,))
    of n objects; outs: a list of (rows, answer), an answer in that form
    for the reference's objects `rows` (an index tensor).  -> per object,
    the widest over its answers: pose (largest entry gap of the fitted 3x4
    Sim(3)), code (largest code entry gap), loss (gap of the final loss
    over the reference's); and the counts good_mismatch (answers whose
    is_good is not the reference's) and nonfinite (answers with a
    non-finite pose or code)."""
    T_r, z_r, g_r, l_r = (t.double() if t.is_floating_point() else t for t in ref)
    n = T_r.shape[0]
    gap = {k: torch.zeros(n, dtype=torch.float64, device=T_r.device)
           for k in ("pose", "code", "loss")}
    counts = {"good_mismatch": 0, "nonfinite": 0}
    for rows, (T, z, g, loss) in outs:
        T, z, loss = T.double(), z.double(), loss.double()
        fin = torch.isfinite(T).flatten(1).all(-1) & torch.isfinite(z).all(-1)
        counts["nonfinite"] += int((~fin).sum())
        counts["good_mismatch"] += int((g != g_r[rows]).sum())
        for k, v in (("pose", (T - T_r[rows])[:, :3, :].abs().flatten(1).amax(-1)),
                     ("code", (z - z_r[rows]).abs().amax(-1)),
                     ("loss", (loss - l_r[rows]).abs() / l_r[rows].abs().clamp_min(1e-12))):
            v = torch.where(torch.isfinite(v), v, torch.inf)
            gap[k][rows] = torch.maximum(gap[k][rows], v)
    return gap, counts


def fit_numbers(gap: dict, counts: dict, over: dict) -> dict:
    """The per-object gaps summed up: the mean over the objects (`*_mean`),
    the widest (`*_max`) and, for each gap `k` of `over`, the share of the
    objects whose gap is above `over[k]` (`k_over`): a few wrong fits among
    many move that share where they hardly move the mean."""
    out = dict(counts)
    for k, v in gap.items():
        out[f"{k}_mean"] = float(v.mean())
        out[f"{k}_max"] = float(v.max())
    for k, t in over.items():
        out[f"{k}_over"] = float((gap[k] > t).double().mean())
    return out


def map_gaps(cost_fn, ref, outs, kf_valid, pt_live) -> dict:
    """ref: the reference's (keyframe poses (K, 4, 4), points (P, 3));
    outs: the program's answers in that form; cost_fn(kf_pose, pts): the
    reference's robust cost over its final inlier edges, in float64.  ->
    kf_gap (largest entry gap of a valid keyframe's 3x4 T_cw), pt_gap
    (largest coordinate gap of an optimised point, m), cost_gap (largest
    gap of the robust cost over the reference's), nonfinite (answers with a
    non-finite pose or point)."""
    kf_r, pt_r = ref[0].double(), ref[1].double()
    c_r = float(cost_fn(kf_r, pt_r))
    gaps = {"kf_gap": 0.0, "pt_gap": 0.0, "cost_gap": 0.0, "nonfinite": 0}
    for kf, pt in outs:
        kf, pt = kf.double(), pt.double()
        fin = bool(torch.isfinite(kf[kf_valid]).all()) and bool(torch.isfinite(pt[pt_live]).all())
        gaps["nonfinite"] += int(not fin)
        gaps["kf_gap"] = max(gaps["kf_gap"], float((kf - kf_r)[kf_valid][:, :3, :].abs().amax()))
        gaps["pt_gap"] = max(gaps["pt_gap"], float((pt - pt_r)[pt_live].abs().amax()))
        gaps["cost_gap"] = max(gaps["cost_gap"], abs(float(cost_fn(kf, pt)) - c_r) / abs(c_r))
    return gaps
