"""Monocular map initialization: parallel H/F RANSAC + motion recovery.

Counterpart of `dsp_slam_rgbd_tpu/solvers/initializer.py` (reference
`Initializer`, `src/Initializer.cc`): homography and fundamental
hypotheses scored in parallel (:124/:175, symmetric transfer error), model
selection RH = SH/(SH+SF) > 0.40 (:118), motion recovery with the 4-way
(R, t) disambiguation for F (:470 ReconstructF) and the Faugeras
decomposition for H (:572 ReconstructH), DLT triangulation and
cheirality/reprojection checks (:798 CheckRT).

All trials are one batched eigendecomposition (H and F together), the
best models' motions one batched SVD, and the eight motions' triangulation
one batched eigendecomposition.  `initialize` is a draw of
the (n_trials, 8) sample indices (`draw_indices`, uniform ranks from a CPU
`torch.Generator`, so the card and the CPU see the same hypotheses) and a
deterministic evaluation of a given index array (`initialize_from_indices`).
The eigenvectors' and singular vectors' signs are free: H and F are
determined up to sign, and the four F and four H motions as sets.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dsp_slam_rgbd_tpu_torch.frontend.orb import upload
from dsp_slam_rgbd_tpu_torch.ops import lie
from dsp_slam_rgbd_tpu_torch.solvers import triangulate as tri

CHI2_H = 5.991
CHI2_F = 3.841
SCORE_TH = 5.991


def draw_indices(valid: torch.Tensor, n_trials: int, k: int,
                 generator: torch.Generator) -> torch.Tensor:
    """(n_trials, k) int64 sample indices, uniform over the valid entries
    with replacement (the distribution of `jax.random.choice(replace=True,
    p=valid/sum)`).  The uniform draws come from `generator` on the CPU and
    pick the valid entries by rank on `valid`'s device: no host read, and
    the same indices on the card and the CPU for the same generator state."""
    u = torch.rand((n_trials, k), generator=generator, dtype=torch.float64)
    u = upload(u, valid.device)
    c = torch.cumsum(valid.to(torch.int64), 0)
    rank = torch.floor(u * c[-1].double()).to(torch.int64)
    idx = torch.searchsorted(c, rank, right=True)
    return torch.clamp_max(idx, valid.shape[0] - 1)


def _normalize(pts: torch.Tensor, valid: torch.Tensor):
    """Hartley normalization (reference `Initializer::Normalize`)."""
    w = valid.float()
    n = torch.clamp_min(w.sum(), 1.0)
    mean = torch.einsum("n,ni->i", w, pts) / n
    d = torch.abs(pts - mean)
    md = torch.einsum("n,ni->i", w, d) / n
    s = 1.0 / torch.clamp_min(md, 1e-9)
    zero, one = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([torch.stack([s[0], zero, -mean[0] * s[0]]),
                     torch.stack([zero, s[1], -mean[1] * s[1]]),
                     torch.stack([zero, zero, one])])
    return (pts - mean) * s, T


def _hom(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _null_vectors(*As: torch.Tensor) -> list[torch.Tensor]:
    """For each (…, m, n) system A, the eigenvector of AᵀA with the smallest
    eigenvalue, (…, n), from one batched eigensolve over all of them (one
    error check, so one host sync on the card).  AᵀA and its eigensolve are
    in f64: the normal matrix squares the 8-point system's condition number
    (the JAX package solves in f32; on the CPU the two precisions give the
    same motions against it, see tests/test_torch_initializer.py)."""
    N = torch.cat([(A.double().transpose(-1, -2) @ A.double()).flatten(0, -3) for A in As])
    vecs = torch.linalg.eigh(N)[1][..., :, 0].float()
    out, i = [], 0
    for A in As:
        k = A.shape[:-2].numel()
        out.append(vecs[i:i + k].reshape(A.shape[:-2] + A.shape[-1:]))
        i += k
    return out


def _h_system(x1, x2):
    """(…, 8, 2) x (…, 8, 2) -> the (…, 16, 9) DLT system of H."""
    hom1 = _hom(x1)
    zeros = torch.zeros_like(hom1)
    rows1 = torch.cat([zeros, -hom1, x2[..., 1:2] * hom1], dim=-1)
    rows2 = torch.cat([hom1, zeros, -x2[..., 0:1] * hom1], dim=-1)
    return torch.cat([rows1, rows2], dim=-2)


def _f_system(x1, x2):
    """(…, 8, 2) x (…, 8, 2) -> the (…, 8, 9) 8-point system of F."""
    return torch.einsum("...ni,...nj->...nij", _hom(x2), _hom(x1)).flatten(-2)


def _rank2(F):
    """F with its smallest singular value set to 0."""
    U, S, Vt = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    return U @ torch.diag_embed(S) @ Vt


def _fit_homography(x1, x2):
    """(…, 8, 2) x (…, 8, 2) -> (…, 3, 3) H via DLT (smallest eigenvector)."""
    return _null_vectors(_h_system(x1, x2))[0].reshape(x1.shape[:-2] + (3, 3))


def _fit_fundamental(x1, x2):
    """8-point algorithm with rank-2 enforcement, (…, 8, 2) pairs."""
    return _rank2(_null_vectors(_f_system(x1, x2))[0].reshape(x1.shape[:-2] + (3, 3)))


def _score_homography(H, uv1, uv2, valid, sigma2: float):
    """H (…, 3, 3) -> (score (…,), ok (…, N))."""
    Hi = torch.linalg.inv_ex(H)[0]

    def transfer(M, a, b):
        p = _hom(a) @ M.transpose(-1, -2)
        z = p[..., 2:3]
        p = p[..., :2] / torch.where(torch.abs(z) < 1e-12, 1e-12, z)
        return torch.sum((p - b) ** 2, dim=-1) / sigma2

    c1 = transfer(H, uv1, uv2)
    c2 = transfer(Hi, uv2, uv1)
    ok = valid & (c1 <= CHI2_H) & (c2 <= CHI2_H)
    score = torch.where(valid & (c1 <= CHI2_H), SCORE_TH - c1, 0.0) + \
        torch.where(valid & (c2 <= CHI2_H), SCORE_TH - c2, 0.0)
    return torch.sum(score, dim=-1), ok


def _score_fundamental(F, uv1, uv2, valid, sigma2: float):
    """F (…, 3, 3) -> (score (…,), ok (…, N))."""
    h1, h2 = _hom(uv1), _hom(uv2)
    l2 = h1 @ F.transpose(-1, -2)  # epipolar lines in image 2
    l1 = h2 @ F
    d2 = torch.sum(l2 * h2, dim=-1) ** 2 / torch.clamp_min(
        l2[..., 0] ** 2 + l2[..., 1] ** 2, 1e-12) / sigma2
    d1 = torch.sum(l1 * h1, dim=-1) ** 2 / torch.clamp_min(
        l1[..., 0] ** 2 + l1[..., 1] ** 2, 1e-12) / sigma2
    ok = valid & (d1 <= CHI2_F) & (d2 <= CHI2_F)
    score = torch.where(valid & (d2 <= CHI2_F), SCORE_TH - d2, 0.0) + \
        torch.where(valid & (d1 <= CHI2_F), SCORE_TH - d1, 0.0)
    return torch.sum(score, dim=-1), ok


def _check_rt(cam, R, t, uv1, uv2, valid, sigma2: float):
    """Triangulate and grade a motion hypothesis (reference `CheckRT`)."""
    T1 = torch.eye(4, device=R.device)
    T2 = lie.rt_to_mat(R, t)
    pts = tri.triangulate_two_views(cam, cam, T1, T2, uv1, uv2)
    masks = tri.acceptance_masks(cam, cam, T1, T2, pts, uv1, uv2,
                                 reproj_chi2=4.0 * sigma2)
    good = valid & masks["depth"] & masks["reproj"] & torch.all(torch.isfinite(pts), dim=-1)
    return torch.sum(good), good, pts


class InitResult(NamedTuple):
    t_21: torch.Tensor         # (4, 4) pose of frame 2 wrt frame 1 (T_cw for f2)
    pts_w: torch.Tensor        # (N, 3) triangulated points
    good: torch.Tensor         # (N,) bool triangulation accepted
    is_homography: torch.Tensor
    ok: torch.Tensor


def _candidates(K, Kinv, F, H):
    """The 4 F then the 4 H motion hypotheses [(R, t)], from one batched
    SVD of E = KᵀFK and A = K⁻¹HK.

    F: the four (R, t) of E.  H: the Faugeras-style decomposition of A, the
    d' = +d2 family's 4 sign combinations (the d' = −d2 family is
    physically implausible for small motions and dropped, as the JAX
    package does):
      x1 = ε1·√((d1²−d2²)/(d1²−d3²)), x3 = ε3·√((d2²−d3²)/(d1²−d3²))
      sinθ = (d1−d3)·x1·x3/d2,  cosθ = (d1·x3² + d3·x1²)/d2
      R' = R_y(θ),  t' = (d1−d3)·[x1, 0, −x3]"""
    Us, Ss, Vts = torch.linalg.svd(torch.stack([K.T @ F @ K, Kinv @ H @ K]))
    U, Vt = Us[0], Vts[0]
    W = upload(np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], np.float32),
               F.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    R1 = R1 * torch.sign(lie.det3(R1))
    R2 = R2 * torch.sign(lie.det3(R2))
    tu = U[:, 2]
    tu = tu / torch.clamp_min(torch.linalg.vector_norm(tu), 1e-12)
    out = [(R1, tu), (R1, -tu), (R2, tu), (R2, -tu)]

    Ua, Vat = Us[1], Vts[1]
    d1, d2, d3 = Ss[1, 0], Ss[1, 1], Ss[1, 2]
    s_sign = lie.det3(Ua) * lie.det3(Vat)
    den = torch.clamp_min(d1 * d1 - d3 * d3, 1e-12)
    x1c = torch.sqrt(torch.clamp_min((d1 * d1 - d2 * d2) / den, 0.0))
    x3c = torch.sqrt(torch.clamp_min((d2 * d2 - d3 * d3) / den, 0.0))
    d2s = torch.clamp_min(d2, 1e-12)
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            x1s, x3s = x1c * e1, x3c * e3
            st = (d1 - d3) * x1s * x3s / d2s
            ct = (d1 * x3s * x3s + d3 * x1s * x1s) / d2s
            Rp = torch.stack([torch.stack([ct, zero, -st]), torch.stack([zero, one, zero]),
                              torch.stack([st, zero, ct])])
            tp = torch.stack([(d1 - d3) * x1s, zero, -(d1 - d3) * x3s])
            R = s_sign * Ua @ Rp @ Vat
            t = Ua @ tp
            out.append((R, t / torch.clamp_min(torch.linalg.vector_norm(t), 1e-12)))
    return out


def initialize_from_indices(cam, uv1, uv2, valid, idx, sigma: float = 1.0,
                            min_good: int = 50) -> InitResult:
    """Two-view initialization from matched pixels (N, 2) + (N, 2), with the
    RANSAC samples given: idx (n_trials, 8) indices into the matches."""
    sigma2 = sigma * sigma
    dev = uv1.device
    x1n, T1n = _normalize(uv1, valid)
    x2n, T2n = _normalize(uv2, valid)
    T2n_inv = torch.linalg.inv_ex(T2n)[0]

    # every trial at once: (T, 8, 2) samples -> (T, 3, 3) models
    a, b = x1n[idx], x2n[idx]
    hn, fn = _null_vectors(_h_system(a, b), _f_system(a, b))
    Hs = T2n_inv @ hn.reshape(-1, 3, 3) @ T1n
    Fs = T2n.T @ _rank2(fn.reshape(-1, 3, 3)) @ T1n
    sh, _ = _score_homography(Hs, uv1, uv2, valid, sigma2)
    sf, _ = _score_fundamental(Fs, uv1, uv2, valid, sigma2)
    # winners picked by (1,) index tensors: a 0-d tensor index is read
    # back to the host
    bh, bf = torch.argmax(sh, 0, keepdim=True), torch.argmax(sf, 0, keepdim=True)
    SH, SF = sh[bh][0], sf[bf][0]
    H, F = Hs[bh][0], Fs[bf][0]
    rh = SH / torch.clamp_min(SH + SF, 1e-9)
    use_h = rh > 0.40

    K, Kinv = upload(cam.K, dev), upload(cam.K_inv, dev)
    cands = _candidates(K, Kinv, F, H)  # 4 F + 4 H
    Rs = torch.stack([R for R, _ in cands])
    ts = torch.stack([t for _, t in cands])
    is_h_cand = torch.arange(8, device=dev) >= 4

    # `grade`, the 8 hypotheses in one batch
    n_good, goods, ptss = torch.func.vmap(
        lambda R, t: _check_rt(cam, R, t, uv1, uv2, valid, sigma2))(Rs, ts)
    finite = torch.all(torch.isfinite(Rs), dim=(1, 2)) & torch.all(torch.isfinite(ts), dim=1)
    scores = torch.where(finite, n_good, -1)
    # mask out the family not selected by RH
    family_ok = torch.where(use_h, is_h_cand, ~is_h_cand)
    scores = torch.where(family_ok, scores, -1)
    best = torch.argmax(scores, 0, keepdim=True)

    n_best = scores[best][0]
    # winner must clearly dominate (reference: nGood > 0.9 * secondBest ...)
    second = torch.sort(scores).values[-2]
    ok = (n_best >= min_good) & (second.float() < 0.75 * n_best.float())
    return InitResult(t_21=lie.rt_to_mat(Rs[best][0], ts[best][0]), pts_w=ptss[best][0],
                      good=goods[best][0], is_homography=use_h, ok=ok)


def initialize(cam, uv1, uv2, valid, generator: torch.Generator, n_trials: int = 200,
               sigma: float = 1.0, min_good: int = 50) -> InitResult:
    """Two-view initialization from matched pixels: `draw_indices` from the
    CPU `generator`, then `initialize_from_indices`."""
    idx = draw_indices(valid, n_trials, 8, generator)
    return initialize_from_indices(cam, uv1, uv2, valid, idx, sigma=sigma,
                                   min_good=min_good)
