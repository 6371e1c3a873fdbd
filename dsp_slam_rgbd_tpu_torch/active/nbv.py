"""Next-best-view generation: viewpoint candidates, rewards, planning glue.

Counterpart of `dsp_slam_rgbd_tpu/active/nbv.py` (reference `NbvGenerator`,
`src/NbvGenerator.cpp:27-160`): pick a target object, compute its NBV
viewpoint (`mapping.objects.compute_nbv`, the centroid reflection),
enumerate the yaw-rotated candidates around it (`RotateCandidates`,
mDivide = 36 steps over [−π/2, π/2]), score them by the SDF uncertainty
of the object's member points they see minus the motion cost
(`mReward_dis` / `mReward_angle_cost`), and plan an RRT path to the best.

The 37 candidates are scored as one batched tensor expression (frustum
visibility of the member points × their |SDF| error), and the errors come
from one decoder query over the member points: on the card the f32 value
kernel for the kernels' layouts (latent 64 or 256).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from dsp_slam_rgbd_tpu_torch.active import rrt
from dsp_slam_rgbd_tpu_torch.mapping import objects as obj_mod
from dsp_slam_rgbd_tpu_torch.ops import camera as cam_ops
from dsp_slam_rgbd_tpu_torch.ops import lie
from dsp_slam_rgbd_tpu_torch.recon.optimizer import mean_sdf_loss

N_DIVIDE = 36          # reference RotateCandidates mDivide
MAX_MEMBER_PTS = 2048  # fixed-capacity member-point subset for scoring


class NbvPlan(NamedTuple):
    target_obj: int
    view_t_wc: np.ndarray        # (4, 4) best camera pose (cam→world)
    path: Optional[np.ndarray]   # (N, 3) waypoints or None
    score: float                 # mean SDF of the owned points (uncertainty)
    candidates: Optional[np.ndarray] = None  # (C, 4, 4) enumerated poses
    rewards: Optional[np.ndarray] = None     # (C,) per-candidate rewards


def _members(state, obj_slot: int) -> np.ndarray:
    """Host mask of the object's live member points (one read)."""
    return ((state.pt_object == obj_slot) & state.pt_valid).cpu().numpy()


def object_uncertainty(state, obj_slot: int, decoder) -> float:
    """Mean SDF of the object's member points in its normalized frame: high
    values mean the shape fit disagrees with the map (reference
    `compute_sdf_loss_of_all_inside_points`)."""
    member = _members(state, obj_slot)
    if member.sum() < 5 or decoder is None:
        return 0.0
    T_ow = lie.inv_se3(state.obj_pose[obj_slot])
    local = lie.transform_points(T_ow, state.pt_pos) / state.obj_scale[obj_slot]
    mask = torch.as_tensor(member, device=state.pt_pos.device)
    return float(mean_sdf_loss(decoder, local, mask, state.obj_code[obj_slot]))


def rotate_candidates(t_wc_init: torch.Tensor, n_divide: int = N_DIVIDE) -> torch.Tensor:
    """(n_divide+1, 4, 4) yaw-divided candidate poses about the base pose
    (reference `RotateCandidates`: angles −π/2..π/2 in π/n steps, rotation
    in place, about the camera's up axis)."""
    dev = t_wc_init.device
    a = torch.arange(n_divide + 1, device=dev) * (math.pi / n_divide) - math.pi / 2.0
    ca, sa = torch.cos(a), torch.sin(a)
    z = torch.zeros_like(a)
    o = torch.ones_like(a)
    ry = torch.stack([
        torch.stack([ca, z, sa, z], -1),
        torch.stack([z, o, z, z], -1),
        torch.stack([-sa, z, ca, z], -1),
        torch.stack([z, z, z, o], -1),
    ], -2)                                  # (C, 4, 4)
    return torch.einsum("ij,cjk->cik", t_wc_init.float(), ry)


def score_candidates(cam, cand_t_wc, cur_t_wc, pts_w, pt_err, pt_mask,
                     w_dis: float = 0.2, w_angle: float = 0.3) -> torch.Tensor:
    """(C,) rewards: Σ |SDF error| of member points inside the candidate's
    frustum − w_dis·travel − w_angle·heading change, all candidates in one
    batched expression."""
    t_cw = lie.inv_se3(cand_t_wc)                               # (C, 4, 4)
    pc = lie.transform_points(t_cw, pts_w.expand((t_cw.shape[0],) + pts_w.shape))
    uv = cam_ops.project(cam, pc)                               # (C, M, 2)
    vis = (pc[..., 2] > 0.2) \
        & (uv[..., 0] >= 0.0) & (uv[..., 0] < 2.0 * cam.cx) \
        & (uv[..., 1] >= 0.0) & (uv[..., 1] < 2.0 * cam.cy)
    gain = torch.sum(torch.where(vis & pt_mask, pt_err, 0.0), dim=-1)
    dis = torch.linalg.vector_norm(cand_t_wc[:, :3, 3] - cur_t_wc[:3, 3], dim=-1)
    cosang = torch.clamp(cand_t_wc[:, :3, 2] @ cur_t_wc[:3, 2], -1.0, 1.0)
    return gain - w_dis * dis - w_angle * torch.arccos(cosang)


def member_sdf_errors(state, obj_slot: int, decoder):
    """Fixed-capacity member-point subset with per-point |SDF| errors in
    the world frame: (pts_w (M, 3), err (M,), mask (M,)).  The error is the
    fork's per-point SDF diagnostic (`MapObject_util.cc:9-49`)."""
    sel = np.nonzero(_members(state, obj_slot))[0]
    if len(sel) > MAX_MEMBER_PTS:
        sel = sel[np.linspace(0, len(sel) - 1, MAX_MEMBER_PTS).astype(int)]
    idx = np.zeros(MAX_MEMBER_PTS, np.int64)
    idx[: len(sel)] = sel
    mask = np.zeros(MAX_MEMBER_PTS, bool)
    mask[: len(sel)] = True
    dev = state.pt_pos.device
    pts_w = state.pt_pos[torch.as_tensor(idx, device=dev)]
    T_ow = lie.inv_se3(state.obj_pose[obj_slot])
    local = lie.transform_points(T_ow, pts_w) / torch.clamp_min(state.obj_scale[obj_slot], 1e-6)
    err = torch.abs(decoder.query(state.obj_code[obj_slot], local))
    return pts_w, err, torch.as_tensor(mask, device=dev)


def generate(state, cam_t_wc, decoder=None, target: int | None = None, cam=None,
             n_candidates: int = N_DIVIDE) -> NbvPlan | None:
    """Pick the target object (the first valid slot by default, like the
    reference's `mvpMapObjects[0]`), compute its NBV, enumerate and score
    the rotated candidates (given a camera model and a decoder), and plan
    an RRT path to the winner.  `state`: the port's `MapState`; `decoder`:
    a `DeepSDFDecoder` or `AnalyticSdfDecoder` on the state's device."""
    valid = np.nonzero(state.obj_valid.cpu().numpy())[0]
    if len(valid) == 0:
        return None
    if target is None:
        target = int(valid[0])
    dev = state.obj_pose.device
    cam_t_wc = torch.as_tensor(np.asarray(cam_t_wc, np.float32), device=dev)
    view = obj_mod.compute_nbv(state.obj_pose[target, :3, 3], cam_t_wc[:3, 3])
    score = object_uncertainty(state, target, decoder)

    candidates = rewards = None
    if cam is not None and decoder is not None:
        cands = rotate_candidates(view, n_candidates)
        pts_w, err, mask = member_sdf_errors(state, target, decoder)
        r = score_candidates(cam, cands, cam_t_wc, pts_w, err, mask)
        candidates = cands.cpu().numpy()
        rewards = r.cpu().numpy()
        view = cands[int(np.argmax(rewards))]
    view = view.cpu().numpy()

    plan = rrt.plan(cam_t_wc[:3, 3].cpu().numpy(), view[:3, 3], rrt.obstacles_from_map(state))
    return NbvPlan(target, view, plan.path, score, candidates, rewards)
