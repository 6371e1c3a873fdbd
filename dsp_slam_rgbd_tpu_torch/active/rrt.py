"""3D RRT path planning with box-obstacle collision checks.

Counterpart of `dsp_slam_rgbd_tpu/active/rrt.py` (the fork's active-mapping
planner, `src/rrt.cpp`, `src/obstacles.cpp`): grow a tree from the start
toward the NBV viewpoint, reject segments that cross object cuboids, and
return the root-to-goal path.  Host-side numpy, as there (control-plane
work over ~100s of nodes): the same seed draws the same numbers from
numpy's `default_rng`, so both packages plan the same path.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class BoxObstacle(NamedTuple):
    center: np.ndarray  # (3,)
    R: np.ndarray       # (3, 3) box axes (columns)
    half: np.ndarray    # (3,) half extents


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def obstacles_from_map(state, margin: float = 1.2) -> list[BoxObstacle]:
    """Object cuboids as obstacles (NbvGenerator's collision set); one read
    of the map's object fields."""
    poses = _host(state.obj_pose)
    scales = _host(state.obj_scale)
    out = []
    for o in np.nonzero(_host(state.obj_valid))[0]:
        T = poses[o]
        out.append(BoxObstacle(center=T[:3, 3], R=T[:3, :3],
                               half=np.full(3, scales[o] * margin, np.float32)))
    return out


def _segment_hits_box(p0, p1, box: BoxObstacle, n_checks: int = 8) -> bool:
    ts = np.linspace(0.0, 1.0, n_checks)
    pts = p0[None, :] * (1 - ts[:, None]) + p1[None, :] * ts[:, None]
    local = (pts - box.center) @ box.R
    return bool(np.any(np.all(np.abs(local) <= box.half, axis=1)))


class RRTResult(NamedTuple):
    path: Optional[np.ndarray]  # (N, 3) start→goal, None if failed
    nodes: np.ndarray           # all tree nodes


def plan(start, goal, obstacles: list[BoxObstacle], bounds=None,
         step: float = 0.5, goal_tol: float = 0.5, max_iters: int = 2000,
         goal_bias: float = 0.15, seed: int = 0) -> RRTResult:
    """Classic RRT (reference `rrt.cpp`: nearest node by Euclidean distance,
    fixed step expansion, root-to-end path extraction)."""
    rng = np.random.default_rng(seed)
    start = np.asarray(start, np.float32)
    goal = np.asarray(goal, np.float32)
    if bounds is None:
        lo = np.minimum(start, goal) - 5.0
        hi = np.maximum(start, goal) + 5.0
    else:
        lo, hi = (np.asarray(b, np.float32) for b in bounds)

    nodes = [start]
    parents = [-1]
    for _ in range(max_iters):
        target = goal if rng.uniform() < goal_bias else \
            rng.uniform(lo, hi).astype(np.float32)
        arr = np.stack(nodes)
        nearest = int(np.argmin(np.linalg.norm(arr - target, axis=1)))
        d = target - nodes[nearest]
        dist = np.linalg.norm(d)
        new = nodes[nearest] + d / max(dist, 1e-9) * min(step, dist)
        if any(_segment_hits_box(nodes[nearest], new, b) for b in obstacles):
            continue
        nodes.append(new.astype(np.float32))
        parents.append(nearest)
        if np.linalg.norm(new - goal) <= goal_tol:
            if not any(_segment_hits_box(new, goal, b) for b in obstacles):
                nodes.append(goal)
                parents.append(len(nodes) - 2)
                path = []
                i = len(nodes) - 1
                while i >= 0:      # walk back to the root
                    path.append(nodes[i])
                    i = parents[i]
                return RRTResult(np.stack(path[::-1]), np.stack(nodes))
    return RRTResult(None, np.stack(nodes))
