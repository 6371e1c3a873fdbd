"""The (obj, ray) mesh over `torch.distributed` ranks.

Counterpart of `dsp_slam_rgbd_tpu/parallel/mesh.py` (:19-28).  The axes:

  * `obj` — data parallelism over objects: each row of the mesh fits its
    own slice of the object batch;
  * `ray` — inside one object's fit: the decoder rows (surface points,
    ray samples, gradient points) split over the ranks of a row, and the
    normal equations summed over them (`recon/optimizer.py`); in bundle
    adjustment the observation edges split the same way
    (`parallel/sharded_ba.py`).

Rank r sits at (r // n_ray, r % n_ray).  The mesh holds one subgroup per
row (its `ray` group) and per column (its `obj` group); every rank of the
default group takes part in building them (`new_group` is collective),
ranks past n_obj·n_ray included.
"""
from __future__ import annotations

import torch.distributed as tdist

from dsp_slam_rgbd_tpu_torch.parallel import distributed as dist

AXES = ("obj", "ray")


class Mesh:
    """An n_obj × n_ray grid of ranks.  `group(axis)` is this rank's
    process group along `axis` (None in a single process, where every
    collective is the identity); `index(axis)` its coordinate (None for a
    rank outside the grid)."""

    def __init__(self, n_obj: int, n_ray: int, rank: int, groups: dict):
        self.n_obj, self.n_ray = n_obj, n_ray
        self.rank = rank
        self._groups = groups

    @property
    def shape(self) -> dict:
        return {"obj": self.n_obj, "ray": self.n_ray}

    @property
    def size(self) -> int:
        return self.n_obj * self.n_ray

    @property
    def member(self) -> bool:
        return self.rank < self.size

    def index(self, axis: str):
        if not self.member:
            return None
        return self.rank // self.n_ray if axis == "obj" else self.rank % self.n_ray

    def group(self, axis: str):
        if axis not in AXES:
            raise ValueError(f"unknown mesh axis {axis!r}")
        return self._groups.get(axis)

    def __repr__(self) -> str:
        return f"Mesh(obj={self.n_obj}, ray={self.n_ray}, rank={self.rank})"


def make_mesh(n_obj: int | None = None, n_ray: int = 1) -> Mesh:
    """Build an (obj, ray) mesh over the ranks of the default process group
    (one rank without one).  n_obj defaults to world_size // n_ray."""
    world_size, rank = dist.world()
    if n_obj is None:
        n_obj = world_size // n_ray
    if n_obj < 1 or n_ray < 1 or n_obj * n_ray > world_size:
        raise ValueError(f"mesh {n_obj}x{n_ray} does not fit {world_size} rank(s)")
    groups = {}
    if tdist.is_available() and tdist.is_initialized():
        # every rank creates every subgroup, in the same order
        for j in range(n_ray):
            g = tdist.new_group([i * n_ray + j for i in range(n_obj)])
            if rank < n_obj * n_ray and rank % n_ray == j:
                groups["obj"] = g
        for i in range(n_obj):
            g = tdist.new_group([i * n_ray + j for j in range(n_ray)])
            if rank < n_obj * n_ray and rank // n_ray == i:
                groups["ray"] = g
    return Mesh(n_obj, n_ray, rank, groups)
