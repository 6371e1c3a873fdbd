"""Bundle adjustment with the edge set sharded over the mesh's `ray` axis.

Counterpart of `dsp_slam_rgbd_tpu/parallel/sharded_ba.py` (:26-141): the
factor blocks (reprojection and object-pose observations) split over the
ranks; each rank accumulates the normal-equation blocks of its edges, the
blocks are summed over the ranks before the (small) reduced solve, and
every rank takes the identical step.  The JAX package leaves that sum
to GSPMD in `local_ba_sharded`; here it is one all_reduce in the
assembly (`mapping/ba.py::_assemble_and_solve`, `group=`).
`global_ba_pcg_sharded` states the exchange of the matrix-free solver:
one all_reduce of the blocks, one per CG matvec side
(`mapping/ba.py::_pcg_gn_step`, `group=`).  Each shard sums its own edges
in a fixed order (`ops/scatter.py`, a plan per shard), so a run repeats
bit for bit; results equal the unsharded solvers up to the order of the
sums across shards.
"""
from __future__ import annotations

from dsp_slam_rgbd_tpu_torch.mapping import ba
from dsp_slam_rgbd_tpu_torch.parallel import distributed as dist

EDGE_FIELDS = ("obs_kf", "obs_pt", "obs_uv", "obs_info", "obs_mask",
               "oobs_kf", "oobs_obj", "oobs_t_co", "oobs_mask")


def _ray_group(mesh):
    if not mesh.member:
        raise ValueError(f"rank {mesh.rank} is outside the mesh {mesh}")
    return mesh.group("ray")


def shard_problem(prob: ba.BAProblem, mesh) -> ba.BAProblem:
    """This rank's share of a problem every rank holds: both edge sets
    padded with inert rows (mask False) to a multiple of the `ray` axis and
    cut into contiguous slices; the state replicated."""
    group = _ray_group(mesh)
    upd = {}
    for f in EDGE_FIELDS:
        a = getattr(prob, f)
        start, stop, n = dist.shard_range(a.shape[0], group)
        upd[f] = dist.pad_rows(a, n, 0).narrow(0, start, stop - start)
    return prob._replace(**upd)


def _gather_masks(res: ba.BAResult, prob: ba.BAProblem, group) -> ba.BAResult:
    """The shards' edge masks gathered back, the padding cut off."""
    return res._replace(
        obs_mask=dist.gather_rows(res.obs_mask, group)[:prob.obs_mask.shape[0]],
        oobs_mask=dist.gather_rows(res.oobs_mask, group)[:prob.oobs_mask.shape[0]])


def local_ba_sharded(cam, prob: ba.BAProblem, group, stage1_iters: int = 5,
                     stage2_iters: int = 10) -> ba.BAResult:
    """The standard two-stage local BA over an edge shard (`prob` from
    `shard_problem`); the edge masks of the result are the shard's."""
    return ba.local_ba(cam, prob, stage1_iters=stage1_iters, stage2_iters=stage2_iters,
                       group=group)


def run_sharded_ba(cam, prob: ba.BAProblem, mesh, **kw) -> ba.BAResult:
    """Local BA with the edges of `prob` (the same on every rank) sharded
    over the mesh's `ray` axis; the whole result on every rank."""
    group = _ray_group(mesh)
    res = local_ba_sharded(cam, shard_problem(prob, mesh), group, **kw)
    return _gather_masks(res, prob, group)


def global_ba_pcg_sharded(cam, prob: ba.BAProblem, mesh, stage1_iters: int = 3,
                          stage2_iters: int = 7, cg_iters: int = 32,
                          damping: float = 1e-3) -> ba.BAResult:
    """At-scale global BA (matrix-free PCG) with the edge set sharded over
    the `ray` axis: two LM stages with the accept test on the summed
    robust cost and a shard-local gate after each.  Returns the whole
    result on every rank (edge masks gathered back, padding cut)."""
    group = _ray_group(mesh)
    shard = shard_problem(prob, mesh)
    plans = ba._pcg_plans(shard)   # this shard's edges: one plan per shard
    res = ba._two_stage(cam, shard, stage1_iters, stage2_iters, damping,
                        lambda p, lam: ba._pcg_gn_step(cam, p, lam, cg_iters, group, plans),
                        group)
    return _gather_masks(res, prob, group)
