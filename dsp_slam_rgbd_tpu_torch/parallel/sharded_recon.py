"""Object reconstruction sharded over the (obj, ray) mesh.

Counterpart of `dsp_slam_rgbd_tpu/parallel/sharded_recon.py` (:21-61).
The object batch splits over the mesh's `obj` axis (each row of the mesh
fits its slice), and each object's decoder rows split over the `ray`
axis, with the normal equations summed over it
(`recon/optimizer.py`, `group=`).  The decoder's weights are replicated:
every rank builds or loads the same decoder.  Every rank of the mesh
gets the whole result, gathered over `obj`.
"""
from __future__ import annotations

import torch

from dsp_slam_rgbd_tpu_torch.parallel import distributed as dist
from dsp_slam_rgbd_tpu_torch.recon import optimizer as recon_opt

BATCH_KEYS = ("t_cam_obj", "pts", "pts_mask", "rays", "ray_mask", "depth_obs",
              "fg_mask", "code_init")


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's share of a reconstruction batch that every rank holds.

    batch keys: t_cam_obj (B,4,4), pts (B,N,3), pts_mask (B,N),
    rays (B,R,3), ray_mask (B,R), depth_obs (B,R), fg_mask (B,R),
    code_init (B,L).  The batch is padded to a multiple of the `obj` axis
    with copies of object 0 and cut into contiguous slices; the ray-axis
    split of the decoder rows happens inside the fit, since every
    selection over an object's rays needs all of them."""
    if not mesh.member:
        raise ValueError(f"rank {mesh.rank} is outside the mesh {mesh}")
    B = batch["t_cam_obj"].shape[0]
    per = -(-B // mesh.n_obj)
    i = mesh.index("obj")
    out = {}
    for k in BATCH_KEYS:
        x = batch[k]
        if per * mesh.n_obj > B:
            x = torch.cat([x, x[:1].expand((per * mesh.n_obj - B,) + tuple(x.shape[1:]))])
        out[k] = x[i * per:(i + 1) * per]
    return out


def reconstruct_sharded(decoder, cfg, batch: dict, mesh,
                        compute_dtype=torch.float32) -> recon_opt.ReconResult:
    """Fit every object of `batch` (tensors on the decoder's device, the
    same on every rank) across the mesh; returns the whole ReconResult on
    every rank of the mesh."""
    B = batch["t_cam_obj"].shape[0]
    local = shard_batch(batch, mesh)
    res = recon_opt.reconstruct_objects_batched(
        decoder, cfg, local["t_cam_obj"], local["pts"], local["pts_mask"], local["rays"],
        local["ray_mask"], local["depth_obs"], local["fg_mask"], local["code_init"],
        compute_dtype=compute_dtype, group=mesh.group("ray"))
    group = mesh.group("obj")
    if group is None:
        return recon_opt.ReconResult(*(x[:B] for x in res))
    # one gather over `obj`: [pose (16) | code (L) | is_good | loss] per object
    n = res.code.shape[0]
    packed = torch.cat([res.t_cam_obj.reshape(n, 16), res.code,
                        res.is_good.float()[:, None], res.loss[:, None]], 1)
    full = dist.gather_rows(packed, group, 0)[:B]
    L = res.code.shape[1]
    # columns of the packed rows, each made contiguous (as the unsharded
    # fit returns them: the decoder kernels take contiguous codes only)
    return recon_opt.ReconResult(full[:, :16].reshape(B, 4, 4).contiguous(),
                                 full[:, 16:16 + L].contiguous(), full[:, 16 + L] > 0.5,
                                 full[:, 17 + L].contiguous())
