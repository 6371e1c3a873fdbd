"""One rank of the port's two-process scale-out tests (CPU, gloo).

    python tests/torch_parallel_worker.py <rank> <world> <rendezvous file> <in.pkl> <out dir>

Reads the inputs that tests/test_torch_parallel.py wrote (numpy arrays and
the port's own config and detection tuples), joins a gloo group through a
`file://` rendezvous with a timeout, and runs on one thread:
  * the distribution helpers (`shard_global`, `fetch`, `replicate`);
  * the sharded reconstruction at meshes (2, 1) and (1, 2);
  * on a (1, 2) mesh, one LM step of each BA solver on an edge shard, and
    the sharded local BA and PCG;
  * a `SLAMSystem` over the sequence (its reconstruction mesh built from the
    group);
  * the same run at `async_kf_frames` 0 with rank 1 given no detections
    from frame 1 on: the ranks split, and must both raise at the next
    keyframe's agreement check.
Writes out_<rank>.pkl (numpy) into the out dir.  Imports torch and the
port only.
"""
import os
import pickle
import sys

import numpy as np
import torch


def sphere_sdf(code, xyz):
    """The sphere family of the JAX tests (tests/test_recon.py::sphere_fn):
    radius 0.5 + 0.2·code[0]."""
    return torch.linalg.vector_norm(xyz, dim=-1) - (0.5 + 0.2 * code[..., 0])


def _np(t):
    return t.detach().cpu().numpy()


def helpers(inputs):
    """The JAX package's distribution helpers on a 1-D `ray` mesh: a host
    array's shard and its gather, and a broadcast from rank 0."""
    from dsp_slam_rgbd_tpu_torch.parallel import distributed as dist

    mesh = dist.global_mesh("ray")
    group = mesh.group("ray")
    local = dist.shard_global(inputs["x"], group)
    rank_value = torch.full((3,), float(dist.world()[1]))
    return {"mesh": mesh.shape, "local": _np(local),
            "fetched": dist.fetch(local, group, n=len(inputs["x"])),
            "replicated": _np(dist.replicate(rank_value, src=0))}


def recon(inputs):
    from dsp_slam_rgbd_tpu_torch.models.deepsdf import AnalyticSdfDecoder
    from dsp_slam_rgbd_tpu_torch.parallel import mesh as mesh_mod
    from dsp_slam_rgbd_tpu_torch.parallel import sharded_recon
    from dsp_slam_rgbd_tpu_torch.recon.optimizer import ReconConfig

    dec = AnalyticSdfDecoder(sphere_sdf, inputs["code_len"])
    cfg = ReconConfig(**inputs["cfg"])
    batch = {k: torch.as_tensor(v) for k, v in inputs["batch"].items()}
    out = {}
    for shape in inputs["meshes"]:
        res = sharded_recon.reconstruct_sharded(dec, cfg, batch, mesh_mod.make_mesh(*shape))
        out[shape] = {k: _np(v) for k, v in res._asdict().items()}
        out[shape]["contiguous"] = all(v.is_contiguous() for v in res)
    return out


def bundle_adjustment(inputs):
    """Per problem: one LM step (dense, or PCG for the last problem) on this
    rank's edge shard with the blocks summed over the group, and the whole
    sharded solver."""
    from dsp_slam_rgbd_tpu_torch.mapping import ba
    from dsp_slam_rgbd_tpu_torch.ops import camera as cam_ops
    from dsp_slam_rgbd_tpu_torch.parallel import mesh as mesh_mod
    from dsp_slam_rgbd_tpu_torch.parallel import sharded_ba
    from dsp_slam_rgbd_tpu_torch.weights import ba_problem_from_numpy, ba_result_to_numpy

    cam = cam_ops.Intrinsics(*inputs["cam"])
    mesh = mesh_mod.make_mesh(1, 2)
    group = mesh.group("ray")
    out = {"local": [], "local_step": []}
    for p in inputs["local"]:
        prob = ba_problem_from_numpy(p, "cpu")
        step, _ = ba._assemble_and_solve(cam, sharded_ba.shard_problem(prob, mesh), 1e-3, group)
        out["local_step"].append({k: _np(getattr(step, k)) for k in ("kf_pose", "pts")})
        out["local"].append(ba_result_to_numpy(sharded_ba.run_sharded_ba(cam, prob, mesh)))
    prob = ba_problem_from_numpy(inputs["pcg"], "cpu")
    step, _ = ba._pcg_gn_step(cam, sharded_ba.shard_problem(prob, mesh), 1e-3, 32, group)
    out["pcg_step"] = {k: _np(getattr(step, k)) for k in ("kf_pose", "pts")}
    out["pcg"] = ba_result_to_numpy(sharded_ba.global_ba_pcg_sharded(cam, prob, mesh))
    return out


def slam(inputs):
    from dsp_slam_rgbd_tpu_torch.system.slam import SLAMSystem
    from dsp_slam_rgbd_tpu_torch.weights import decoder_from_numpy

    s = SLAMSystem(inputs["cfg"], decoder=decoder_from_numpy(inputs["layers"], inputs["spec"],
                                                              device="cpu"), device="cpu")
    try:
        for i, (left, right) in enumerate(inputs["imgs"]):
            s.track_stereo(left, right, timestamp=i * 0.1, detections=inputs["dets"][i])
        ts, poses, ok = s._frame_poses()
        st = s.state
        return {"ts": ts, "poses": poses, "ok": ok, "n_kf": s.n_kf,
                "mesh": None if s.recon_mesh is None else s.recon_mesh.shape,
                **{k: _np(getattr(st, k)) for k in ("obj_valid", "obj_pose", "obj_scale",
                                                   "obj_code", "kf_pose", "kf_valid")}}
    finally:
        s.shutdown()


def slam_split(inputs):
    """Rank 1 loses its detections from frame 1 on -> (the error each rank
    raised, or None; seconds from the start of the run to it)."""
    import dataclasses
    import time

    from dsp_slam_rgbd_tpu_torch.parallel import distributed as dist
    from dsp_slam_rgbd_tpu_torch.system.slam import SLAMSystem
    from dsp_slam_rgbd_tpu_torch.weights import decoder_from_numpy

    rank = dist.world()[1]
    s = SLAMSystem(dataclasses.replace(inputs["cfg"], async_kf_frames=0),
                   decoder=decoder_from_numpy(inputs["layers"], inputs["spec"], device="cpu"),
                   device="cpu")
    t0, error = time.perf_counter(), None
    try:
        for i, (left, right) in enumerate(inputs["imgs"]):
            dets = None if rank == 1 and i >= 1 else inputs["dets"][i]
            s.track_stereo(left, right, timestamp=i * 0.1, detections=dets)
    except RuntimeError as e:
        error = str(e)
    seconds = time.perf_counter() - t0
    s.shutdown()
    return {"error": error, "seconds": seconds}


def main(argv):
    rank, world, rendezvous, in_path, out_dir = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from dsp_slam_rgbd_tpu_torch.parallel import distributed as dist

    dist.initialize(f"file://{rendezvous}", world, rank, device="cpu", timeout_s=120.0)
    with open(in_path, "rb") as f:
        inputs = pickle.load(f)   # written by the test process for this run
    out = {"helpers": helpers(inputs["helpers"]), "recon": recon(inputs["recon"]),
           "ba": bundle_adjustment(inputs["ba"]),
           "slam": slam(inputs["slam"]), "slam_split": slam_split(inputs["slam"])}
    with open(os.path.join(out_dir, f"out_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main(sys.argv[1:])
