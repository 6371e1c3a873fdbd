"""Scaling of the sharded object reconstruction over 1..N ranks.

Counterpart of `tools/bench_scaling.py` (BASELINE.md: throughput and
scaling efficiency at 1 and N devices), over the port's scale-out tier:
`parallel/mesh.make_mesh(n_obj=n, n_ray=1)` and
`parallel/sharded_recon.reconstruct_sharded` fit `--batch-per-device`
objects a rank with `ReconConfig()` in f32 (the f32 decoder kernels for
the cars_64 layout), 256 surface points and 512 rays an object, on the
trained fixture decoder and `tools/bench.make_batch`'s objects of its
family.  For each mesh size n of {1, 2, N} it prints one
JSON row: devices, reconstructions a second, SDF queries a second
(`bench_scaling.py`'s count a fit) and the efficiency against n times the
one-rank rate.

A rank is a process.  With `--processes N` it spawns N ranks of itself,
which join one `torch.distributed` group through a rendezvous file: gloo
with `--device cpu`, NCCL with one card a rank on CUDA.  With one rank it
runs in-process over a one-rank group.  A machine with one card can
measure only N = 1 (NCCL does not give two ranks one card); N >= 2 then
runs only on the CPU, where the ranks share one host's cores and the
efficiency says little about cards.  (The JAX tool's virtual CPU mesh,
`--cpu`, has no counterpart.)

Usage:
  python -m dsp_slam_rgbd_tpu_torch.tools.bench_scaling [--processes N] \
      [--batch-per-device 8] [--reps 3] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from dsp_slam_rgbd_tpu_torch.tools.bench import drain, make_batch
from dsp_slam_rgbd_tpu_torch.tools.ellipsoid import FIXTURE

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RANK_TIMEOUT_S = 1200.0   # a spawned rank that takes longer fails the bench


def run_rank(args, dev: torch.device) -> list:
    """Every rank of the default group runs this; rank 0 returns (and
    prints) the rows."""
    import torch.distributed as tdist

    from dsp_slam_rgbd_tpu_torch.models import deepsdf
    from dsp_slam_rgbd_tpu_torch.parallel import distributed as dist
    from dsp_slam_rgbd_tpu_torch.parallel import mesh as mesh_mod
    from dsp_slam_rgbd_tpu_torch.parallel import sharded_recon
    from dsp_slam_rgbd_tpu_torch.recon.optimizer import ReconConfig

    world, rank = dist.world()
    decoder = deepsdf.load_npz(args.decoder, device=dev)
    cfg = ReconConfig(num_iterations=args.iterations)

    def barrier():
        drain(dev)
        tdist.barrier()

    rows, base_rate = [], None
    for nd in sorted({1, 2, world} & set(range(1, world + 1))):
        B = args.batch_per_device * nd
        batch = make_batch(B, args.points, args.rays, cfg.code_len, dev)
        mesh = mesh_mod.make_mesh(n_obj=nd, n_ray=1)

        def fit():
            if mesh.member:
                return sharded_recon.reconstruct_sharded(decoder, cfg, batch, mesh)

        out = fit()
        barrier()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = fit()
        barrier()
        rate = B * args.reps / (time.perf_counter() - t0)
        if out is not None and not bool(torch.isfinite(out.t_cam_obj).all()):
            raise RuntimeError(f"rank {rank}: non-finite poses at {nd} ranks")
        q_per = cfg.num_iterations * (
            min(args.rays * cfg.num_depth_samples, cfg.max_valid_samples)
            + cfg.max_grad_points + args.points)
        if base_rate is None:
            base_rate = rate / nd
        row = {"devices": nd, "recon_per_s": rate, "sdf_queries_per_s": rate * q_per,
               "efficiency": rate / (base_rate * nd)}
        if rank == 0:
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def spawn(args, argv: list) -> list:
    """Start `args.processes` ranks of this tool and wait for them; returns
    rank 0's rows.  Any rank that fails fails the bench."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "dsp_slam_rgbd_tpu_torch.tools.bench_scaling", *argv,
             "--worker-rank", str(r), "--rendezvous", os.path.join(tmp, "rendezvous")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
            for r in range(args.processes)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"ranks {failed} failed:\n" + "\n".join(outs))
    rows = [json.loads(ln) for ln in outs[0].splitlines() if ln.startswith("{")]
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> list:
    """Prints one JSON row a mesh size; returns them."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--processes", type=int, default=1, help="ranks (one process each)")
    ap.add_argument("--batch-per-device", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--points", type=int, default=256)
    ap.add_argument("--rays", type=int, default=512)
    ap.add_argument("--iterations", type=int, default=10, help="GN iterations a fit")
    ap.add_argument("--decoder", default=FIXTURE)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--worker-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rendezvous", default=None, help=argparse.SUPPRESS)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)

    import torch.distributed as tdist

    from dsp_slam_rgbd_tpu_torch import device as device_mod
    from dsp_slam_rgbd_tpu_torch.parallel import distributed as dist

    device_mod.resolve(args.device)
    if args.worker_rank is None and args.processes > 1:
        return spawn(args, argv)
    if args.worker_rank is not None:
        if args.device == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.processes))
        dev = dist.initialize(f"file://{args.rendezvous}", args.processes, args.worker_rank,
                              device=args.device)
        try:
            return run_rank(args, dev)
        finally:
            tdist.destroy_process_group()
    # one rank, in this process
    with tempfile.TemporaryDirectory() as tmp:
        dev = dist.initialize(f"file://{tmp}/rendezvous", 1, 0, device=args.device)
        try:
            return run_rank(args, dev)
        finally:
            tdist.destroy_process_group()


if __name__ == "__main__":
    main()
