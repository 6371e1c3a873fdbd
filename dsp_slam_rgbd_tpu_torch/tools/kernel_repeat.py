"""Do the f32 decoder kernels repeat bit for bit?  A diagnostic for the card.

  python -m dsp_slam_rgbd_tpu_torch.tools.kernel_repeat loop [--runs 12] [--deterministic]
  python -m dsp_slam_rgbd_tpu_torch.tools.kernel_repeat isolated [--calls 150]

`loop`: the command line (`tools/run_slam.py`) over the first 8 frames of
chip_smoke.py phase 12a's directory (`sequence_dirs.write_kitti_objects`:
8 objects, the fixture decoder), `--runs` times; inside it every f32
`sdf_value_fused` and `sdf_and_input_jacobian_fused` call is made three
times on the same inputs and stream, and each call whose three results are
not all equal is printed with the rows that differ.  `--deterministic`
turns on `parallel/distributed.keep_replicas_identical` first.

`isolated`: each f32 kernel at the object stage's row counts (7 objects of
256 or 2,048 rows, one of 2,048) `--calls` times on a stream of its own,
against its first result, while another thread keeps a second stream busy
with small elementwise kernels, then with ORB extraction.

Prints one line a finding and a summary line; the card only.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import threading
from unittest import mock

import numpy as np
import torch


def _rows_that_differ(x: torch.Tensor, y: torch.Tensor, n: int) -> list:
    return torch.nonzero((x.reshape(n, -1) != y.reshape(n, -1)).any(1)).flatten().tolist()


def loop(runs: int, deterministic: bool) -> dict:
    from dsp_slam_rgbd_tpu_torch.mapping import local_mapping as lm
    from dsp_slam_rgbd_tpu_torch.ops.cuda import mlp_sdf
    from dsp_slam_rgbd_tpu_torch.parallel import distributed as dist
    from dsp_slam_rgbd_tpu_torch.tools import run_slam
    from dsp_slam_rgbd_tpu_torch.tools import sequence_dirs as sd
    from dsp_slam_rgbd_tpu_torch.tools.ellipsoid import FIXTURE

    if deterministic:
        dist.keep_replicas_identical()
    stats = {"calls": 0, "differ": 0}

    def thrice(name, kind):
        real = getattr(mlp_sdf, name)

        def call(wb, code, xyz, compute_dtype=torch.float32, *a, **k):
            outs = [real(wb, code, xyz, compute_dtype, *a, **k) for _ in range(3)]
            if compute_dtype != torch.float32:
                return outs[0]
            stats["calls"] += 1
            outs = [o if isinstance(o, tuple) else (o,) for o in outs]
            n = xyz.reshape(-1, 3).shape[0]
            for j in range(len(outs[0])):
                s01, s02, s12 = (torch.equal(outs[p][j], outs[q][j])
                                 for p, q in ((0, 1), (0, 2), (1, 2)))
                if s01 and s02:
                    continue
                stats["differ"] += 1
                # the call that disagrees with the two that agree (0 when none agree)
                odd = 2 if s01 else 1 if s02 else 0
                got, ref = outs[odd][j], outs[(odd + 1) % 3][j]
                rows = _rows_that_differ(got, ref, n)
                print(f"{name} n={n} tiling {mlp_sdf.f32_tiling(kind, n)} output {j}: call {odd} "
                      f"of 3 differs at {len(rows)} rows {rows[:24]} (within the 32-row tile: "
                      f"{sorted({r % 32 for r in rows})}), up to "
                      f"{float((got - ref).abs().max()):.3g}, NaN {bool(torch.isnan(got).any())}, "
                      f"the other two agree {s01 or s02 or s12}", flush=True)
                break
            return outs[0] if len(outs[0]) > 1 else outs[0][0]

        return mock.patch.object(mlp_sdf, name, call)

    with tempfile.TemporaryDirectory() as tmp:
        paths = sd.write_kitti_objects(os.path.join(tmp, "kitti"))
        with thrice("sdf_value_fused", "value"), thrice("sdf_and_input_jacobian_fused", "jacobian"):
            for r in range(runs):
                lm._bucket_memo.clear()
                run_slam.main([paths["seq"], os.path.join(tmp, f"out{r}"), "--yaml", paths["yaml"],
                               "--labels", paths["labels"], "--deepsdf", FIXTURE,
                               "--max-frames", "8"])
                torch.cuda.synchronize()
    print(f"loop: {stats['differ']} of {stats['calls']} f32 kernel calls did not repeat "
          f"({runs} runs, deterministic algorithms {deterministic})", flush=True)
    return stats


def isolated(calls: int) -> dict:
    from dsp_slam_rgbd_tpu_torch.frontend import orb
    from dsp_slam_rgbd_tpu_torch.models import deepsdf
    from dsp_slam_rgbd_tpu_torch.ops.cuda import mlp_sdf
    from dsp_slam_rgbd_tpu_torch.tools.ellipsoid import FIXTURE

    dev = torch.device("cuda")
    dec = deepsdf.load_npz(FIXTURE, device=dev)
    g = np.random.default_rng(0)
    img = torch.tensor(np.abs(g.standard_normal((376, 1241))) * 80 + 40, dtype=torch.float32,
                       device=dev)
    stop = threading.Event()

    def elementwise():
        s, x = torch.cuda.Stream(), torch.randn(1 << 16, device=dev)
        with torch.cuda.stream(s):
            while not stop.is_set():
                for _ in range(50):
                    x = x * 1.0001 + 0.5
                s.synchronize()

    def orb_frames():
        s = torch.cuda.Stream()
        with torch.cuda.stream(s):
            while not stop.is_set():
                orb.extract(img, orb.OrbConfig(), device=dev)
                s.synchronize()

    wb, stats = dec.packed(torch.float32), {"calls": 0, "differ": 0}
    for rows, n_obj in ((1792, 7), (2048, 1), (14336, 7)):
        code = torch.tensor(g.standard_normal((n_obj, 64)) * 0.5, dtype=torch.float32,
                            device=dev)
        xyz = torch.tensor(g.standard_normal((n_obj, rows // n_obj, 3)) * 0.4,
                           dtype=torch.float32, device=dev)
        for kind, fn in (
                ("value", lambda: (mlp_sdf.sdf_value_fused(wb, code, xyz, torch.float32,
                                                           dec.tiles()),)),
                ("jacobian", lambda: mlp_sdf.sdf_and_input_jacobian_fused(
                    wb, code, xyz, torch.float32, dec.tiles(jacobian=True)))):
            ref = [t.clone() for t in fn()]
            side = torch.cuda.Stream()
            for noise in (elementwise, orb_frames):
                stop.clear()
                th = threading.Thread(target=noise)
                th.start()
                bad = 0
                for _ in range(calls):
                    with torch.cuda.stream(side):
                        out = fn()
                    side.synchronize()
                    bad += any(not torch.equal(a, b) for a, b in zip(out, ref))
                stop.set()
                th.join()
                stats["calls"] += calls
                stats["differ"] += bad
                print(f"isolated {kind} rows {rows} tiling {mlp_sdf.f32_tiling(kind, rows)} beside "
                      f"{noise.__name__}: {bad} of {calls} calls differ from the first", flush=True)
    print(f"isolated: {stats['differ']} of {stats['calls']} calls did not repeat", flush=True)
    return stats


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["loop", "isolated"])
    ap.add_argument("--runs", type=int, default=12)
    ap.add_argument("--calls", type=int, default=150)
    ap.add_argument("--deterministic", action="store_true")
    args = ap.parse_args(argv)

    from dsp_slam_rgbd_tpu_torch import device as device_mod
    from dsp_slam_rgbd_tpu_torch.ops.cuda import build

    device_mod.resolve("cuda")
    build.load()
    return loop(args.runs, args.deterministic) if args.mode == "loop" else isolated(args.calls)


if __name__ == "__main__":
    main()
