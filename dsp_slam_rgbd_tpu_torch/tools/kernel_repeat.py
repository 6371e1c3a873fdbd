"""Do the decoder kernels repeat bit for bit?  A check for the card.

  python -m dsp_slam_rgbd_tpu_torch.tools.kernel_repeat loop [--runs 12] [--deterministic]
  python -m dsp_slam_rgbd_tpu_torch.tools.kernel_repeat loop-fast [--runs 1]
  python -m dsp_slam_rgbd_tpu_torch.tools.kernel_repeat stress [--min-calls 600] [--seconds 60]
                                                               [--noise twin,orb,hammer]

Every mode makes each call of the decoder kernels it reaches three times
on the same inputs and stream (`repeating`), counts the calls whose three
results are not all equal, per kernel and per tiling, and prints each such
call with the rows and columns that differ and their rows within the tile.

`loop`: the command line (`tools/run_slam.py`) over the first 8 frames of
chip_smoke.py phase 12a's directory (`sequence_dirs.write_kitti_objects`:
8 objects, the fixture decoder, `ReconConfig()`: the f32 pair), `--runs`
times.  `--deterministic` turns on
`parallel/distributed.keep_replicas_identical` first.

`loop-fast`: the bf16 pair under `gpu_fast`, `--runs` times: the system
loop of `tools/bench_pipeline.py` (12 frames, one pass; the bf16 value
kernel, and the object stage's f32 Jacobian), then `tools/bench.py`'s
batched fits (the bf16 Jacobian and value kernels) over and over while a
second thread runs that pipeline again.

`stress`: the object stage's and the batched fits' launch sizes (`SHAPES`:
A x 256 refinement rows, U x 2,048 render rows, the value pass's U x 8,192
and U x 24^3 rows, several objects a launch, and the bf16 fits' sizes) in
a seeded order, through `DeepSDFDecoder.query` / `query_with_jacobian`, on
a stream of its own, until `--min-calls` calls or `--seconds`, beside the
`--noise` threads: `twin` (a second host thread launching the f32 pair at
the same sizes on its own stream, its calls checked too), `orb` (ORB
extraction at KITTI size on a third stream) and `hammer` (memory-bound
elementwise and reduction kernels over 256 MB on a fourth, whose small
blocks share SMs with the decoder's CTAs).

`--csrc DIR` builds the kernels from another checkout's `csrc/` (one with
this C interface), e.g. a parent commit's.  Each mode returns, and prints
last, its summary: {"mode", "calls", "differ", "kernels": {kernel:
{"calls", "differ", "tilings": {"32x1": [calls, differ]}, "rows"}},
"findings": the first 100 calls that did not repeat}.  The card only.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import threading
import time
from unittest import mock

import numpy as np
import torch

from dsp_slam_rgbd_tpu_torch.ops.cuda import mlp_sdf

KINDS = {"sdf_value_fused": "value", "sdf_and_input_jacobian_fused": "jacobian"}
F32, BF16 = torch.float32, torch.bfloat16
# (kind, dtype, objects, rows a code): refine_associated's A x 256 rows,
# recon_unmatched's U x 2,048 render rows, its value pass at U x 8,192 and
# sdf_bbox's U x 24^3; the bf16 fits' (B = 8) SDF, render and value rows
SHAPES = tuple(("jacobian", F32, a, 256) for a in (1, 2, 3, 5, 8)) + tuple(
    ("jacobian", F32, u, 2048) for u in (1, 2, 4, 7)) + (
    ("value", F32, 3, 8192), ("value", F32, 7, 8192), ("value", F32, 2, 24 ** 3),
    ("value", F32, 7, 24 ** 3), ("jacobian", BF16, 8, 256), ("jacobian", BF16, 8, 1024),
    ("value", BF16, 8, 12800))
NOISE = ("twin", "orb", "hammer")
MAX_FINDINGS = 100   # calls that did not repeat kept (and printed) in full


def tiling_of(kind: str, dtype, n: int) -> str:
    """The tiling a launch of n rows takes: rows of a tile x CTAs sharing it."""
    if dtype == BF16:
        return "64x1"
    rows, c = mlp_sdf.f32_tiling(kind, n)
    return f"{rows}x{c}"


def compare(outs, n: int, tile: int) -> dict | None:
    """None when the three calls' outputs (tuples, n rows each) are equal bit
    for bit; else the first output that differs: which call disagrees with
    the two that agree (0 when none agree), its rows and columns that
    differ, those rows within a tile of `tile` rows, the largest
    difference and whether it holds a NaN."""
    for j in range(len(outs[0])):
        s01, s02, s12 = (torch.equal(outs[p][j], outs[q][j]) for p, q in ((0, 1), (0, 2), (1, 2)))
        if s01 and s02:
            continue
        odd = 2 if s01 else 1 if s02 else 0
        got, ref = outs[odd][j].reshape(n, -1), outs[(odd + 1) % 3][j].reshape(n, -1)
        diff = got != ref
        rows = torch.nonzero(diff.any(1)).flatten().tolist()
        return {"output": j, "call": odd, "n_rows": len(rows), "rows": rows[:24],
                "tile_rows": sorted({r % tile for r in rows}),
                "cols": torch.nonzero(diff.any(0)).flatten().tolist(),
                "max_abs": float((got - ref).abs().max()),
                "nan": bool(torch.isnan(got).any()), "two_agree": s01 or s02 or s12}
    return None


class Tally:
    """Calls and calls that did not repeat, per kernel and tiling; thread-safe."""

    def __init__(self):
        self.kernels, self.findings = {}, []
        self._lock = threading.Lock()

    def add(self, kernel: str, tiling: str, rows: int, finding: dict | None) -> bool:
        """Count one call; True when its finding is kept."""
        with self._lock:
            k = self.kernels.setdefault(kernel, {"calls": 0, "differ": 0, "tilings": {},
                                                 "rows": set()})
            t = k["tilings"].setdefault(tiling, [0, 0])
            bad = finding is not None
            k["calls"] += 1
            k["differ"] += bad
            t[0] += 1
            t[1] += bad
            k["rows"].add(rows)
            keep = bad and len(self.findings) < MAX_FINDINGS
            if keep:
                self.findings.append(dict(finding, kernel=kernel, tiling=tiling, n=rows))
            return keep

    def summary(self, mode: str) -> dict:
        with self._lock:
            kernels = {name: dict(k, tilings=dict(k["tilings"]), rows=sorted(k["rows"]))
                       for name, k in sorted(self.kernels.items())}
            return {"mode": mode, "calls": sum(k["calls"] for k in kernels.values()),
                    "differ": sum(k["differ"] for k in kernels.values()),
                    "kernels": kernels, "findings": list(self.findings)}


@contextlib.contextmanager
def repeating(tally: Tally):
    """Every `sdf_value_fused` / `sdf_and_input_jacobian_fused` call made
    three times on the same inputs and stream, and counted in `tally`;
    the first call's result is returned."""
    def wrap(name):
        real, kind = getattr(mlp_sdf, name), KINDS[name]

        def call(wb, code, xyz, compute_dtype=F32, *a, **k):
            outs = [real(wb, code, xyz, compute_dtype, *a, **k) for _ in range(3)]
            outs = [o if isinstance(o, tuple) else (o,) for o in outs]
            n = xyz.reshape(-1, 3).shape[0]
            tiling = tiling_of(kind, compute_dtype, n)
            found = compare(outs, n, int(tiling.split("x")[0]))
            kernel = mlp_sdf.kernel_name(f"mlp_sdf_{kind}", compute_dtype)
            if tally.add(kernel, tiling, n, found):
                print(f"{kernel} n={n} tiling {tiling}: {found}", flush=True)
            return outs[0] if len(outs[0]) > 1 else outs[0][0]

        return mock.patch.object(mlp_sdf, name, call)

    with wrap("sdf_value_fused"), wrap("sdf_and_input_jacobian_fused"):
        yield tally


def _report(summary: dict) -> dict:
    for name, k in summary["kernels"].items():
        print(f"{summary['mode']}: {name}: {k['differ']} of {k['calls']} calls did not repeat; "
              f"by tiling (calls, differ) {k['tilings']}; rows {k['rows']}", flush=True)
    print(json.dumps(summary), flush=True)
    return summary


def _in_thread(fn, errors):
    def run():
        try:
            fn()
        except BaseException as e:   # re-raised by the caller after join
            errors.append(e)
    th = threading.Thread(target=run)
    th.start()
    return th


def loop(runs: int, deterministic: bool) -> dict:
    from dsp_slam_rgbd_tpu_torch.mapping import local_mapping as lm
    from dsp_slam_rgbd_tpu_torch.parallel import distributed as dist
    from dsp_slam_rgbd_tpu_torch.tools import run_slam
    from dsp_slam_rgbd_tpu_torch.tools import sequence_dirs as sd
    from dsp_slam_rgbd_tpu_torch.tools.ellipsoid import FIXTURE

    if deterministic:
        dist.keep_replicas_identical()
    with tempfile.TemporaryDirectory() as tmp, repeating(Tally()) as tally:
        paths = sd.write_kitti_objects(os.path.join(tmp, "kitti"))
        for r in range(runs):
            lm._bucket_memo.clear()
            run_slam.main([paths["seq"], os.path.join(tmp, f"out{r}"), "--yaml", paths["yaml"],
                           "--labels", paths["labels"], "--deepsdf", FIXTURE,
                           "--max-frames", "8"])
            torch.cuda.synchronize()
    return _report(tally.summary("loop"))


def loop_fast(runs: int) -> dict:
    from dsp_slam_rgbd_tpu_torch.tools import bench, bench_pipeline

    dev = torch.device("cuda")
    errors = []

    def pipeline():
        bench_pipeline.run(frames=12, passes=1, device=dev)

    with repeating(Tally()) as tally:
        for _ in range(runs):
            pipeline()
            th = _in_thread(pipeline, errors)
            while th.is_alive():
                bench.main(["--pipeline-frames", "0", "--reps", "3"])
            th.join()
            if errors:
                raise errors[0]
    return _report(tally.summary("loop-fast"))


def _inputs(g, n_obj: int, rows: int, dev):
    """Codes (n_obj, 64) and points (n_obj, rows, 3) near the fixture's
    ellipsoid surfaces, where the Jacobian is not 0."""
    from dsp_slam_rgbd_tpu_torch.tools import ellipsoid

    code = g.standard_normal((n_obj, 64))
    dirs = g.standard_normal((n_obj, rows, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    xyz = dirs * ellipsoid.code_to_axes(code)[:, None] * g.uniform(0.8, 1.2, (n_obj, rows, 1))
    return (torch.tensor(code, dtype=F32, device=dev), torch.tensor(xyz, dtype=F32, device=dev))


def _schedule(dec, shapes, seed: int, dev, stop, deadline: float, enough):
    """Launches `shapes` in a seeded order on a stream of this thread's own
    through the decoder's kernel routes until `stop`, the deadline or
    `enough()`."""
    g = np.random.default_rng(seed)
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        pool = [(kind, dtype) + _inputs(g, n_obj, rows, dev)
                for kind, dtype, n_obj, rows in shapes]
        while not stop.is_set() and time.perf_counter() < deadline and not enough():
            kind, dtype, code, xyz = pool[g.integers(len(pool))]
            if kind == "value":
                dec.query(code, xyz, dtype)
            else:
                dec.query_with_jacobian(code, xyz, dtype)
        stream.synchronize()


def _orb(dev, stop):
    from dsp_slam_rgbd_tpu_torch.frontend import orb

    g = np.random.default_rng(1)
    img = torch.tensor(np.abs(g.standard_normal((376, 1241))) * 80 + 40, dtype=F32, device=dev)
    with torch.cuda.stream(torch.cuda.Stream()):
        while not stop.is_set():
            orb.extract(img, orb.OrbConfig(), device=dev)
            torch.cuda.current_stream().synchronize()


def _hammer(dev, stop):
    x = torch.rand(1 << 26, device=dev)
    with torch.cuda.stream(torch.cuda.Stream()):
        while not stop.is_set():
            for _ in range(8):
                x.mul_(0.999).add_(1e-3)
                x.view(-1, 1024).sum(1)
            torch.cuda.current_stream().synchronize()


def stress(min_calls: int, seconds: float, noise: tuple) -> dict:
    from dsp_slam_rgbd_tpu_torch.models import deepsdf
    from dsp_slam_rgbd_tpu_torch.tools.ellipsoid import FIXTURE

    dev = torch.device("cuda")
    dec = deepsdf.load_npz(FIXTURE, device=dev)
    torch.cuda.synchronize()   # its weight streams, packed on this stream, are read on others
    stop, errors, threads = threading.Event(), [], []
    deadline = time.perf_counter() + seconds
    with repeating(Tally()) as tally:
        def enough():
            return tally.summary("stress")["calls"] >= min_calls

        if "twin" in noise:
            twin = [s for s in SHAPES if s[1] == F32]
            threads.append(_in_thread(lambda: _schedule(dec, twin, 2, dev, stop, deadline,
                                                        enough), errors))
        for name, fn in (("orb", _orb), ("hammer", _hammer)):
            if name in noise:
                threads.append(_in_thread(lambda fn=fn: fn(dev, stop), errors))
        try:
            _schedule(dec, SHAPES, 1, dev, stop, deadline, enough)
        finally:
            stop.set()
            for th in threads:
                th.join()
        if errors:
            raise errors[0]
    out = tally.summary("stress")
    out["noise"], out["seconds"] = list(noise), seconds - max(deadline - time.perf_counter(), 0)
    return _report(out)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["loop", "loop-fast", "stress"])
    ap.add_argument("--runs", type=int, default=None, help="loop: 12, loop-fast: 1")
    ap.add_argument("--min-calls", type=int, default=600,
                    help="stress: stop after this many calls (all kernels)")
    ap.add_argument("--seconds", type=float, default=60.0, help="stress: stop after this long")
    ap.add_argument("--noise", default=",".join(NOISE),
                    help=f"stress: comma-separated, of {NOISE}, or 'none'")
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--csrc", help="build the kernels from this csrc/ directory")
    args = ap.parse_args(argv)
    noise = tuple(n for n in args.noise.split(",") if n and n != "none")
    if not set(noise) <= set(NOISE):
        ap.error(f"--noise takes {NOISE}")

    from dsp_slam_rgbd_tpu_torch import device as device_mod
    from dsp_slam_rgbd_tpu_torch.ops.cuda import build

    device_mod.resolve("cuda")
    if args.csrc:
        build.use_sources(args.csrc)
    build.load()
    if args.mode == "loop":
        return loop(12 if args.runs is None else args.runs, args.deterministic)
    if args.mode == "loop-fast":
        return loop_fast(1 if args.runs is None else args.runs)
    return stress(args.min_calls, args.seconds, noise)


if __name__ == "__main__":
    main()
