"""Split the fixed-order scatter-add's time on the card into device time and
host time, for the kernel, its plan and `index_add_`.

For each case it prints, beside the card's name and power limit:
  * `device_us`: the device time a call, from `torch.profiler`'s kernel
    (and memset) events over 20 back-to-back calls (5 for a multi-ms case);
  * `host_us`: the host time a call, from the host clock over 200
    back-to-back calls (10 for a multi-ms case) with no synchronise inside
    the loop;
  * `events_ms`: the mean of CUDA events around 20 back-to-back calls (what
    earlier records call the kernel's time: the larger of the two rates);
  * whether the card's result equals `index_add_` on the CPU bit for bit.

The cases are rebuilt from seeds, so two checkouts see the same inputs:
9b's corridor map (`corridor_map.build_corridor_map`, KITTI-00 scale) with
its local BA at keyframe 500 (`Hcp`) and its global PCG (`Hcc`, the matvec's
`u`); scatters of 12a's map normals' shape (16,385 targets x 3, 262,144
rows, 54 kept) and of phase 16's pose graph (128 x 128 7x7 blocks, 163
edges); and the two heavy-duplicate cases (2^20 rows onto 1 and 8
targets).  Where the checkout has `scatter.scatter_adds`, the batched call
sites too, at their sizes: the PCG matvec's three scatters onto `y_edge`,
the PCG assembly's eight and the pose graph's six.

    python dsp_slam_rgbd_tpu_torch/tools/scatter_split.py [--checkout DIR] [--json OUT]

`--checkout DIR` imports the port from another checkout (its own kernels,
built from its own `csrc/`), so a parent and a change can be timed in
turns in one call.  Needs the card; without it, exits with 1.  Phase 17
of `chip_smoke.py` runs the same rows (`case_row`, `batched_row`) on the
scatters the main path captured.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# heavy-duplicate cases: (name, targets, rows, trailing shape)
HEAVY = (("heavy: every row onto one target", 1, 1 << 20, ()),
         ("heavy: 8 targets", 8, 1 << 20, (3,)))


def _profiled_us(fn, calls):
    """fn's device µs a call and kernels a call from the profiler's device
    events over `calls` calls, or None where it recorded none, or a number
    of events that is not the same for every call (the tracer dropped some)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as p:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in p.events() if e.device_type == DeviceType.CUDA]
    if not dev or len(dev) % calls:
        return None
    return sum(e.time_range.elapsed_us() for e in dev) / calls, len(dev) // calls


def _graph_us(fn, calls):
    """fn's device µs a call from CUDA events around a CUDA graph of
    `calls` calls (no host launch cost inside)."""
    import torch

    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / calls


def split(fn, calls=20, host_calls=200):
    """{"device_us", "kernels", "device_from", "host_us", "events_ms"} of fn
    a call.  Device time from the profiler (after a throwaway trace, three
    tries), else from events around a CUDA graph of 20 calls, else NaN."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    _profiled_us(fn, 1)   # a new trace may drop its first kernels
    got = None
    for _ in range(3):
        got = _profiled_us(fn, calls)
        if got is not None:
            break
    if got is not None:
        device_us, kernels, source = got[0], got[1], "profiler"
    else:
        try:
            device_us, kernels, source = _graph_us(fn, 20), None, "cuda graph"
        except RuntimeError:   # not capturable: the device time stays unmeasured
            device_us, kernels, source = float("nan"), None, "not measured"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(host_calls):
        fn()
    host_us = (time.perf_counter() - t0) / host_calls * 1e6
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        fn()
    end.record()
    torch.cuda.synchronize()
    return {"device_us": device_us, "kernels": kernels, "device_from": source,
            "host_us": host_us, "events_ms": start.elapsed_time(end) / 20}


def bits_equal(a, b) -> bool:
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    ints = {4: torch.int32, 8: torch.int64}[a.element_size()]
    return bool(torch.equal(a.contiguous().view(ints).cpu(), b.contiguous().view(ints).cpu()))


def scatter_bytes(out, adds, zero=False) -> int:
    """Bytes the scatters `adds` ((plan, src) pairs, in order) onto `out`
    must move: each target that has a kept row read and written once, or,
    where out starts from +0.0 (`zero`), every target written once; each
    kept source element, perm entry and offset read once."""
    es = out.element_size()
    row = out.numel() // max(out.shape[0], 1) * es
    if zero:
        total = out.shape[0] * row
    else:
        counts = sum(p.offsets[1:] - p.offsets[:-1] for p, _ in adds)
        total = 2 * int((counts > 0).sum()) * row
    for p, src in adds:
        kept = int(p.offsets[-1])
        total += kept * (src.numel() // max(src.shape[0], 1)) * es + 8 * (kept + p.offsets.numel())
    return total


def _src(g, rows, trailing, dev):
    import torch

    shape = (rows,) + tuple(trailing)
    return torch.tensor(g.standard_normal(shape) * 10.0 ** g.uniform(-3, 3, shape),
                        dtype=torch.float32, device=dev)


def heavy_cases(g, dev):
    """name -> (out, plan, src) of the `HEAVY` cases, from the generator g."""
    import torch

    from dsp_slam_rgbd_tpu_torch.ops import scatter

    return {name: (_src(g, n, tr, dev),
                   scatter.plan(torch.tensor(g.integers(0, n, rows), device=dev), n),
                   _src(g, rows, tr, dev))
            for name, n, rows, tr in HEAVY}


def case_row(site, out, p, src) -> dict:
    """One scatter onto `out` (not changed) by the plan p: the kernel's route
    (`scatter.index_add`) bit for bit against `index_add_` on the CPU, and
    the split of the kernel, of building its plan and of `index_add_` over
    the kept rows on the card; with the bytes it must move."""
    from dsp_slam_rgbd_tpu_torch.ops import scatter

    got = scatter.index_add(out.clone(), p, src)
    want = scatter.index_add(out.cpu().clone(), p.to("cpu"), src.cpu())
    counts = p.offsets[1:] - p.offsets[:-1]
    longest = int(counts.max()) if counts.numel() else 0
    kept = int(p.offsets[-1])
    rows = p.perm[:kept].sort().values   # the kept rows, in source order
    idx_k, src_k = p.idx[rows], src[rows]
    o = out.clone()
    calls = dict(calls=5, host_calls=10) if longest > 10_000 else {}   # a multi-ms kernel
    return {"site": site, "targets": out.shape[0], "trailing": list(out.shape[1:]),
            "dtype": str(out.dtype).split(".")[-1], "rows": src.shape[0], "rows_kept": kept,
            "longest_segment": longest, "bit_equal": bits_equal(got, want),
            "kernel": split(lambda: scatter.index_add(o, p, src), **calls),
            "plan": split(lambda: scatter.plan(p.idx, p.n, p.keep), **calls),
            "index_add_": split(lambda: o.index_add_(0, idx_k, src_k), **calls),
            "bytes": scatter_bytes(out, [(p, src)])}


def describe(row) -> str:
    k, pl, lib = row["kernel"], row["plan"], row["index_add_"]
    return (f"{row['site']}: {row['targets']} targets x {row['trailing']}, {row['rows_kept']} of "
            f"{row['rows']} rows kept, longest segment {row['longest_segment']}; bit for bit "
            f"index_add_ on the CPU: {row['bit_equal']}; kernel device {k['device_us']:.2f} us, "
            f"host {k['host_us']:.2f} us a call (events {k['events_ms'] * 1e3:.2f} us); plan "
            f"device {pl['device_us']:.2f} us ({pl['kernels']} kernels), host "
            f"{pl['host_us']:.2f} us; index_add_ device {lib['device_us']:.2f} us, host "
            f"{lib['host_us']:.2f} us")


def one_by_one(args):
    """`scatter_adds`' outputs by one launch a scatter, as before it."""
    from dsp_slam_rgbd_tpu_torch.ops import scatter

    outs = []
    for n, (p0, s0), *rest in args:
        outs.append(scatter.scatter_add(n, p0, s0))
        for p, s in rest:
            scatter.index_add(outs[-1], p, s)
    return outs


def batched_row(site, args) -> dict:
    """One `scatter_adds` call (`args`: its outputs, each (n, (plan, src),
    ...)), in its one launch and one launch a scatter, each bit for bit
    against the CPU's `index_add_` calls in sequence; the split of both and
    the bytes the call must move."""
    from dsp_slam_rgbd_tpu_torch.ops import scatter

    got = scatter.scatter_adds(*args)
    want = scatter.scatter_adds(*[(n, *((p.to("cpu"), s.cpu()) for p, s in adds))
                                  for n, *adds in args])
    return {"site": site, "outputs": len(args), "scatters": sum(len(a) - 1 for a in args),
            "bit_equal": all(bits_equal(a, b) for a, b in zip(got, want))
            and all(bits_equal(a, b) for a, b in zip(one_by_one(args), want)),
            "batched": split(lambda: scatter.scatter_adds(*args)),
            "one_by_one": split(lambda: one_by_one(args)),
            "bytes": sum(scatter_bytes(o, adds, zero=True) for o, (_, *adds) in zip(got, args))}


def describe_batched(row) -> str:
    b1, b2 = row["batched"], row["one_by_one"]
    return (f"{row['site']}: {row['scatters']} scatters onto {row['outputs']} outputs in one "
            f"launch; bit for bit the CPU's index_add_ calls in sequence: {row['bit_equal']}; "
            f"one launch device {b1['device_us']:.2f} us, host {b1['host_us']:.2f} us; one "
            f"launch a scatter device {b2['device_us']:.2f} us ({b2['kernels']} kernels), host "
            f"{b2['host_us']:.2f} us")


def cases(dev, corridor=True):
    """name -> (out, plan, src), all on `dev`, rebuilt from seeds."""
    import torch

    from dsp_slam_rgbd_tpu_torch.ops import scatter

    g = np.random.default_rng(17)
    found = {}
    if corridor:
        from dsp_slam_rgbd_tpu_torch.mapping import local_mapping as lm
        from dsp_slam_rgbd_tpu_torch.tools import corridor_map as cm
        from dsp_slam_rgbd_tpu_torch.weights import map_state_from_numpy

        state = map_state_from_numpy(cm.build_corridor_map()[0], dev)
        loc, _ = lm.build_local_ba_problem(state, 500, max_kfs=10)
        B, P = loc.kf_pose.shape[0] + loc.obj_pose.shape[0], loc.pts.shape[0]
        found["9b local Hcp"] = (loc.obs_kf.long() * P + loc.obs_pt.long(), B * P,
                                 loc.obs_mask, (6, 3))
        glob, _ = lm.build_local_ba_problem(state, 0, 0, global_window=True)
        B, P = glob.kf_pose.shape[0] + glob.obj_pose.shape[0], glob.pts.shape[0]
        found["9b PCG Hcc"] = (glob.obs_kf.long(), B, glob.obs_mask, (6, 6))
        found["9b PCG matvec u"] = (glob.obs_pt.long(), P, glob.obs_mask, (3,))
    P, rows = 16384, 128 * 2048
    keep = torch.zeros(rows, dtype=torch.bool)
    keep[torch.from_numpy(g.choice(rows, 54, replace=False))] = True
    found["12a normals' shape"] = (torch.tensor(g.integers(0, P + 1, rows), device=dev), P + 1,
                                   keep.to(dev), (3,))
    K, E = 128, 163
    ei = g.integers(0, 31, E)
    ej = (ei + g.integers(1, 31, E)) % 31
    found["16 pose graph H's shape"] = (torch.tensor(ei * K + ej, device=dev), K * K, None,
                                        (7, 7))
    g = np.random.default_rng(18)
    out = {name: (_src(g, n, tr, dev), scatter.plan(idx, n, keep), _src(g, idx.shape[0], tr, dev))
           for name, (idx, n, keep, tr) in found.items()}
    out.update(heavy_cases(g, dev))
    return out


def batched_sites(dev, g, corridor_sizes=(1028, 32768, 196709)):
    """name -> the `scatter_adds` arguments of a batched call site, at the
    sizes of 9b's PCG (B blocks, P points, edges) and phase 16's pose graph."""
    from dsp_slam_rgbd_tpu_torch.ops import scatter

    import torch

    B, P, N = corridor_sizes
    M = 64   # object edges
    kf = scatter.plan(torch.tensor(g.integers(0, B - 8, N), device=dev), B)
    pt = scatter.plan(torch.tensor(g.integers(0, P, N), device=dev), P)
    okf = scatter.plan(torch.tensor(g.integers(0, B - 8, M), device=dev), B)
    oobj = scatter.plan(torch.tensor(g.integers(B - 8, B, M), device=dev), B)
    K, E = 128, 163
    ei = g.integers(0, 31, E)
    ej = (ei + g.integers(1, 31, E)) % 31
    t = lambda a: torch.tensor(a, device=dev)   # noqa: E731
    ii, ij, ji, jj = (scatter.plan(t(a * K + c), K * K)
                      for a, c in ((ei, ei), (ei, ej), (ej, ei), (ej, ej)))
    pi, pj = scatter.plan(t(ei), K), scatter.plan(t(ej), K)
    s = lambda rows, *tr: _src(g, rows, tr, dev)   # noqa: E731
    return {
        "9b PCG matvec y_edge (3 scatters)": ((B, (kf, s(N, 6)), (okf, s(M, 6)),
                                               (oobj, s(M, 6))),),
        "9b PCG assembly (8 scatters)": ((B, (kf, s(N, 6, 6)), (okf, s(M, 6, 6)),
                                          (oobj, s(M, 6, 6))),
                                         (B, (kf, s(N, 6)), (okf, s(M, 6)), (oobj, s(M, 6))),
                                         (P, (pt, s(N, 3, 3))), (P, (pt, s(N, 3)))),
        "16 pose graph H, b (6 scatters)": ((K * K, (ii, s(E, 7, 7)), (jj, s(E, 7, 7)),
                                             (ij, s(E, 7, 7)), (ji, s(E, 7, 7))),
                                            (K, (pi, s(E, 7)), (pj, s(E, 7)))),
    }


def measure(dev, corridor=True):
    """The split of every case, and of every batched site where the
    checkout has `scatter.scatter_adds`."""
    from dsp_slam_rgbd_tpu_torch.ops import scatter

    rows = []
    for name, (out, p, src) in cases(dev, corridor).items():
        rows.append(case_row(name, out, p, src))
        print("scatter_split " + describe(rows[-1]), flush=True)
    if hasattr(scatter, "scatter_adds"):
        for name, args in batched_sites(dev, np.random.default_rng(19)).items():
            rows.append(batched_row(name, args))
            print("scatter_split batched " + describe_batched(rows[-1]), flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkout", help="import the port from this checkout")
    ap.add_argument("--json", help="write the rows here")
    ap.add_argument("--no-corridor", action="store_true", help="skip 9b's corridor cases")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.checkout or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "..")))
    import torch

    if not torch.cuda.is_available():
        print("scatter_split: CUDA is not available", file=sys.stderr)
        return 1
    import dsp_slam_rgbd_tpu_torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"scatter_split: {os.path.dirname(dsp_slam_rgbd_tpu_torch.__file__)} on {smi}",
          flush=True)
    rows = measure(torch.device("cuda"), corridor=not args.no_corridor)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": smi, "package": dsp_slam_rgbd_tpu_torch.__file__, "rows": rows},
                      f, indent=1)
    return 0 if all(r["bit_equal"] for r in rows) else 2


if __name__ == "__main__":
    sys.exit(main())
