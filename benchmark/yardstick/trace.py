"""What a profiler trace of the card says: launches, device time by
kernel name, busy time, and the idle gaps by what the host was doing.

Rules (copied from the port's `chip_smoke.py::stream_launches` and
`profile_fit`, which later changes to the program do not reach):
  * a launch is a kernel-launch call of the CUDA runtime or driver made by
    the driving host thread, counted from its host-side event (the tracer
    drops some kernels of long traces, never the calls); one correlation
    id is one launch;
  * device time is that of the operations the trace kept (kernels, copies,
    fills), by name; busy time is the length of their union;
  * a new trace drops its first kernels, so a throwaway trace comes first;
  * an idle gap of the device is named by the host operation (innermost
    `cpu_op`) that issued the device operation ending it.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import threading
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NAME_CHARS = 100


def _thread_ids() -> set:
    # the tracer names a host thread by its pthread id's low 32 bits, as a
    # signed int whose sign it may drop
    low = threading.get_ident() & 0xFFFFFFFF
    signed = low - (1 << 32) if low >= 1 << 31 else low
    return {low, signed, abs(signed), threading.get_native_id()}


def _is_launch(e) -> bool:
    return e.get("cat") in LAUNCH_CATS and "LaunchKernel" in e.get("name", "")


def profile(fn) -> dict:
    """Runs fn() once under the profiler (host and card), ending with a
    synchronize, and returns `summarize`'s dict."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile

    with _profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        p.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return summarize(events, wall, _thread_ids())


def _union(intervals):
    """Merged (start, end) intervals of sorted (start, end, ...) tuples."""
    out = []
    for s, e, *_ in intervals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events: list, wall_s: float, tids: set) -> dict:
    """-> {launches, launches_by_api, kernels {name: s}, n_device_ops,
    busy_s, window_s, device_ops [[name, s]] (top 10), idle_gaps [[host
    op, s]] (top 10, summed by name)}."""
    launch_ev = [e for e in events if _is_launch(e) and e.get("tid") in tids]
    by_api = {}
    for e in launch_ev:
        by_api[e["name"]] = by_api.get(e["name"], 0) + 1
    corr = {e["args"].get("correlation") for e in launch_ev}
    dev = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e)
                  for e in events if e.get("cat") in DEVICE_CATS), key=lambda x: x[:2])
    by_name = {}
    for _, _, e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e.get("dur", 0.0)) / 1e6
    merged = _union(dev)
    busy = sum(e - s for s, e in merged) / 1e6

    # the host op behind each gap: the runtime or driver call (any thread)
    # that issued the first device op after it, inside its innermost cpu_op
    launch_ts = {e["args"].get("correlation"): (float(e["ts"]), e.get("tid"))
                 for e in events if e.get("cat") in LAUNCH_CATS}
    ops = {}
    for e in events:
        if e.get("cat") == "cpu_op":
            ops.setdefault(e.get("tid"), []).append((float(e["ts"]), float(e["ts"])
                                                     + float(e.get("dur", 0.0)), e["name"]))
    for v in ops.values():
        v.sort()
    starts = {t: [s for s, _, _ in v] for t, v in ops.items()}

    def host_op(ts, tid):
        v = ops.get(tid, [])
        i = bisect.bisect_right(starts.get(tid, []), ts) - 1
        while i >= 0:
            if v[i][1] >= ts:
                return v[i][2]
            i -= 1
        return "(no host op)"

    first_after = {}
    j = 0
    for k in range(1, len(merged)):
        while j < len(dev) and dev[j][0] < merged[k][0]:
            j += 1
        first_after[k] = dev[j][2] if j < len(dev) else None
    gaps = {}
    for k in range(1, len(merged)):
        g = (merged[k][0] - merged[k - 1][1]) / 1e6
        e = first_after[k]
        where = launch_ts.get(e["args"].get("correlation")) if e is not None else None
        name = host_op(*where) if where else "(no host call)"
        gaps[name] = gaps.get(name, 0.0) + g
    def top(d):
        return [[k[:NAME_CHARS], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"launches": len(corr), "launches_by_api": by_api, "kernels": by_name,
            "n_device_ops": len(dev), "busy_s": busy, "window_s": wall_s,
            "device_ops": top(by_name), "idle_gaps": top(gaps)}


def kernel_seconds(summary: dict, *parts: str) -> float:
    """Device seconds of the kernels whose names contain any of `parts`."""
    return sum(v for k, v in summary["kernels"].items() if any(p in k for p in parts))


def idle_share(ctx: dict) -> float | None:
    """100 (1 - traced busy seconds a unit / untraced seconds a unit)."""
    busy = ctx["trace"]["busy_s"] / ctx["units"]
    return 100.0 * (1.0 - busy / ctx["unit_s"]) if busy > 0.0 else None
