"""Per-stage timers and profiler traces.

Counterpart of `dsp_slam_rgbd_tpu/utils/timers.py`: one registry of named
stage timers with a summary, `device_sync` (a barrier on the card:
`torch.cuda.synchronize`; nothing to wait for on the CPU) and
`profiler_trace` (a `torch.profiler` trace of a region, written as a
Chrome trace).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import numpy as np
import torch


def device_sync(device="cuda") -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class StageTimers:
    def __init__(self, sync: bool = False, device="cuda"):
        self.samples = defaultdict(list)
        self.sync = sync
        self.device = device

    @contextlib.contextmanager
    def stage(self, name: str):
        if self.sync:
            device_sync(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                device_sync(self.device)
            self.samples[name].append(time.perf_counter() - t0)

    def summary(self) -> dict:
        out = {}
        for name, xs in self.samples.items():
            a = np.asarray(xs)
            out[name] = {
                "n": len(a),
                "mean_ms": float(a.mean() * 1e3),
                "median_ms": float(np.median(a) * 1e3),
                "p90_ms": float(np.percentile(a, 90) * 1e3),
                "total_s": float(a.sum()),
            }
        return out

    def report(self) -> str:
        lines = [f"{'stage':<28}{'n':>6}{'median':>10}{'mean':>10}{'p90':>10}"]
        for name, s in sorted(self.summary().items()):
            lines.append(f"{name:<28}{s['n']:>6}{s['median_ms']:>9.2f}ms"
                         f"{s['mean_ms']:>9.2f}ms{s['p90_ms']:>9.2f}ms")
        return "\n".join(lines)


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """`torch.profiler` trace of a region (host, and the card's kernels when
    there is one), written to `log_dir/trace.json` (Chrome trace format)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
