"""The port's span registry, stage timers and profiler traces.

Counterpart of `dsp_slam_rgbd_tpu/utils/timers.py`, grown into the one
place where the port records what its layers did.

`span(name, **attrs)` marks a unit of work at a layer boundary (a fit
batch, one GN iteration, a global BA call, its CG solve).  A span records
its name, its own id, its parent's id, the id of the outermost span open
on its thread (its root: spans of one fit batch or one BA call share it),
its host start and end on one monotonic ns clock (`time.perf_counter_ns`),
and its attributes.  `sp.set(**attrs)` adds attributes while it is open;
`sp.count(key, counter)` stores under `key` what a counter dict (such as
`ops/cuda/mlp_sdf.py::ROWS`) gained while the span was open.

When it records:
  * only while on: while a `torch.profiler` session records in this
    process (`torch.autograd.profiler._is_profiler_enabled`: the
    benchmark's traced runs, `profiler_trace`), or inside `recording()`
    (tests, and measuring what the spans cost);
  * off, `span` tests that flag and returns one shared no-op object: no
    allocation of its own, no host sync, no device op;
  * on, a span enters `torch.profiler.record_function(name)`, so every
    exported chrome trace holds it as a `user_annotation` on the host and,
    with CUDA activity, a `gpu_user_annotation` on the card's own clock.
    Once CUDA is initialized it also records a timing CUDA event on the
    current stream at entry and at exit (events from a pool; a runtime
    call, not a kernel launch).  Their difference is the span's time on
    the card: from when the card reached the span to when it finished
    the span's work.  Tensor attributes are kept as references.
  * cost: off, under 1 µs a span; on, 35-80 µs of host time on an H100's
    host (record_function and the two event records; the most when it
    creates its events), and no device work.

`spans()` resolves what was recorded after one synchronize: `host_ms`,
`device_ms` (None without events) and the attributes, each tensor summed
to a number.  It does not clear the registry; `clear()` does.  Spans of
every thread go to the one registry; a counter's gain (`count`) is the
process's, whatever thread launched.

`StageTimers` names host stages and summarizes them (the JAX package's
keys) over this registry.  `device_sync` is a barrier on the card
(nothing to wait for on the CPU) and `profiler_trace` a `torch.profiler`
trace of a region, written as a Chrome trace.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import profiler as _profiler

_registry: list = []          # every span recorded, in order of entry
_pool: list = []              # free timing CUDA events
_ids = itertools.count(1)
_local = threading.local()    # .stack: the spans open on this thread
_forced = 0                   # depth of open `recording()` contexts
_lock = threading.Lock()


def device_sync(device="cuda") -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _event():
    try:
        return _pool.pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


class _Off:
    """The span while nothing records: every method does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def set(self, **attrs):
        pass

    def count(self, key, counter):
        pass


OFF = _Off()


class Span:
    """One recorded span.  After `spans()`: `host_ms`, `device_ms` (None
    without CUDA events) and `attrs` with every tensor summed to a
    number."""
    __slots__ = ("name", "id", "parent", "root", "start_ns", "end_ns", "attrs", "device_ms",
                 "_rf", "_events", "_counters")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs
        self.id = next(_ids)
        self.start_ns = self.end_ns = self.device_ms = None
        self._events = self._counters = None

    @property
    def host_ms(self) -> float | None:
        return None if self.end_ns is None else (self.end_ns - self.start_ns) / 1e6

    def set(self, **attrs):
        self.attrs.update(attrs)

    def count(self, key, counter: dict):
        if self._counters is None:
            self._counters = []
        self._counters.append((key, counter, dict(counter)))

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        stack.append(self)
        _registry.append(self)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if torch.cuda.is_initialized():
            self._events = (_event(), _event())
            self._events[0].record()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[1].record()
        for key, counter, before in self._counters or ():
            self.attrs[key] = {k: v - before.get(k, 0) for k, v in counter.items()
                               if v != before.get(k, 0)}
        self._counters = None
        self._rf.__exit__(*exc)
        self._rf = None
        _local.stack.pop()
        return None

    def _resolve(self):
        if self._events is not None:
            self.device_ms = self._events[0].elapsed_time(self._events[1])
            _pool.extend(self._events)
            self._events = None
        for k, v in self.attrs.items():
            if isinstance(v, torch.Tensor):
                self.attrs[k] = v.sum().item()


def span(name: str, **attrs):
    """A context manager that records a span while on (see the module
    docstring); off, the shared no-op `OFF`."""
    if not (_profiler._is_profiler_enabled or _forced):
        return OFF
    return Span(name, attrs)


@contextlib.contextmanager
def recording():
    """Record spans inside this block, profiler or not."""
    global _forced
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


def spans() -> list[Span]:
    """The finished spans recorded so far, in order of entry, resolved
    after one synchronize where any holds CUDA events."""
    done = [s for s in list(_registry) if s.end_ns is not None]
    if any(s._events is not None for s in done):
        torch.cuda.synchronize()
    for s in done:
        s._resolve()
    return done


def clear() -> None:
    """Empty the registry."""
    for s in _registry:
        if s._events is not None:
            _pool.extend(s._events)
            s._events = None
    _registry.clear()


class StageTimers:
    """Named host stages, each a span of the registry recorded whatever
    the profiler's state; `summary` reads this object's spans back.  With
    `sync`, each stage starts and ends with a barrier on `device`."""

    def __init__(self, sync: bool = False, device="cuda"):
        self.sync = sync
        self.device = device
        self._ids = set()

    @contextlib.contextmanager
    def stage(self, name: str):
        if self.sync:
            device_sync(self.device)
        with recording(), span(name) as s:
            self._ids.add(s.id)
            try:
                yield
            finally:
                if self.sync:
                    device_sync(self.device)

    def summary(self) -> dict:
        samples = defaultdict(list)
        for s in spans():
            if s.id in self._ids:
                samples[s.name].append(s.host_ms / 1e3)
        out = {}
        for name, xs in samples.items():
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
    there is one), written to `log_dir/trace.json` (Chrome trace format).
    The port's spans inside it are recorded."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
