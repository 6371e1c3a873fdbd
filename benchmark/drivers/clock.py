"""Completion marks on the device's own timeline: CUDA events on the card;
on the CPU (the harness's tests) the host clock, where work is done when
the call returns."""
from __future__ import annotations

import time

import torch


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def mark(dev):
    if dev.type == "cuda":
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e
    return time.perf_counter()


def elapsed_ms(a, b) -> float:
    return a.elapsed_time(b) if isinstance(a, torch.cuda.Event) else (b - a) * 1e3
