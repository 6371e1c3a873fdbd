"""What the program's own spans say: the spans that the port's registry
(`dsp_slam_rgbd_tpu_torch/utils/timers.py`, passed in by the readers)
recorded while the traced run's profiler was on.  A port without that
registry recorded nothing, and its readers report nothing."""
from __future__ import annotations


def of(timers, name: str) -> list:
    """The finished spans named `name` in `timers`' registry; [] where it
    has none."""
    read = getattr(timers, "spans", None)
    return [] if read is None else [s for s in read() if s.name == name]


def mean(xs: list, field: str) -> float | None:
    """The mean of `field` (`host_ms` or `device_ms`) over the spans `xs`;
    None where there is none, or where a span lacks the field (no CUDA
    events on the CPU)."""
    vals = [getattr(s, field) for s in xs]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals) / len(vals)


def per_root(xs: list, roots: list, field: str) -> float | None:
    """The sum of `field` over the spans `xs` inside the spans `roots`, per
    root span; None as for `mean`."""
    ids = {r.id for r in roots}
    vals = [getattr(s, field) for s in xs if s.root in ids]
    if not ids or not vals or any(v is None for v in vals):
        return None
    return sum(vals) / len(ids)
