"""The card's idle share, in %: 1 - (busy seconds a unit of work in the
trace) / (the untraced window's seconds a unit)."""
from __future__ import annotations

from benchmark.yardstick import trace


def read(ctx):
    return trace.idle_share(ctx)
