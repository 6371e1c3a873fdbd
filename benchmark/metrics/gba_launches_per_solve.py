"""Kernel launches of the driving thread a global BA call (host-side
launch events in the trace, `yardstick/trace.py`)."""
from __future__ import annotations


def read(ctx):
    n = ctx["trace"]["launches"]
    return n / ctx["units"] if n else None
