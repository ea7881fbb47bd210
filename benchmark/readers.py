"""What several metric readers share: the spans of the window's trainings,
the latencies of its calls, the device's idle share of the profiled
stretch, and the device time of one call."""

from __future__ import annotations

import numpy as np


def spans(ctx, name: str) -> list:
    """The program's span or counter ``name`` of every training of the
    window."""
    return [r["spans"][name] for r in ctx.records if "spans" in r]


def latencies_s(ctx) -> np.ndarray:
    """Each call's seconds on the host's clock, from the call to the NumPy
    results in hand."""
    return np.array([r["t1"] - r["t0"] for r in ctx.records])


def idle_percent(ctx):
    """100 (1 - busy / window) of the profiled stretch; None untraced."""
    if ctx.trace is None:
        return None
    return 100.0 * ctx.trace.idle_share


def device_ms(torch, fn, reps: int = 20) -> float:
    """The device's milliseconds per call of ``fn``: ``reps`` calls after
    one warm call, run under ``torch.profiler``, and the union of the
    device intervals it records over ``reps``.  The host's pace between
    launches does not enter it."""
    from benchmark import devtrace

    fn()

    def calls():
        for _ in range(reps):
            fn()

    return 1e3 * devtrace.profile(torch, calls).busy_s / reps
