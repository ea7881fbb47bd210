"""The device's time in the CG loop, ms per iteration: the union of the
profiler's device intervals inside the span ``cg`` of a profiled training
over its iterations (``benchmark/spans.py``).  None off the card."""

from benchmark import spans


def read(ctx):
    return spans.cg_device_ms_per_iter(ctx)
