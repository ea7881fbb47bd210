"""The host's time queueing each call's work, ms: per recorded call, the
summed self time of its spans but ``predict.d2h`` (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.host_ms_per_call(ctx)
