"""Each call's wait for the device and copy back, ms: the spans
``predict.d2h`` per recorded call (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.ms_per_call(ctx, "predict.d2h")
