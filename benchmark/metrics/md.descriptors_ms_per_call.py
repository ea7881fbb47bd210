"""The query descriptors of each call, ms: the spans
``predict.descriptors`` per recorded call (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.ms_per_call(ctx, "predict.descriptors")
