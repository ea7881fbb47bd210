"""The host's time queueing the CG chunks, ms per iteration: the spans
``cg.chunk`` of a recorded training over its iterations
(``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.cg_ms_per_iter(ctx, "cg.chunk")
