"""The host's wait for each CG chunk's one read, ms per iteration: the
spans ``cg.read`` (the device finishing the chunk, and the copy back) of a
recorded training over its iterations (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.cg_ms_per_iter(ctx, "cg.read")
