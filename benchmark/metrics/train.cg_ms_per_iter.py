"""Milliseconds per PCG iteration: the sum of the model's
``total_time_cg`` over the sum of its ``solver_iters``, over the window's
trainings."""

from benchmark.readers import spans


def read(ctx):
    return 1e3 * sum(spans(ctx, "total_time_cg")) / sum(
        spans(ctx, "solver_iters"))
