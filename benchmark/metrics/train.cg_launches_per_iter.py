"""Kernel launches per CG iteration: the profiler's kernel records inside
the span ``cg`` of a profiled training, per iteration queued
(``benchmark/spans.py``).  None off the card."""

from benchmark import spans


def read(ctx):
    return spans.cg_launches_per_iter(ctx)
