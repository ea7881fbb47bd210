"""The share of the card's idle time in the profiled calls that no span of
the program names, %: gaps whose midpoint lies in no span below a
request root (``benchmark/spans.py``).  None off the card."""

from benchmark import spans


def read(ctx):
    return spans.idle_unattributed_percent(ctx)
