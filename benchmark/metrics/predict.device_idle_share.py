"""The card's idle share of the traced calls, %: 1 - (the union of the
device intervals torch.profiler records) / (their seconds)."""

from benchmark.readers import idle_percent


def read(ctx):
    return idle_percent(ctx)
