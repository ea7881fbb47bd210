"""The card's idle share of one whole training, %: 1 - (the union of the
device intervals torch.profiler records) / (the training's seconds)."""

from benchmark.readers import idle_percent


def read(ctx):
    return idle_percent(ctx)
