"""The leverage scores and the column draw of one training, s: the span
``precon.leverage`` of a recorded training (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.train_seconds(ctx, "precon.leverage")
