"""The model's assembly after the solve, s: the span ``train.finalize``
(``create_model``, the integration constant through the Predictor) of a
recorded training (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.train_seconds(ctx, "train.finalize")
