"""The descriptors layer of one training, s: the span
``train.descriptors`` (``build_kernel_inputs`` and the labels) of a
recorded training (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.train_seconds(ctx, "train.descriptors")
