"""The model's ``cache_build_s`` (the kernel cache, synchronized), mean
over the window's trainings."""

import numpy as np

from benchmark.readers import spans


def read(ctx):
    return float(np.mean(spans(ctx, "cache_build_s")))
