"""The model's ``total_time_preconditioner``, mean over the window's
trainings."""

import numpy as np

from benchmark.readers import spans


def read(ctx):
    return float(np.mean(spans(ctx, "total_time_preconditioner")))
