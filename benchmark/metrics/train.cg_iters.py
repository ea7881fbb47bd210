"""The model's ``solver_iters``, mean over the window's trainings."""

import numpy as np

from benchmark.readers import spans


def read(ctx):
    return float(np.mean(spans(ctx, "solver_iters")))
