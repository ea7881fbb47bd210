"""The 95th percentile of every call's latency in the window, ms."""

import numpy as np

from benchmark.readers import latencies_s


def read(ctx):
    return 1e3 * float(np.percentile(latencies_s(ctx), 95))
