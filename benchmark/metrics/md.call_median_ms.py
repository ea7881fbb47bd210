"""The median latency of the window's calls, ms: a steadier statistic
beside the tail."""

import numpy as np

from benchmark.readers import latencies_s


def read(ctx):
    return 1e3 * float(np.median(latencies_s(ctx)))
