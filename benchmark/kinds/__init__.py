"""The general drivers of the traffic mixes, one per ``kind`` a mix file
names: ``train`` (whole trainings back to back) and ``predict`` (calls of
a fixed number of geometries, taken in order from a held-out pool)."""

import math


def worst(a: float, b: float) -> float:
    """The worse of two compared numbers, a NaN counting as infinitely
    bad (``max`` would drop it)."""
    if math.isnan(a) or math.isnan(b):
        return math.inf
    return max(a, b)
