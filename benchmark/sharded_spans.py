"""The row-sharded training's many spans, read from the recordings of
``benchmark/spans.py``: the collectives (``mesh.collective``, one per
count of ``mesh.collectives``), the on-the-fly matvec's tile loop
(``matvec.otf``) and the preconditioner apply (``precon.apply``).  They
open and close on the thread that records, one after another, so a sorted
search places a launch in them (``spans.py``'s own placement tests every
span for every record, too slow for the ~10^4 spans of a sharded
training).
"""

from __future__ import annotations

import numpy as np

from benchmark import devtrace


def inside_cg(rec, name: str) -> list:
    """The spans ``name`` that open inside a ``cg`` span."""
    loops = [(s.start, s.end) for s in rec.named("cg")]
    return [s for s in rec.named(name)
            if any(a <= s.start < b for a, b in loops)]


def _inside(rec, spans: list, t: np.ndarray) -> np.ndarray:
    """Whether each Unix-epoch time of ``t`` (NaN for none) lies in one of
    ``spans``."""
    merged = devtrace.merged((rec.epoch(s.start), rec.epoch(s.end))
                             for s in spans)
    if not merged:
        return np.zeros(len(t), dtype=bool)
    starts = np.array([a for a, _ in merged])
    ends = np.array([b for _, b in merged])
    i = np.searchsorted(starts, t, side="right") - 1
    return (i >= 0) & (t < ends[np.maximum(i, 0)])


def launched_in(got, spans: list, outside: list = ()) -> list:
    """The device records of ``spans.profiled``'s ``got`` launched inside
    one of ``spans`` and in none of ``outside``."""
    rec, tr, launched = got
    t = np.array([np.nan if x is None else x for x in launched], dtype=float)
    keep = _inside(rec, spans, t) & ~_inside(rec, list(outside), t)
    return [r for r, k in zip(tr.device, keep) if k]


def device_seconds(records: list) -> float:
    """The union of the records' device intervals, s."""
    return devtrace.union_seconds((s, e) for _, s, e in records)
