"""Reading the device's timeline from ``torch.profiler``: busy time, idle
share, the kernels that took most time and the longest idle gaps by what
the host was doing.

Busy time is the union of the device's kernel, memcpy and memset intervals,
so that work that overlaps counts once: a frozen copy of the arithmetic of
``mlff_tpu_torch/utils/timing.py`` (``union_us``,
``summarize_device_events``).  The events are read from the profiler's
raw Kineto records, which is cheaper than building its event tree.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

# device records that are not work: the synchronization records some
# profiler versions put on the device's timeline.  (A ``record_function``
# span is mirrored onto the device's timeline too, as one record as long
# as the span: the benchmark opens none around traced work.)
NOT_WORK = ("Sync",)
NOT_KERNEL = ("Memcpy", "Memset")


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit:
    time covered by at least one of them, overlaps counted once."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def merged(intervals) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


@dataclass
class Trace:
    """One profiled stretch: its length on the host's clock, and the
    (name, start_s, end_s) records of the device and of the host."""

    window_s: float
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)

    @property
    def busy_s(self) -> float:
        return union_seconds((s, e) for _, s, e in self.device)

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def kernels(self) -> list:
        """The device's kernel records (copies and sets left out)."""
        return [r for r in self.device
                if not r[0].startswith(NOT_KERNEL)]

    def seconds_of(self, names) -> tuple[float, int]:
        """(summed seconds, count) of the device records whose name holds
        any of ``names``."""
        hits = [e - s for n, s, e in self.device
                if any(k in n for k in names)]
        return float(sum(hits)), len(hits)

    def top_device_ops(self, top: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time,
        summed by name."""
        by_name: dict = {}
        for n, s, e in self.device:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:160], t] for n, t in ranked]

    def idle_gaps(self, top: int = 10, longest: int = 2000) -> list:
        """[[host activity, seconds]]: the ``longest`` gaps between the
        device's busy intervals, each named by the innermost host record
        that spans its middle and summed by that name; the ``top`` names by
        seconds."""
        busy = merged((s, e) for _, s, e in self.device)
        gaps = [(b[0] - a[1], 0.5 * (a[1] + b[0]))
                for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
        gaps = sorted(gaps, reverse=True)[:longest]
        if not gaps or not self.host:
            return []
        names = [n for n, _, _ in self.host]
        starts = np.array([s for _, s, _ in self.host])
        ends = np.array([e for _, _, e in self.host])
        spans = ends - starts
        by_name: dict = {}
        for length, mid in gaps:
            inside = np.flatnonzero((starts <= mid) & (ends >= mid))
            name = ("host outside any recorded op" if inside.size == 0
                    else names[inside[np.argmin(spans[inside])]])
            by_name[name] = by_name.get(name, 0.0) + length
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:160], t] for n, t in ranked]


def profile(torch, fn) -> Trace:
    """Run ``fn`` once under ``torch.profiler`` (host and device activity),
    its end synchronized with the device; return its ``Trace``.  Raises
    when the profiler recorded no device work: an idle share read from an
    empty trace would be wrong."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        rec = (e.name(), e.start_ns() * 1e-9, e.end_ns() * 1e-9)
        if e.device_type() == DeviceType.CUDA:
            if not any(w in rec[0] for w in NOT_WORK):
                device.append(rec)
        else:
            host.append(rec)
    if not device:
        raise RuntimeError("torch.profiler recorded no device activity")
    return Trace(window_s=window_s, device=device, host=host)
