"""Device timing by CUDA events, for comparisons of a few percent, a
call's time on the host's clock, and the card's busy and idle share read
from ``torch.profiler`` (``device_profile``)."""

from __future__ import annotations

import statistics
import time


def host_ms_per_call(torch, fn, calls: int = 200) -> float:
    """Milliseconds per call of ``fn`` on the host's clock with the card kept
    busy: ``calls`` calls back to back and one synchronise at the end.  It
    is the larger of the host's and the card's time per call."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def time_in_turns(torch, fns: dict, rounds: int = 7, reps: int = 10,
                  lead_ms: float = 0.0) -> dict:
    """Time the callables of ``fns`` against each other on the current card.

    Each round runs them forward and then backward (a, b, b, a), each turn
    ``reps`` calls between two CUDA events, so that drift of the card's clock
    and temperature falls on all alike.  Returns {name: (median ms per call,
    spread)} over the 2 * rounds turns; the spread is (max - min) / median.

    Where a call keeps the host longer than the card, the events would time
    the host.  ``lead_ms`` > 0 puts a spin of that length on the stream
    before each turn's first event, so that the host has queued the turn's
    calls by the time the card starts them, and the events time the card."""
    lead_cycles = int(lead_ms * 1e-3 * torch.cuda.get_device_properties(
        torch.cuda.current_device()).clock_rate * 1e3) if lead_ms else 0
    names = list(fns)
    for fn in fns.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    turns = {name: [] for name in names}
    for _ in range(rounds):
        events = []
        for name in names + names[::-1]:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            if lead_cycles:
                torch.cuda._sleep(lead_cycles)
            start.record()
            for _ in range(reps):
                fns[name]()
            stop.record()
            events.append((name, start, stop))
        torch.cuda.synchronize()
        for name, start, stop in events:
            turns[name].append(start.elapsed_time(stop) / reps)
    out = {}
    for name, ms in turns.items():
        med = statistics.median(ms)
        out[name] = (med, (max(ms) - min(ms)) / med)
    return out


# device activities that are not work: the synchronization records some
# profiler versions add on the device's timeline
_NOT_WORK = ("Sync",)


def _device_events(prof) -> list:
    """(name, start_us, end_us) of every device activity (kernel, memcpy,
    memset) that ``prof`` recorded."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not any(w in e.name for w in _NOT_WORK)]


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals: time covered by at
    least one of them, overlaps counted once."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def summarize_device_events(events: list, window_ms: float, reps: int,
                            top: int = 10) -> dict:
    """The device fields of ``device_profile`` from (name, start_us, end_us)
    records of ``reps`` calls inside a window of ``window_ms``.  Raises
    when there is no record: a profile that saw no device work measured
    nothing, and reading it as an idle card would be wrong."""
    if not events:
        raise RuntimeError(
            "torch.profiler recorded no CUDA activity: the device's busy "
            "time is unknown on this setup (time with CUDA events instead)")
    busy_ms = union_us((s, e) for _, s, e in events) / 1e3
    by_name: dict = {}
    for name, s, e in events:
        calls, us = by_name.get(name, (0, 0.0))
        by_name[name] = (calls + 1, us + (e - s))
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    busy_share = busy_ms / window_ms
    return {
        "window_ms": window_ms,
        "device_busy_ms": busy_ms,
        "busy_share": busy_share,
        "idle_share": 1.0 - busy_share,
        "launches": len(events) / reps,
        "top_kernels": [{"name": name, "calls": calls / reps,
                         "ms": us / 1e3 / reps}
                        for name, (calls, us) in ranked],
    }


def _device_of(out):
    if hasattr(out, "device"):
        return out.device
    for item in out if isinstance(out, (tuple, list)) else ():
        if hasattr(item, "device"):
            return item.device
    raise TypeError("device_profile: fn returned no tensor; pass device=")


def device_profile(torch, fn, warmup: int = 3, reps: int = 10,
                   device=None) -> dict:
    """How busy the card is while ``fn`` runs, read from ``torch.profiler``.

    ``fn`` runs ``warmup`` times, then ``reps`` times under
    ``torch.profiler.profile(activities=[CPU, CUDA])`` between two CUDA
    events.  Returns, for the ``reps`` calls together: ``window_ms`` (the
    events), ``device_busy_ms`` (the union of the kernel, memcpy and memset
    intervals, so that kernels that overlap count once), ``busy_share``,
    ``idle_share``; per call of ``fn``: ``launches`` (device activities)
    and ``top_kernels``, the ten largest by device time, each with its
    ``name``, ``calls`` and ``ms`` per call of ``fn``.  Beside them
    ``window_ms_unprofiled``, the same calls between two events without the
    profiler (the difference is what the profiler's host-side recording
    costs), and ``busy_share_unprofiled``, the busy time over that window:
    the share without the profiler's cost, where the kernels' own times do
    not change under it.

    ``device``: where ``fn``'s work runs; by default that of the tensor
    ``fn`` returns (or of the first tensor of the sequence it returns).  On
    the CPU every device field is None.  Raises when the profiler records
    no device activity: it never reports zeros in place of a reading."""
    out = None
    for _ in range(warmup):
        out = fn()
    dev = torch.device(device) if device is not None else _device_of(out)
    if dev.type != "cuda":
        return {"reps": reps, "window_ms": None, "window_ms_unprofiled": None,
                "device_busy_ms": None, "busy_share": None,
                "idle_share": None, "busy_share_unprofiled": None,
                "launches": None, "top_kernels": None}
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize(dev)
    unprofiled_ms = start.elapsed_time(stop)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize(dev)
    window_ms = start.elapsed_time(stop)
    out = summarize_device_events(_device_events(prof), window_ms, reps)
    return {"reps": reps, "window_ms_unprofiled": unprofiled_ms,
            "busy_share_unprofiled": out["device_busy_ms"] / unprofiled_ms,
            **out}
