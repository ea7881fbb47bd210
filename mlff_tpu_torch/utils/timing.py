"""Device timing by CUDA events, for comparisons of a few percent, and a
call's time on the host's clock."""

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
