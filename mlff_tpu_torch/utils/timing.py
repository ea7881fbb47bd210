"""Device timing by CUDA events, for comparisons of a few percent."""

from __future__ import annotations

import statistics


def time_in_turns(torch, fns: dict, rounds: int = 7, reps: int = 10) -> dict:
    """Time the callables of ``fns`` against each other on the current card.

    Each round runs them forward and then backward (a, b, b, a), each turn
    ``reps`` calls between two CUDA events, so that drift of the card's clock
    and temperature falls on all alike.  Returns {name: (median ms per call,
    spread)} over the 2 * rounds turns; the spread is (max - min) / median."""
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
