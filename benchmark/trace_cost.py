"""What the port's tracer costs while it records: a cell's frozen traced
work (one training, or the mix's ``trace_calls`` calls) with recording off
and on, in turns (off, on, on, off) for ``--rounds`` rounds, on one card.

    python3 -m benchmark.trace_cost --workload <cell> --seed <n> [--rounds 3]

Prints one JSON line: the cell, the card and its power limit, each turn's
seconds in order, the median seconds off and on, and the spans one
recording kept.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import sys
import time

from benchmark import harness
from benchmark.run import cache_dirs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args(argv)
    cache_dirs()
    import torch

    from mlff_tpu_torch.utils import trace

    if not torch.cuda.is_available():
        print("trace_cost: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cell = harness.find_cell(args.workload)
    kind = importlib.import_module(f"benchmark.kinds.{cell.mix['kind']}")
    session = kind.Session(cell, args.seed, device)
    session.traced()
    turns, spans = [], 0
    for _ in range(args.rounds):
        for on in (False, True, True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if on:
                with trace.recording() as rec:
                    session.traced()
                spans = len(rec.spans)
            else:
                session.traced()
            torch.cuda.synchronize()
            turns.append((on, time.perf_counter() - t0))
    off = [s for on, s in turns if not on]
    on = [s for on, s in turns if on]
    out = {"workload": cell.name, "seed": args.seed,
           "device": harness.card(torch, device),
           "turns": [["on" if o else "off", s] for o, s in turns],
           "off_median_s": statistics.median(off),
           "on_median_s": statistics.median(on),
           "on_over_off": statistics.median(on) / statistics.median(off),
           "spans_per_recording": spans}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
