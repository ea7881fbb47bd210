"""Rank 0 of a multi-rank run of a cut cell on the CPU (gloo), in a
process of its own, for ``test_bench_ranks.py``: the harness's own
``ranks.run_cell`` with the followers of ``group_follower`` and its
stand-ins.  Writes the result line's object, the forbidden modules the
followers loaded, and the window's models and iterations to a JSON file.

    python -m benchmark.tests.group_rank0 <cell> <ranks> <seed> <seconds> <trace> <k> <out.json>

``k``: the preconditioner's columns, in place of the cut cell's.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv) -> int:
    name, world, seed, seconds, trace, k, out_path = argv
    from benchmark import harness, ranks
    from benchmark.tests import group_follower, tiny

    ranks.host_threads(int(world))
    group_follower.stand_ins(0)
    cell = tiny.cell(name)
    cell = dataclasses.replace(cell, chips=int(world), config=dict(
        cell.config, n_columns=int(k)))
    held = {}
    real = harness.window

    def window(session, s):
        held["records"], window_s = real(session, s)
        return held["records"], window_s

    harness.window = window
    out, found = ranks.run_cell(cell, int(seed), float(seconds),
                                bool(int(trace)), T_START, device_type="cpu",
                                follower="benchmark.tests.group_follower")
    with open(out_path, "w") as f:
        json.dump({"out": out, "found": found,
                   "alphas_F": [r["model"]["alphas_F"].tolist()
                                for r in held["records"]],
                   "iters": [r["spans"]["solver_iters"]
                             for r in held["records"]]}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
