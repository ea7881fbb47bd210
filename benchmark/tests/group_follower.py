"""A follower of a multi-rank run on the CPU, for ``test_bench_ranks.py``:
``benchmark.ranks``'s own follower with two stand-ins set first.

  * The per-rank reading of peak device memory (0 on the CPU) reads
    ``PEAKS[rank]``, so the fullest card's rule has something to pick.
  * With ``GROUP_TEST_KILL=<rank>:<request>`` in the environment, that
    rank kills itself (SIGKILL) as it starts that request of the window.
  * With ``GROUP_TEST_FAULTS=<rank>``, that rank loads a module named
    ``jax`` (an empty stand-in) and reports each of its trainings as not
    converged.

    python -m benchmark.tests.group_follower <group dir> <rank>
"""

from __future__ import annotations

import os
import signal
import sys
import types

from benchmark import harness, ranks
from benchmark.kinds import train

PEAKS = (5000, 7000, 11000, 3000)


def stand_ins(rank: int) -> None:
    harness.memory_peak = lambda torch, device: PEAKS[rank]
    if os.environ.get("GROUP_TEST_FAULTS") == str(rank):
        sys.modules["jax"] = types.ModuleType("jax")
        real_request = train.Session.request

        def unconverged(self, i):
            return dict(real_request(self, i), ok=False)

        train.Session.request = unconverged
    kill = os.environ.get("GROUP_TEST_KILL")
    if kill is None:
        return
    at_rank, at_request = map(int, kill.split(":"))
    if at_rank != rank:
        return
    real = train.Session.request

    def request(self, i):
        if i == at_request:
            os.kill(os.getpid(), signal.SIGKILL)
        return real(self, i)

    train.Session.request = request


if __name__ == "__main__":
    stand_ins(int(sys.argv[2]))
    sys.exit(ranks.main())
