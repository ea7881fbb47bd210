"""One CG iteration's cost on one card: the kernel matvec, the Woodbury
apply, and a PCG chunk per iteration at several chunk sizes.

    python3 -m mlff_tpu_torch.tools.time_cg_iter [--n-train 1166]
        [--k 2049] [--chunks 25 50 100 200] [--device cpu]

The port's counterpart of the root ``tools/profile_cg_iter.py``, on its
system: easy synthetic ethanol (seed 11, sigma = 5, lam = 1e-10, the
identity permutation), a split Nystrom preconditioner of k random columns
(``select_random``, seed 0).  One JSON line each for ``matvec_psd`` and
``woodbury_split_apply`` (ms per call on the host's clock and by CUDA
events, 20 calls after one warm call), and one per chunk size: ms per
iteration of one ``PCGSolver`` chunk that runs all its iterations, on the
host's clock and by CUDA events, beside ``mv_plus_pc_ms`` (the two calls'
event times added), and ``device_profile`` of the chunk: busy and idle
share, launches per iteration.  On the CPU every time, share and count is
null.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import resolve_device, synchronize
from ..utils.timing import device_profile
from . import benchlib as bl

N_ATOMS, SIG, LAM = 9, 5.0, 1e-10
CALLS = 20


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n-train", type=int, default=1166)
    p.add_argument("--k", type=int, default=2049)
    p.add_argument("--chunks", type=int, nargs="+",
                   default=[25, 50, 100, 200])
    bl.add_device_argument(p)
    return p


def host_ms(dev, fn, calls: int = CALLS) -> float | None:
    """Milliseconds per call on the host's clock: one warm call, then
    ``calls`` calls ending on a synchronized device; None on the CPU."""
    if dev.type != "cuda":
        return None
    fn()
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    synchronize(dev)
    return (time.perf_counter() - t0) * 1e3 / calls


def run(args, dev) -> list:
    from ..ops import kernel as knl
    from ..solvers import preconditioners as pc
    from ..solvers.cg import PCGSolver

    spec, cache, _ = bl.ethanol_system(args.n_train, dev, SIG, LAM)
    n = cache.n
    name = bl.device_name(dev)
    rng = np.random.default_rng(0)
    v = torch.as_tensor(rng.standard_normal(n), device=dev)
    idxs = pc.select_random(n, args.k, rng)
    P = pc.nystrom_preconditioner(spec, cache, idxs, LAM)
    lines = []

    def emit(line):
        line = dict(line, n=n, k=args.k, device=name)
        lines.append(line)
        print(json.dumps(line), flush=True)

    calls = {"matvec_psd": lambda: knl.matvec_psd(cache, v),
             "woodbury_apply": lambda: pc.woodbury_split_apply(P, v)}
    event = {}
    for case, fn in calls.items():
        event[case] = bl.event_ms(dev, fn, reps=CALLS, warmup=1)
        emit({"case": case, "host_ms": host_ms(dev, fn),
              "event_ms": event[case]})
    mv_pc = (None if event["matvec_psd"] is None
             else event["matvec_psd"] + event["woodbury_apply"])

    y = v / torch.linalg.norm(v)
    for chunk in args.chunks:
        runner = bl.chunk_runner(PCGSolver(lambda u: knl.matvec_psd(cache, u),
                                           P, chunk=chunk), y, chunk)
        h = host_ms(dev, runner, calls=1)
        e = bl.event_ms(dev, runner, reps=1, warmup=1)
        prof = device_profile(torch, runner, warmup=1, reps=1, device=dev)
        emit({"case": "pcg_chunk", "chunk": chunk,
              "host_ms_per_iter": None if h is None else h / chunk,
              "event_ms_per_iter": None if e is None else e / chunk,
              "mv_plus_pc_ms": mv_pc,
              "busy_share": prof["busy_share"],
              "idle_share": prof["idle_share"],
              "launches_per_iter": (None if prof["launches"] is None
                                    else prof["launches"] / chunk)})
    return lines


def main(argv=None) -> list:
    args = parser().parse_args(argv)
    return run(args, resolve_device(args.device))


if __name__ == "__main__":
    main()
    sys.exit(0)
