"""The real chunked PCG loop's time per iteration taken apart into the
kernel matvec, the preconditioner apply and the vector operations, on one
card.

    python3 -m mlff_tpu_torch.tools.time_chunk_parts [--n-train 2778]
        [--k 3753] [--perms] [--matvec-dtype float64|float32|mixed|ozaki]
        [--apply-impl xla|df64|ozaki] [--device cpu]

The port's counterpart of the root ``tools/profile_chunk_parts.py``.  The
system: easy synthetic ethanol (seed 11, sigma = 5, lam = 1e-10), the
identity permutation or, with ``--perms``, the benchmark's group (P = 6),
and a split Nystrom preconditioner of k random columns (seed 0).  The loop
is ``solvers/cg.py::PCGSolver`` in chunks of 50 iterations (the chunk of
``pcg`` at the main task's n), run four ways:

    full         the matvec and the apply
    matvec_only  the apply replaced by the identity (``cg._identity``)
    apply_only   the matvec replaced by the identity
    vector_ops   both replaced

Each case: ``resid``, the residual of a 200-iteration solve at a
tolerance it never reaches; ``ms_per_iter``, CUDA events around four
chunks from the start state, each with its host read
(``benchlib.chunk_runner``), the four cases timed in turns (median of six
turns, and the spread); and ``device_profile`` of one chunk
(``utils/timing.py``): the
device's busy ms, busy and idle share and launches per iteration, and the
top kernels.  The last line, ``case: "split"``: matvec = matvec_only -
vector_ops, apply = apply_only - vector_ops, vector ops = vector_ops, their
sum against full (``sum_over_full``), and the same split of the device's
busy time per iteration, which adds up by construction.  With
``--apply-impl df64`` the full case also counts each df64 kernel's
launches per iteration of one more chunk through the wrappers' counters.

On the CPU every time, share and launch count is null; ``resid`` (the
residual after the 200 iterations) is computed everywhere.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .. import resolve_device
from ..utils.timing import device_profile
from . import benchlib as bl

N_ATOMS, SIG, LAM = 9, 5.0, 1e-10
ITERS, CHUNK = 200, 50
PROFILE_WARMUP, PROFILE_REPS = 1, 3
TURN_ROUNDS = 3
CASES = ("full", "matvec_only", "apply_only", "vector_ops")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n-train", type=int, default=2778)
    p.add_argument("--k", type=int, default=3753)
    p.add_argument("--perms", action="store_true",
                   help="use the benchmark ethanol permutation group (P=6)")
    p.add_argument("--matvec-dtype", default="float64",
                   help="float64 | float32 (downcast products) | mixed "
                        "(centred f32 products, f64 chunk sums) | ozaki")
    p.add_argument("--apply-impl", default="xla", help="xla | df64 | ozaki")
    bl.add_device_argument(p)
    return p


def matvec_of(cache, matvec_dtype: str):
    """The CG operator v -> (K + lam I) v in the chosen arithmetic."""
    from ..ops import kernel as knl

    if matvec_dtype == "float64":
        return lambda v: knl.matvec_psd(cache, v)
    if matvec_dtype == "float32":
        c32 = knl.downcast_cache(cache)
        return lambda v: knl.matvec_psd(c32, v)
    if matvec_dtype == "mixed":
        return lambda v: knl.matvec_psd_mixed(cache, v)
    if matvec_dtype == "ozaki":
        state = knl.ozaki_matvec_state(cache)
        return lambda v: knl.matvec_psd_ozaki(state, v)
    raise ValueError(f"unknown matvec dtype {matvec_dtype!r}")


def preconditioner(spec, cache, k: int, apply_impl: str,
                   rng: np.random.Generator):
    """The split Nystrom preconditioner of k random columns, applied by
    ``apply_impl``."""
    from ..solvers import preconditioners as pc

    idxs = np.sort(rng.choice(cache.n, k, replace=False))
    P = pc.nystrom_preconditioner(spec, cache, idxs, LAM)
    if apply_impl == "df64":
        return pc.df64_from_split(P)
    if apply_impl == "ozaki":
        return pc.ozaki_from_split(P)
    if apply_impl != "xla":
        raise ValueError(f"unknown apply_impl {apply_impl!r}")
    return P


def cases(matvec, precon) -> dict:
    """{case: (matvec, precon)}: the loop as it is and with the identity in
    place of the apply, of the matvec, and of both."""
    from ..solvers.cg import _identity

    return {"full": (matvec, precon), "matvec_only": (matvec, None),
            "apply_only": (_identity, precon),
            "vector_ops": (_identity, None)}


def solve(matvec, precon, b: torch.Tensor, iters: int = ITERS,
          chunk: int = CHUNK):
    """``iters`` iterations of the chunked loop at a tolerance it never
    reaches: the CGResult."""
    from ..solvers.cg import PCGSolver

    return PCGSolver(matvec, precon, chunk=chunk).solve(b, tol=1e-300,
                                                        maxiter=iters)


def measure(matvec, precon, b: torch.Tensor, dev, iters: int = ITERS,
            chunk: int = CHUNK) -> tuple:
    """One case: (its row without the times, its chunk runner).  The row
    holds the residual after ``iters`` iterations and the device profile of
    one chunk.  The runner runs one chunk from the start state, so each
    call runs all its iterations: a case whose residual reaches 0 (the
    identity operator) stops the solver after its first chunk, not the
    timing."""
    from ..solvers.cg import PCGSolver

    res = solve(matvec, precon, b, iters, chunk)
    runner = bl.chunk_runner(PCGSolver(matvec, precon, chunk=chunk), b, chunk)
    prof = device_profile(torch, runner, warmup=PROFILE_WARMUP,
                          reps=PROFILE_REPS, device=dev)
    per_iter = PROFILE_REPS * chunk

    def per(value, by=per_iter):
        return None if value is None else value / by

    return {
        "iters": res.num_iters,
        "resid": res.resid,
        "busy_share": prof["busy_share"],
        "idle_share": prof["idle_share"],
        "busy_share_unprofiled": prof["busy_share_unprofiled"],
        "device_busy_ms_per_iter": per(prof["device_busy_ms"]),
        "profiled_ms_per_iter": per(prof["window_ms"]),
        "unprofiled_ms_per_iter": per(prof["window_ms_unprofiled"]),
        "launches_per_iter": per(prof["launches"], chunk),
        "top_kernels": (None if prof["top_kernels"] is None else [
            dict(t, calls_per_iter=t["calls"] / chunk,
                 ms_per_iter=t["ms"] / chunk) for t in prof["top_kernels"]]),
    }, runner


def loop_ms(runners: dict, dev, iters: int = ITERS, chunk: int = CHUNK
            ) -> dict:
    """{case: (ms per iteration, spread)} of the cases' chunk runners timed
    in turns (``time_in_turns``: ``iters // chunk`` chunks between two CUDA
    events per turn, TURN_ROUNDS rounds forward and back, the median), so
    that the host's drift, which sets the pace of a host-bound case, falls
    on all cases alike; None on the CPU."""
    from ..utils.timing import time_in_turns

    if dev.type != "cuda":
        return {case: (None, None) for case in runners}
    out = time_in_turns(torch, runners, rounds=TURN_ROUNDS,
                        reps=iters // chunk)
    return {case: (ms / chunk, spread) for case, (ms, spread) in out.items()}


def split(rows: dict, key: str = "ms_per_iter") -> dict | None:
    """matvec, apply and vector-op parts of ``key`` per iteration from the
    four cases, their sum and its ratio to the full case; None where the
    cases carry no time (the CPU)."""
    t = {case: rows[case][key] for case in CASES}
    if any(v is None for v in t.values()):
        return None
    parts = {"matvec": t["matvec_only"] - t["vector_ops"],
             "apply": t["apply_only"] - t["vector_ops"],
             "vector_ops": t["vector_ops"]}
    total = sum(parts.values())
    return {**parts, "sum": total, "full": t["full"],
            "sum_over_full": total / t["full"]}


def df64_launches_per_iter(matvec, precon, b: torch.Tensor, dev,
                           chunk: int = CHUNK) -> dict | None:
    """Each df64 kernel's launches per iteration in one chunk of the loop,
    by the wrappers' counters (set to 0 before it); None on the CPU, where
    the wrappers run their plain versions."""
    from ..ops import df64_gemv as dg
    from ..solvers.cg import PCGSolver
    from ..utils import trace

    trace.reset(*dg.LAUNCHES.values())
    bl.chunk_runner(PCGSolver(matvec, precon, chunk=chunk), b, chunk)()
    return bl.on_card(dev, {f"df64_{k}": trace.counter(c) / chunk
                            for k, c in dg.LAUNCHES.items()})


def run(args, dev) -> list:
    """The four case lines and the split line."""
    spec, cache, _ = bl.ethanol_system(args.n_train, dev, SIG, LAM,
                                       perms=args.perms)
    rng = np.random.default_rng(0)
    precon = preconditioner(spec, cache, args.k, args.apply_impl, rng)
    b = torch.as_tensor(rng.standard_normal(cache.n), device=dev)
    matvec = matvec_of(cache, args.matvec_dtype)
    common = {"n": cache.n, "P": cache.n_perms, "k": args.k,
              "matvec_dtype": args.matvec_dtype,
              "apply_impl": args.apply_impl, "chunk": CHUNK,
              "device": bl.device_name(dev)}
    rows, runners = {}, {}
    for case, (mv, pc) in cases(matvec, precon).items():
        rows[case], runners[case] = measure(mv, pc, b, dev)
        if case == "full" and args.apply_impl == "df64":
            rows[case]["df64_launches_per_iter"] = df64_launches_per_iter(
                mv, pc, b, dev)
    lines = []
    for case, (ms, spread) in loop_ms(runners, dev).items():
        rows[case].update(ms_per_iter=ms, ms_spread=spread)
        line = {"case": case, **common, **rows[case]}
        lines.append(line)
        print(json.dumps(line), flush=True)
    out = {"case": "split", **common, "ms_per_iter": split(rows),
           "device_busy_ms_per_iter": split(rows, "device_busy_ms_per_iter"),
           "busy_share_full": rows["full"]["busy_share"],
           "busy_share_unprofiled_full":
               rows["full"]["busy_share_unprofiled"],
           "launches_per_iter_full": rows["full"]["launches_per_iter"]}
    print(json.dumps(out), flush=True)
    return lines + [out]


def main(argv=None) -> list:
    args = parser().parse_args(argv)
    return run(args, resolve_device(args.device))


if __name__ == "__main__":
    main()
    sys.exit(0)
