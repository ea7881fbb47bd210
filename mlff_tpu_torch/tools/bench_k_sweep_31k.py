"""Solver time over the preconditioner rank k at the n = 31,482 headline
scale, on one card.

    python3 -m mlff_tpu_torch.tools.bench_k_sweep_31k
        [--ks 1024 1536 2049 3072] [--benchmark-data] [--n-train 1166]
        [--precon lev_random] [--matvec-dtype ...] [--apply-impl ...]
        [--device cpu]

The port's counterpart of the root ``tools/bench_k_sweep_31k.py``.  The
rule-of-thumb k balances the reference's cost model; this port's costs
(batched column assembly, two host Choleskys, ~1 ms CG iterations) differ,
so the wall-clock-optimal k need not match it.  One training per k; each
row (k, solver seconds = preconditioner + CG, iterations, convergence) goes
to stderr as it finishes, and the last line of stdout is one JSON object
with the rows and the fastest converged k.  ``--benchmark-data`` is the
workload of ``tools.bench`` (calibrated data, P = 6, sigma = 10).  This
sweep times the solver; ``experiments/rule_of_thumb.py`` counts
iterations.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .. import resolve_device
from . import benchlib as bl


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n-train", type=int, default=1166)
    p.add_argument("--sig", type=float, default=5.0)
    p.add_argument("--ks", type=int, nargs="+",
                   default=[1024, 1536, 2049, 3072])
    p.add_argument("--precon", default="lev_random")
    p.add_argument("--benchmark-data", action="store_true",
                   help="calibrated difficulty + the real P = 6 group + "
                        "sigma = 10 (the tools.bench workload)")
    p.add_argument("--matvec-dtype", default=None)
    p.add_argument("--apply-impl", default=None)
    bl.add_device_argument(p)
    return p


def run(args) -> tuple[dict, list]:
    """(the JSON line's fields, the trained models in the order of --ks)."""
    from ..models.gdml import Trainer

    dev = resolve_device(args.device)
    task, _ = bl.benchmark_task("ethanol", args.n_train, args.benchmark_data,
                                args.sig, matvec_dtype=args.matvec_dtype,
                                apply_impl=args.apply_impl)
    n = bl.n_of(task)
    tr = Trainer(device=dev)
    rows, models = [], []
    for k in args.ks:
        t0 = time.perf_counter()
        model = tr.train(dict(task), n_columns=k,
                         str_preconditioner=args.precon)
        wall = time.perf_counter() - t0
        t_pre, t_cg, _ = bl.times(model)
        row = {"k": k, "solver_s": t_pre + t_cg, "t_pre_s": t_pre,
               "t_cg_s": t_cg, "iters": int(model["solver_iters"]),
               "converged": bool(model["is_conv"]), "wall_s": wall}
        rows.append(row)
        models.append(model)
        bl.log(json.dumps(row))
    best = min((r for r in rows if r["converged"]),
               key=lambda r: r["solver_s"], default=None)
    out = {"metric": f"k_sweep_ethanol_n{n}", "rows": rows,
           "best_k": best["k"] if best else None,
           "best_solver_s": best["solver_s"] if best else None,
           "device": bl.device_name(dev)}
    return out, models


def main(argv=None) -> int:
    out, _ = run(parser().parse_args(argv))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
