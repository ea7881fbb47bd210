"""Time to solution at the paper's kernel-size scales, on one card.

    python3 -m mlff_tpu_torch.tools.bench_time_to_solution
        [--molecule aspirin] [--n-train 498] [--k 3072] [--benchmark-data]
        [--matvec-dtype float64] [--apply-impl xla] [--nystrom-method ...]
        [--rank-tol ...] [--preconditioner lev_random] [--maxiter N]
        [--device cpu]

The port's counterpart of the root ``tools/bench_time_to_solution.py``:
trains a molecule-shaped system (default ethanol, n_train = 1166, n =
31,482; the default n_train puts n = 3 d n_train closest to 31,400) to tol
1e-4 at the rule-of-thumb preconditioner rank and prints one JSON line of
phase times.  ``value`` is the solver phase (preconditioner + CG), the
scope of the reference's minutes; ``vs_baseline`` divides the reference's
optimum at the nearest scale (``REFERENCE_MIN``: data/rule_of_thumb.csv
``optimal_runtime_min``; ethanol at n = 500,000 from the archived run
pickles) by it.  ``--benchmark-data`` takes the difficulty-calibrated data
and the molecule's permutation group at sigma = 10; without it the easy
synthetic data with ``use_sym=False`` at ``--sig``.

The matvec is the native f64 one unless ``--matvec-dtype`` says otherwise
(the root tool's default is also f64).  ``device`` is the card's name and
power limit as nvidia-smi prints them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .. import resolve_device
from . import benchlib as bl

# Reference optimal PCG solve minutes per (molecule, kernel-size scale):
# data/rule_of_thumb.csv `optimal_runtime_min`, rows 0-6 (n=31,400),
# 7-13 (n=75,000), 14-18 (n=158,000); the ethanol n=500,000 entry is the
# best archived total_time_solve (data/data/rule_of_thumb/n = 500000/,
# 8,993 s at k/n=1.39%).
REFERENCE_MIN = {
    "ethanol": {31400: 0.8, 75000: 2.7, 158000: 12.0, 500000: 149.9},
    "uracil": {31400: 0.6, 75000: 1.4, 158000: 6.0},
    "toluene": {31400: 1.2, 75000: 2.8, 158000: 33.0},
    "aspirin": {31400: 4.5, 75000: 6.4, 158000: 127.0},
    "azobenzene": {31400: 2.3, 75000: 4.2, 158000: 28.0},
    "catcher": {31400: 4.9, 75000: 15.2},
    "nanotube": {31400: 17.9, 75000: 60.0},
}


def reference_seconds(molecule: str, n: int) -> float | None:
    """Reference optimum at the scale nearest to n (or None if unknown)."""
    table = REFERENCE_MIN.get(molecule)
    if not table:
        return None
    scale = min(table, key=lambda s: abs(s - n) / s)
    if abs(scale - n) / scale > 0.15:  # no comparable reference scale
        return None
    return table[scale] * 60.0


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--molecule", default="ethanol")
    p.add_argument("--n-train", type=int, default=None,
                   help="default: n = 3*d*n_train closest to 31,400")
    p.add_argument("--sig", type=float, default=5.0)
    p.add_argument("--benchmark-data", action="store_true",
                   help="difficulty-calibrated dataset + the molecule's real "
                        "permutation group, sigma = 10")
    p.add_argument("--matvec-dtype", default=None,
                   help="float64 (default), ozaki, mixed or float32")
    p.add_argument("--nystrom-method", default=None,
                   help="chol_host (default), chol or eigh")
    p.add_argument("--rank-tol", type=float, default=None,
                   help="whitening eigenvalue clamp, relative (default 1e-10)")
    p.add_argument("--apply-impl", default=None,
                   help="xla (default), df64 (the df64 kernels) or ozaki")
    p.add_argument("--preconditioner", default="lev_random")
    p.add_argument("--k", type=int, default=None,
                   help="preconditioner rank (default: rule of thumb)")
    p.add_argument("--maxiter", type=int, default=None,
                   help="cap CG iterations (probe mode; reports s/iter)")
    bl.add_device_argument(p)
    return p


def make_task(args) -> dict:
    from ..data.synthetic import MOLECULES

    d = MOLECULES[args.molecule]
    n_train = args.n_train or max(2, round(31400 / (3 * d)))
    task, _ = bl.benchmark_task(
        args.molecule, n_train, args.benchmark_data, args.sig,
        matvec_dtype=args.matvec_dtype, nystrom_method=args.nystrom_method,
        rank_tol=args.rank_tol, apply_impl=args.apply_impl,
        solver_maxiter=args.maxiter)
    return task


def run(args) -> tuple[dict, dict]:
    """(the JSON line's fields, the trained model)."""
    from ..experiments.rule_of_thumb import get_params, rule_of_thumb
    from ..models.gdml import Trainer

    dev = resolve_device(args.device)
    task = make_task(args)
    n = bl.n_of(task)
    m, k_unity, _ = get_params(args.molecule)
    k_rot = rule_of_thumb(n, k_unity, m)
    k = args.k or k_rot
    bl.log(f"{args.molecule}: n = {n}, rule-of-thumb k = {k_rot}, "
           f"using k = {k}")

    t0 = time.perf_counter()
    model = Trainer(device=dev).train(
        task, n_columns=k, str_preconditioner=args.preconditioner,
        callback=bl.progress)
    total = time.perf_counter() - t0
    t_pre, t_cg, _ = bl.times(model)
    solver_s = t_pre + t_cg  # the reference's minutes are solver-phase only
    ref_s = reference_seconds(args.molecule, n)
    # this run's iterations: solver_iters counts a resumed task's too
    new_iters = (int(model["solver_iters"])
                 - int(task.get("solver_iters", 0) or 0))
    out = {
        "metric": f"time_to_solution_{args.molecule}_n{n}",
        "value": solver_s,
        "unit": "s",
        "converged": bool(model["is_conv"]),
        "iters": int(model["solver_iters"]),
        "k": k,
        "t_preconditioner_s": t_pre,
        "t_cg_s": t_cg,
        "wall_total_s": total,
        "workload": ("calibrated+perms" if args.benchmark_data
                     else "easy(use_sym=False)"),
        "s_per_iter": t_cg / max(1, new_iters),
        "vs_baseline": ref_s / solver_s if ref_s else None,
        "device": bl.device_name(dev),
    }
    return out, model


def main(argv=None) -> int:
    out, _ = run(parser().parse_args(argv))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
