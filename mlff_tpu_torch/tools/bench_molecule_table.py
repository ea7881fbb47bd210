"""Per-molecule table at the paper's n = 31,400 scale, on one card.

    python3 -m mlff_tpu_torch.tools.bench_molecule_table [molecules...]
        [--k-frac 0.03,0.049] [--out table.json] [--rerun-best]
        [--device cpu]

The port's counterpart of the root ``tools/bench_molecule_table.py``.  One
row per molecule: difficulty-calibrated data and the molecule's real
permutation group (the ``tools.bench`` workload), solved to tol 1e-4 at
each k of a small sweep (``DEFAULT_KFRAC``, fractions of n); the fastest
converged k is the molecule's entry, against the reference's own optimum
at this scale (``REFERENCE``: data/rule_of_thumb.csv rows 0-6,
``optimal_runtime_min`` and ``optimal_columns``).  A row's ``solve_s`` is
cache build + preconditioner + CG, with the cache build re-measured once
per molecule in the warm process (``t_cache_warm_s``; the run's own cold
build is ``t_cache_cold_s``).

The matvec is ``TABLE_MATVEC`` (environment; default the native f64 one,
where the root tool defaults to its Ozaki matvec).  Results go to stdout;
with ``--out`` the table is also written there (rows already in that file
are kept and not re-run; ``--rerun-best`` re-measures each molecule's best
row and keeps the faster).  Nothing is written anywhere else.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .. import resolve_device
from . import benchlib as bl

# reference optimal minutes + optimal k at n = 31,400 (rule_of_thumb.csv
# rows 0-6: optimal_runtime_min, optimal_columns)
REFERENCE = {
    "ethanol": (0.8, 608), "uracil": (0.6, 1061), "toluene": (1.2, 3231),
    "aspirin": (4.5, 3231), "azobenzene": (2.3, 1851),
    "catcher": (4.9, 3226), "nanotube": (17.9, 9731),
}
# per-molecule k sweeps (fractions of n): bracket the reference's optimum
# ratio and the measured ethanol optimum (k/n ~ 4.9%)
DEFAULT_KFRAC = {
    "ethanol": (0.030, 0.049), "uracil": (0.034, 0.049),
    "toluene": (0.049, 0.103), "aspirin": (0.049, 0.103),
    "azobenzene": (0.049, 0.059), "catcher": (0.049, 0.103),
    "nanotube": (0.103, 0.179),
}


def default_n_train(mol: str) -> int:
    """n_train whose n = 3 d n_train is closest to 31,400."""
    from ..data.synthetic import MOLECULES

    return max(2, round(31400 / (3 * MOLECULES[mol])))


def make_task(mol: str, n_train: int) -> tuple[dict, int]:
    """(task, P) of one molecule."""
    task, _ = bl.benchmark_task(
        mol, n_train, matvec_dtype=os.environ.get("TABLE_MATVEC", "float64"))
    return task, int(task["perms"].shape[0])


def run_one(mol: str, k: int, warm_cache_s: dict, dev,
            n_train: int) -> tuple[dict, dict]:
    """(the row, the trained model) of one molecule at one k."""
    from ..models.gdml import Trainer

    task, P = make_task(mol, n_train)
    n = bl.n_of(task)
    tr = Trainer(device=dev)
    t0 = time.perf_counter()
    model = tr.train(task, n_columns=k, str_preconditioner="lev_random")
    wall = time.perf_counter() - t0
    t_pre, t_cg, t_cache_cold = bl.times(model)
    if mol not in warm_cache_s:
        warm_cache_s[mol], cache = bl.rebuild_cache(tr, task)
        del cache
    t_cache = warm_cache_s[mol]
    row = {
        "molecule": mol, "n": n, "P": P, "k": k,
        "k_over_n_pct": 100.0 * k / n,
        "converged": bool(model["is_conv"]),
        "iters": int(model["solver_iters"]),
        "solve_s": t_cache + t_pre + t_cg,
        "t_cache_warm_s": t_cache,
        "t_cache_cold_s": t_cache_cold,
        "t_preconditioner_s": t_pre,
        "t_cg_s": t_cg,
        "wall_s": wall,
    }
    return row, model


def entry(mol: str, rows: list) -> dict:
    """A molecule's table entry from its rows."""
    ref_min, ref_k = REFERENCE[mol]
    conv = [r for r in rows if r["converged"]]
    best = min(conv, key=lambda r: r["solve_s"]) if conv else None
    return {"rows": rows,
            "best_solve_s": best["solve_s"] if best else None,
            "best_k": best["k"] if best else None,
            "reference_optimal_s": ref_min * 60.0,
            "reference_optimal_k": ref_k,
            "speedup": ref_min * 60.0 / best["solve_s"] if best else None}


def main(argv=None, *, n_train: int | None = None) -> dict:
    """Run the table and print it; returns it.  ``n_train`` (every
    molecule's training points) is for tests: the command line runs each
    molecule at n ~ 31,400."""
    from ..data.synthetic import _BENCH_DIFFICULTY, MOLECULES

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("molecules", nargs="*", default=list(REFERENCE))
    ap.add_argument("--k-frac", default=None,
                    help="comma-separated k/n fractions overriding the "
                         "per-molecule defaults")
    ap.add_argument("--out", default=None,
                    help="also write the table to this JSON file (rows "
                         "already in it are kept)")
    ap.add_argument("--rerun-best", action="store_true",
                    help="re-measure each molecule's best-k row of --out "
                         "once and keep the faster sample")
    bl.add_device_argument(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    results = {}
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    def save():
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=2)

    warm_cache_s: dict = {}
    for mol in args.molecules:
        nt = n_train or default_n_train(mol)
        if args.rerun_best:
            old_entry = results.get(mol)
            if not old_entry or old_entry.get("best_k") is None:
                continue
            k = old_entry["best_k"]
            row, _ = run_one(mol, k, warm_cache_s, dev, nt)
            rows = old_entry["rows"]
            old = next(r for r in rows if r["k"] == k)
            if row["converged"] and row["solve_s"] < old["solve_s"]:
                rows[rows.index(old)] = row
            results[mol] = entry(mol, rows)
            save()
            continue
        if mol not in _BENCH_DIFFICULTY:
            bl.log(f"[{mol}] SKIPPED: no calibrated difficulty entry")
            continue
        fracs = ([float(x) for x in args.k_frac.split(",")]
                 if args.k_frac else DEFAULT_KFRAC[mol])
        rows = results.get(mol, {}).get("rows", [])
        n = 3 * MOLECULES[mol] * nt
        for frac in fracs:
            k = max(128, int(round(frac * n / 128)) * 128)
            if any(r["k"] == k for r in rows):
                bl.log(f"[{mol}] k={k}: row present, skipping")
                continue
            t0 = time.perf_counter()
            row, _ = run_one(mol, k, warm_cache_s, dev, nt)
            bl.log(f"[{mol}] k={k}: solve {row['solve_s']:.3f}s "
                   f"({row['iters']} iters, conv={row['converged']}) "
                   f"[{time.perf_counter() - t0:.0f}s]")
            rows.append(row)
            results[mol] = entry(mol, rows)
            save()
    table = {"device": bl.device_name(dev),
             "molecules": {m: {k: v for k, v in r.items() if k != "rows"}
                           for m, r in results.items()},
             "rows": [r for e in results.values() for r in e["rows"]]}
    print(json.dumps(table), flush=True)
    return table


if __name__ == "__main__":
    main()
    sys.exit(0)
