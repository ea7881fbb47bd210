"""Time to solution on the nanotube-sized system (d = 370, D = 68,265), on
one card.

    python3 -m mlff_tpu_torch.tools.bench_nanotube [--n-train 28]
        [--precon cholesky_panel] [--k K] [--apply-impl xla]
        [--labels manufactured] [--device cpu]

The port's counterpart of the root ``tools/bench_nanotube.py``.  The
nanotube is the reference's hardest headline system: its recorded optimum
is 17.9 min at n = 31,400 (data/rule_of_thumb.csv row 6).  n = 3 * 370 *
n_train, so the default n_train = 28 gives n = 31,080.  The synthetic tube
(``make_dataset("nanotube", seed=3)``) has no symmetry beyond the identity
(P = 1), so the Trainer takes the square all-pairs layout for the cache's
fields, the column assembly and the matvec.  Defaults: the greedy panel
pivoted Cholesky (``cholesky_panel``; the reference's archived nanotube
sweep needs ~2x fewer iterations with pivoted Cholesky than with
lev_random) at the rule-of-thumb k.

Labels (``--labels``): ``manufactured`` (the default) solves y = (K + lam I)
alpha* for a random alpha* (seed 5), one f64 matvec of the packed cache;
the synthetic tube's Morse forces load the kernel's ~zero eigendirections,
which makes tol 1e-4 unreachable even in exact f64, while the manufactured
system has the production (n, d, D, k) shapes and is reachable.
``dataset`` keeps the Morse forces.
One JSON line: ``value`` = preconditioner + CG seconds, ``vs_baseline`` =
17.9 min over it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from . import benchlib as bl

REFERENCE_MIN_N31400 = 17.9  # data/rule_of_thumb.csv row 6 (optimal_runtime_min)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n-train", type=int, default=28)
    p.add_argument("--sig", type=float, default=10.0)
    p.add_argument("--precon", default="cholesky_panel")
    p.add_argument("--k", type=int, default=None,
                   help="preconditioner rank (default: rule of thumb)")
    p.add_argument("--apply-impl", default=None,
                   help="xla (default) or df64 (the df64 kernels)")
    p.add_argument("--labels", default="manufactured",
                   choices=["manufactured", "dataset"])
    bl.add_device_argument(p)
    return p


def torch_f64(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)


def manufactured_labels(task: dict, sig: float, dev) -> np.ndarray:
    """(K + lam I) alpha* for alpha* ~ N(0, 1) (seed 5), shaped as F_train:
    the Trainer normalizes labels by their std and solves the PSD system on
    them, so these labels make alpha* / std the solution."""
    from ..models.gdml import CG_LAM
    from ..ops import descriptor as dsc
    from ..ops import kernel as knl

    spec = dsc.make_spec(int(len(task["z"])))
    S = dsc.incidence_matrix(spec, device=dev)
    X, Jc = dsc.descriptors_from_R(spec, torch_f64(task["R_train"], dev))
    P_idx = np.arange(spec.dim)[None, :]
    cache = knl.build_cache(X, Jc, S, P_idx, sig, CG_LAM, device=dev)
    n = bl.n_of(task)
    alpha_star = np.random.default_rng(5).standard_normal(n)
    y = knl.matvec_psd(cache, torch_f64(alpha_star, dev)).cpu().numpy()
    return y.reshape(np.asarray(task["F_train"]).shape)


def run(args, maxiter: int | None = None) -> tuple[dict, dict]:
    """(the JSON line's fields, the trained model); ``maxiter`` (a cap on
    the CG iterations) is for tests."""
    from ..data.synthetic import make_dataset
    from ..experiments.rule_of_thumb import get_params, rule_of_thumb
    from ..models.gdml import Trainer
    from ..models.task import create_task

    dev = resolve_device(args.device)
    ds = make_dataset("nanotube", n_samples=args.n_train + 12, seed=3)
    task = create_task(ds, args.n_train, ds, n_valid=10, sig=args.sig,
                       solver="cg", use_sym=False)
    n = bl.n_of(task)
    if args.apply_impl:
        task["apply_impl"] = args.apply_impl
    if maxiter:
        task["solver_maxiter"] = maxiter
    if args.labels == "manufactured":
        task["F_train"] = manufactured_labels(task, args.sig, dev)
    m, k_unity, _ = get_params("nanotube")
    k_rot = rule_of_thumb(n, k_unity, m)
    k = args.k or k_rot
    bl.log(f"n = {n}, rule-of-thumb k = {k_rot}, using k = {k}")

    tr = Trainer(device=dev)
    t0 = time.perf_counter()
    model = tr.train(task, n_columns=k, str_preconditioner=args.precon,
                     callback=bl.progress)
    total = time.perf_counter() - t0
    t_pre, t_cg, _ = bl.times(model)
    solver_s = t_pre + t_cg
    out = {
        "metric": f"time_to_solution_nanotube_n{n}",
        "value": solver_s,
        "unit": "s",
        "converged": bool(model["is_conv"]),
        "iters": int(model["solver_iters"]),
        "k": k,
        "labels": args.labels,
        "matvec_impl": tr.last_info.get("matvec_impl"),
        "t_preconditioner_s": t_pre,
        "t_cg_s": t_cg,
        "wall_total_s": total,
        "vs_baseline": REFERENCE_MIN_N31400 * 60 / solver_s,
        "device": bl.device_name(dev),
    }
    return out, model


def main(argv=None) -> int:
    out, _ = run(parser().parse_args(argv))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
