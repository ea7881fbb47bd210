"""Ethanol at n = 503,982 (n_train = 18,666), the reference's largest
archived scale point, on one card.

    python3 -m mlff_tpu_torch.tools.run_500k [--k 1024] [--maxiter N]
        [--probe] [--matvec float64] [--ckpt PATH] [--resume]
        [--manufactured] [--device cpu]

The port's counterpart of the root ``tools/run_500k.py``.  Reference
numbers (the archived run ``n = 500000/2022320_0944_precon_size_ethanol_
min18666_max18666``, cluster node43):

  k/n     iters   t_pre      t_cg       total_time_solve
  1.39%     770   2,218 s    6,775 s    8,993 s   <- optimum (149.9 min)
  0.86%   1,157   1,175 s    8,110 s    9,285 s
  0.53%   1,696     637 s    9,756 s   10,393 s
  0.32%   2,325     373 s   11,906 s   12,279 s
  0.20%   4,681     227 s   22,473 s   22,700 s

Configuration: difficulty-calibrated ethanol with the real P = 6 group
(the ``tools.bench`` workload at the 18,666 calibration entry), sigma =
10, lev_random.  The two (N, M) f64 caches would take 33 GB, far above the
Trainer's 3 GB switch, so it takes the on-the-fly matvec.  For k > 1024 the
Nystrom factor is built in column blocks of 768 (the reference tool's
rule).  ``--matvec`` is the task's ``matvec_dtype``: native f64 by default
(the root tool's default is its Ozaki matvec); with an inexact matvec f64
residual replacement stays on.

``--probe`` caps the solve at 20 iterations: the build times, the Gram
probe error of the factor and seconds per iteration, no convergence.
``--maxiter`` caps it elsewhere.  The solve checkpoints its unconverged
model to ``--ckpt`` (every ``MLFF_CKPT_EVERY_S`` seconds, 120 by default;
default path in the temporary directory), ``--resume`` continues from that
file (``create_task_from_model``), and a converged run that is not a probe
removes it.  ``--manufactured`` solves y = (K + lam I) alpha* for a random
alpha* (seed 7, one OTF matvec): a reachable system of the production
shapes.  After the solve one more f64 matvec gives the true residual.

One JSON line: ``value`` = cache build + preconditioner + CG, the archived
row at the nearest k/n, ``peak_mem_gb`` (the card's peak allocation; null
on the CPU) and the device's name.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from .. import resolve_device
from . import benchlib as bl

N_TRAIN = 18666
ARCHIVED = {  # k/n -> (iters, total_time_solve_s)
    0.0139: (770, 8993.2), 0.0086: (1157, 9284.8), 0.0053: (1696, 10392.7),
    0.0032: (2325, 12279.0), 0.0020: (4681, 22700.5),
}
PROBE_ITERS = 20
BLOCK_COLS = 768        # column blocks of the Nystrom factor for k > 1024


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--k", type=int, default=1024)
    ap.add_argument("--maxiter", type=int, default=None)
    ap.add_argument("--probe", action="store_true",
                    help=f"cap the solve at {PROBE_ITERS} iterations")
    ap.add_argument("--matvec", default="float64",
                    help="float64 (default), ozaki, mixed or float32")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "eth500k_ckpt.npz"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--manufactured", action="store_true",
                    help="labels y = (K + lam I) alpha* for a random alpha*")
    bl.add_device_argument(ap)
    return ap


def otf_cache(trainer, task):
    """The task's on-the-fly kernel cache (no (N, M) arrays)."""
    from ..models.gdml import CG_LAM
    from ..ops import kernel as knl

    spec, S, X, Jc, P_idx = trainer.build_kernel_inputs(task)
    return knl.build_cache(X, Jc, S, P_idx, float(task["sig"]), CG_LAM,
                           pairwise=False, device=trainer.device)


def run(args, n_train: int = N_TRAIN) -> tuple[dict, dict]:
    """(the JSON line's fields, the trained model)."""
    import torch

    from ..models.gdml import Trainer
    from ..models.task import create_task_from_model
    from ..ops import kernel as knl
    from ..utils.io import load_model, save_model

    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    task, ds = bl.benchmark_task(
        "ethanol", n_train, matvec_dtype=args.matvec,
        nystrom_block_cols=BLOCK_COLS if args.k > 1024 else None,
        solver_maxiter=args.maxiter or (PROBE_ITERS if args.probe else None))
    n = bl.n_of(task)
    bl.log(f"n = {n}, P = {task['perms'].shape[0]}, k = {args.k} (k/n = "
           f"{100.0 * args.k / n:.2f}%)  "
           f"[setup {time.perf_counter() - t0:.1f}s]")
    tr = Trainer(device=dev)

    if args.manufactured:
        cache = otf_cache(tr, task)
        alpha_star = np.random.default_rng(7).normal(size=n) / np.sqrt(n)
        y = knl.matvec_psd(cache, torch.as_tensor(alpha_star, device=dev))
        del cache
        task["F_train"] = y.cpu().numpy().reshape(
            np.asarray(task["F_train"]).shape)
        bl.log(f"manufactured labels: ||y|| = {float(y.norm()):.3e}")

    if args.resume and os.path.exists(args.ckpt):
        m_ck = load_model(args.ckpt)
        task_r = create_task_from_model(m_ck, ds)
        for key in ("matvec_dtype", "solver_maxiter", "nystrom_block_cols"):
            if key in task:
                task_r[key] = task[key]
        if args.manufactured:
            task_r["F_train"] = task["F_train"]
        task = task_r
        bl.log(f"resuming from {args.ckpt} at iteration "
               f"{int(np.asarray(m_ck['solver_iters']))}")

    def save_progress(model):
        save_model(args.ckpt, {k: v for k, v in model.items()
                               if not isinstance(v, dict)})
        bl.log(f"  [ckpt] iteration {model.get('solver_iters')} -> "
               f"{args.ckpt}")

    bl.reset_peak_memory(dev)
    t1 = time.perf_counter()
    model = tr.train(task, n_columns=args.k, str_preconditioner="lev_random",
                     callback=bl.progress, save_progr_callback=save_progress)
    wall = time.perf_counter() - t1
    peak_gb = bl.peak_memory_gb(dev)
    nystrom = tr.last_info.get("nystrom", {})

    # the true residual: one f64 matvec on the solution
    y, _, _ = tr.labels(task)
    cache = otf_cache(tr, task)
    x = torch.as_tensor(-np.asarray(model["alphas_F"]), device=dev)
    r = knl.matvec_psd(cache, x).cpu().numpy() - y
    del cache
    true_rel = float(np.linalg.norm(r) / np.linalg.norm(y))
    bl.log(f"true f64 residual: {true_rel:.3e} "
           f"(tol {task.get('solver_tol', 1e-4)})")

    t_pre, t_cg, t_cache = bl.times(model)
    iters = int(model["solver_iters"])
    new_iters = iters - int(task.get("solver_iters", 0) or 0)
    kn = args.k / n
    arch_key = min(ARCHIVED, key=lambda p: abs(p - kn) / p)
    arch_iters, arch_solve = ARCHIVED[arch_key]
    solve_s = t_cache + t_pre + t_cg
    out = {
        "metric": f"time_to_solution_ethanol_n{n}",
        "value": solve_s,
        "unit": "s",
        "workload": "calibrated+perms",
        "converged": bool(model["is_conv"]),
        "iters": iters,
        "k": args.k,
        "k_over_n_pct": 100 * kn,
        "matvec_dtype": args.matvec,
        "t_cache_build_s": t_cache,
        "t_preconditioner_s": t_pre,
        "t_cg_s": t_cg,
        "s_per_iter": t_cg / max(1, new_iters),
        "wall_s": wall,
        "true_residual_rel": true_rel,
        "gram_probe_err": nystrom.get("gram_probe_err"),
        "gram_guard_fired": nystrom.get("gram_guard_fired"),
        "peak_mem_gb": peak_gb,
        "archived_at_same_kn": {"k_over_n": arch_key, "iters": arch_iters,
                                "total_time_solve_s": arch_solve},
        "vs_archived_best": 8993.2 / solve_s,
        "vs_archived_same_kn": arch_solve / solve_s,
        "device": bl.device_name(dev),
    }
    if model["is_conv"] and not args.probe and os.path.exists(args.ckpt):
        os.unlink(args.ckpt)
    return out, model


def main(argv=None, *, n_train: int = N_TRAIN) -> int:
    """Run and print the line.  ``n_train`` is for tests: the command line
    runs the published n = 503,982."""
    out, _ = run(parser().parse_args(argv), n_train=n_train)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
