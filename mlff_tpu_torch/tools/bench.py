"""Time to a trained model on the benchmark workload: calibrated ethanol at
n = 31,482, on one card.

    python3 -m mlff_tpu_torch.tools.bench [--device cpu]

The port's counterpart of the repository's root ``bench.py``, with its
workload and its accounting:

  * ``make_benchmark_dataset("ethanol", n_samples=1226, seed=11,
    n_train=1166)`` (difficulty-calibrated data), the molecule's real
    permutation group (P = 6), sigma = 10, tol 1e-4;
  * ``Trainer.train(task, n_columns=BENCH_K,
    str_preconditioner=BENCH_STRATEGY)`` with the task's ``matvec_dtype`` =
    ``BENCH_MATVEC`` and ``apply_impl`` = ``BENCH_APPLY``;
  * ``value`` = kernel-cache build + preconditioner build + CG of that one
    executed run, the scope of the reference's 48 s (``BASELINE_S``, the
    paper's optimum for this system: ``vs_baseline`` = 48 / value).

Environment knobs: ``BENCH_K`` (default 1536), ``BENCH_STRATEGY``
(``lev_random``), ``BENCH_MATVEC`` (``float64``) and ``BENCH_APPLY``
(``xla``; ``df64`` runs every preconditioner apply through the df64
kernels of ``csrc/df64_gemv.cu``).  ``BENCH_MATVEC`` defaults to the native
f64 matvec, not to the root bench's Ozaki one: on an H100 the f64 matvec is
the fast and exact one (ROADMAP section 3).

First-use costs (the CUDA context, the cuBLAS and cuSOLVER handles, the
first launch of each kernel, the df64 kernels' build when chosen) are paid
by a warm-up before the timed run, a training of 30 other geometries with
the same options (``warmup``), and reported as ``warmup_s``;
``wall_total_s`` counts them.  After the run the kernel cache is rebuilt
in the warm process (``t_cache_build_warm_s``, ``solve_warm_s``) and one
f64 matvec on it is timed with CUDA events (``matvec_f64_device_ms``, the
median of 20; null on the CPU).  ``device`` is the card's name and power
limit as nvidia-smi prints them.

Prints one JSON line; exits 1 when the solve does not converge.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

from .. import resolve_device, synchronize
from ..ops import kernel as knl
from . import benchlib as bl

BASELINE_S = 48.0  # 0.8 min, rule_of_thumb.csv row 0 (ethanol n = 31,400)
N_TRAIN = 1166
WARMUP_N = 30       # the warm-up's training points (n = 810)


def knobs() -> dict:
    """The environment knobs, read when the bench runs."""
    return {"k": int(os.environ.get("BENCH_K", "1536")),
            "strategy": os.environ.get("BENCH_STRATEGY", "lev_random"),
            "matvec_dtype": os.environ.get("BENCH_MATVEC", "float64"),
            "apply_impl": os.environ.get("BENCH_APPLY", "xla")}


def warmup(dev: torch.device, strategy: str = "lev_random",
           **task_options) -> float:
    """Pay the first-use costs a timed run would otherwise carry, and return
    their seconds: the CUDA context, the cuBLAS and cuSOLVER handles, the
    first launch of every kernel the run uses (CUDA loads a kernel's module
    when it first launches it) and, with ``apply_impl="df64"``, the nvcc
    build of ``csrc/df64_gemv.cu``.  It trains a small task of other data
    (calibrated ethanol, N = 30, seed 1) with the run's strategy and task
    options: the same code path at a size whose work is negligible.  The
    kernels it launches are counted by their wrappers, like any other."""
    from ..data.synthetic import make_benchmark_dataset
    from ..models.gdml import Trainer
    from ..models.task import create_task

    t0 = time.perf_counter()
    ds, perms = make_benchmark_dataset("ethanol", n_samples=WARMUP_N + 10,
                                       seed=1, n_train=WARMUP_N)
    task = create_task(ds, WARMUP_N, ds, n_valid=10, sig=10.0, solver="cg",
                       perms=perms)
    Trainer(device=dev).train(dict(task, **task_options), n_columns=200,
                              str_preconditioner=strategy)
    synchronize(dev)
    return time.perf_counter() - t0


def matvec_device_ms(cache: knl.KernelCache, reps: int = 20) -> float | None:
    """Median of ``reps`` CUDA-event timings of one ``matvec_psd`` on the
    cache, after one warm call; None on the CPU."""
    if cache.device.type != "cuda":
        return None
    gen = torch.Generator(device=cache.device).manual_seed(0)
    v = torch.randn(cache.n, dtype=torch.float64, device=cache.device,
                    generator=gen)
    knl.matvec_psd(cache, v)
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        knl.matvec_psd(cache, v)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize(cache.device)
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bench(dev, k: int, strategy: str, matvec_dtype: str, apply_impl: str,
          warmup_s: float, n_train: int = N_TRAIN,
          maxiter: int | None = None) -> tuple[dict, dict]:
    """(the JSON line's fields, the trained model) of one bench run, after a
    ``warmup`` with the same options that took ``warmup_s``."""
    from ..experiments.rule_of_thumb import get_params, rule_of_thumb
    from ..models.gdml import Trainer

    t_setup0 = time.perf_counter()
    task, _ = bl.benchmark_task("ethanol", n_train, matvec_dtype=matvec_dtype,
                                apply_impl=apply_impl, solver_maxiter=maxiter)
    n = bl.n_of(task)
    m, k_unity, _ = get_params("ethanol")
    bl.log(f"n = {n}, P = {task['perms'].shape[0]}, rule-of-thumb k = "
           f"{rule_of_thumb(n, k_unity, m)}, using k = {k} ({strategy}, "
           f"matvec={matvec_dtype}, apply={apply_impl})")
    tr = Trainer(device=dev)
    t_setup = time.perf_counter() - t_setup0

    t0 = time.perf_counter()
    model = tr.train(task, n_columns=k, str_preconditioner=strategy,
                     callback=bl.progress)
    t_train = time.perf_counter() - t0
    t_pre, t_cg, t_cache_cold = bl.times(model)
    t_finalize = float(model["finalize_s"])

    t_cache_warm, cache = bl.rebuild_cache(tr, task)
    matvec_ms = matvec_device_ms(cache)
    del cache
    bl.log(f"[INFO] kernel cache rebuild (warm): {t_cache_warm:.4f}s "
           f"(cold: {t_cache_cold:.4f}s)")

    solve_s = t_cache_cold + t_pre + t_cg
    solve_warm_s = t_cache_warm + t_pre + t_cg
    wall = warmup_s + t_setup + t_train
    iters = int(model["solver_iters"])
    out = {
        "metric": f"time_to_solution_ethanol_n{n}",
        "value": solve_s,
        "unit": "s",
        "workload": "calibrated+perms",
        "converged": bool(model["is_conv"]),
        "iters": iters,
        "k": k,
        "strategy": strategy,
        "matvec_dtype": matvec_dtype,
        "apply_impl": apply_impl,
        "t_cache_build_cold_s": t_cache_cold,
        "t_cache_build_warm_s": t_cache_warm,
        "t_preconditioner_s": t_pre,
        "t_cg_s": t_cg,
        "t_finalize_s": t_finalize,
        "warmup_s": warmup_s,
        "solve_warm_s": solve_warm_s,
        "wall_total_s": wall,
        # the dense K is n x n: its entries touched per second of CG
        "matvec_nnz_per_s": float(n) * n / (t_cg / max(1, iters)),
        "matvec_f64_device_ms": matvec_ms,
        "vs_baseline": BASELINE_S / solve_s,
        "vs_baseline_warm": BASELINE_S / solve_warm_s,
        "vs_baseline_wall": BASELINE_S / wall,
        "device": bl.device_name(dev),
    }
    return out, model


def main(argv=None, *, n_train: int = N_TRAIN,
         maxiter: int | None = None) -> int:
    """Run the bench and print its line; 0 if the solve converged, else 1.
    ``n_train`` and ``maxiter`` (a cap on the CG iterations) are for tests:
    the command line runs the published size, uncapped."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    bl.add_device_argument(p)
    args = p.parse_args(argv)
    dev, opts = resolve_device(args.device), knobs()
    t_warm = warmup(dev, opts["strategy"], matvec_dtype=opts["matvec_dtype"],
                    apply_impl=opts["apply_impl"])
    bl.log(f"[INFO] warm-up (context, handles, kernels): {t_warm:.2f}s")
    out, _ = bench(dev, warmup_s=t_warm, n_train=n_train, maxiter=maxiter,
                   **opts)
    print(json.dumps(out), flush=True)
    return 0 if out["converged"] else 1


if __name__ == "__main__":
    sys.exit(main())
