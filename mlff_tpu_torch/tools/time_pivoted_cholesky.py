"""Time the three pivoted-Cholesky factorizations on one CUDA card, and say
where the greedy loop's time goes.

    python3 -m mlff_tpu_torch.tools.time_pivoted_cholesky
        [--n-train 1166] [--rank 1536] [--repeats 3]

Builds the kernel cache of calibrated ethanol (the task ``chip_smoke.py``
trains: sigma = 10, lam = 1e-10, P = 6) and prints JSON lines:

  * ``factorizations``: host-clock seconds (device waited for) of
    ``pivoted_cholesky``, ``panel_pivoted_cholesky`` and ``block_rp_cholesky``
    at the given rank, the median of ``--repeats`` runs after one warm-up,
    with ``remaining_diag_error`` and ``min_pivot`` of each factor, and of
    ``kernel_diag_any`` alone;
  * ``greedy_loop``: the loop of ``pivoted_cholesky`` taken apart.
    ``queue_s`` is the host's time to queue all steps (no wait), ``total_s``
    the time until the device has finished them.  ``columns_s`` and
    ``schur_s`` run only the column assemblies, or only the Schur GEMVs
    ``L[:, :m] @ L[p, :m]``, of the same pivots on the finished factor;
    ``rest_s`` is what remains (argmax, masking, the updates of L and the
    diagonal).  ``device_kernels_per_step`` counts the kernels of 32 steps
    with ``torch.profiler`` (null if the profiler saw no device activity),
    ``device_busy_s_per_step`` their summed device time.  The whole loop
    runs once under ``torch.cuda.set_sync_debug_mode("error")``, which
    raises on any operation that waits for the device: ``no_host_read``.

The card's name and power limit come last.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

from ..data.synthetic import make_benchmark_dataset
from ..models.gdml import Trainer
from ..models.task import create_task
from ..ops import kernel as knl
from ..solvers import pivoted_cholesky as pch

SIG, LAM = 10.0, 1e-10


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def timed(fn, repeats: int):
    """(median seconds, last result) of ``fn`` after one warm-up call."""
    fn()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def greedy_breakdown(spec, cache, rank: int, repeats: int) -> dict:
    T = spec.dim_i
    diag = knl.kernel_diag_any(spec, cache)
    res = pch._pivoted_cholesky_device(T, cache, diag, rank)   # warm-up
    torch.cuda.synchronize()

    queue, total = [], []
    for _ in range(repeats):
        t0 = time.perf_counter()
        res = pch._pivoted_cholesky_device(T, cache, diag, rank)
        queue.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        total.append(time.perf_counter() - t0)
    L, pivots = res.L, res.pivots

    def columns():
        for m in range(rank):
            knl.kernel_column(T, cache, pivots[m:m + 1])

    def schur():
        for m in range(1, rank):
            L[:, :m] @ L[pivots[m:m + 1], :m][0]

    columns_s, _ = timed(columns, repeats)
    schur_s, _ = timed(schur, repeats)

    torch.cuda.set_sync_debug_mode("error")
    try:
        pch._pivoted_cholesky_device(T, cache, diag, rank)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()

    steps = min(32, rank)
    kernels_per_step = busy_per_step = None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        pch._pivoted_cholesky_device(T, cache, diag, steps)
        torch.cuda.synchronize()
    device_events = [e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    if device_events:
        kernels_per_step = len(device_events) / steps
        busy_per_step = sum(e.self_device_time_total
                            for e in device_events) * 1e-6 / steps

    total_s = statistics.median(total)
    return dict(
        rank=rank, queue_s=statistics.median(queue), total_s=total_s,
        columns_s=columns_s, schur_s=schur_s,
        rest_s=total_s - columns_s - schur_s,
        ms_per_step=total_s * 1e3 / rank,
        device_kernels_per_step=kernels_per_step,
        device_busy_s_per_step=busy_per_step, no_host_read=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-train", type=int, default=1166)
    ap.add_argument("--rank", type=int, default=1536)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_pivoted_cholesky: no CUDA device")

    N = args.n_train
    ds, perms = make_benchmark_dataset("ethanol", n_samples=N + 60, seed=11,
                                       n_train=N)
    task = create_task(ds, N, ds, n_valid=50, sig=SIG, solver="cg",
                       perms=perms)
    spec, S, X, Jc, P_idx = Trainer(device="cuda").build_kernel_inputs(task)
    cache = knl.build_cache(X, Jc, S, P_idx, SIG, LAM, device="cuda")

    row = {"n": cache.n, "rank": args.rank}
    row["kernel_diag_any_s"], _ = timed(
        lambda: knl.kernel_diag_any(spec, cache), args.repeats)
    for name, fn in (("pivoted_cholesky", pch.pivoted_cholesky),
                     ("panel_pivoted_cholesky", pch.panel_pivoted_cholesky),
                     ("block_rp_cholesky", pch.block_rp_cholesky)):
        seconds, (res, info) = timed(
            lambda fn=fn: fn(spec, cache, args.rank), args.repeats)
        row[name] = dict(seconds=seconds, rank=int(res.L.shape[1]),
                         remaining_diag_error=info["remaining_diag_error"],
                         min_pivot=info["min_pivot"])
    emit(factorizations=row)
    emit(greedy_loop=greedy_breakdown(spec, cache, args.rank, args.repeats))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
