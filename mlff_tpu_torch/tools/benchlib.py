"""What the measurement tools of this package share: the ``--device``
argument, the device's name, the benchmark task, the kernel cache's warm
re-measure, the peak device memory and the progress lines; for the timing
tools (``time_*``) the root profile tools' ethanol system, a call's time by
CUDA events, a stage's time on the host's clock and one chunk of the real
PCG loop as a callable.

Every timer here stops on a synchronized device.  A device number (the
peak memory, a CUDA event time) exists only on the card; on the CPU it is
None, never a host time under a device metric's name.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

from .. import synchronize
from ..models.gdml import CG_LAM
from ..ops import kernel as knl

SIG = 10.0  # the calibrated workload's sigma (the root bench.py, run_500k.py)


def add_device_argument(parser) -> None:
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu; without a card "
                             "the default raises")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def progress(it, resid, eff) -> None:
    log(f"  cg it={it} resid={resid:.3e} eff={eff}")


def device_name(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them
    (``name, power.limit``); "cpu" on the CPU."""
    if dev.type != "cuda":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[dev.index or 0]


def benchmark_task(molecule: str, n_train: int, benchmark_data: bool = True,
                   sig: float = SIG, **task_options) -> tuple[dict, dict]:
    """(task, dataset) of the tools' workload, 50 validation points, solver
    cg.  With ``benchmark_data``: the difficulty-calibrated data of
    ``make_benchmark_dataset`` (seed 11, n_train + 60 samples) and the
    molecule's permutation group at sigma = ``SIG``; without: the easy
    synthetic data of ``make_dataset`` at ``sig`` with ``use_sym=False``.  Each task
    option that is not None is set on the task."""
    from ..data.synthetic import make_benchmark_dataset, make_dataset
    from ..models.task import create_task

    if benchmark_data:
        ds, perms = make_benchmark_dataset(molecule, n_samples=n_train + 60,
                                           seed=11, n_train=n_train)
        task = create_task(ds, n_train, ds, n_valid=50, sig=SIG,
                           solver="cg", perms=perms)
    else:
        ds = make_dataset(molecule, n_samples=n_train + 60, seed=11)
        task = create_task(ds, n_train, ds, n_valid=50, sig=sig,
                           solver="cg", use_sym=False)
    task.update((k, v) for k, v in task_options.items() if v is not None)
    return task, ds


def rebuild_cache(trainer, task: dict) -> tuple[float, knl.KernelCache]:
    """(seconds, cache) of the kernel cache rebuilt from the task's inputs by
    the Trainer's own rule (``ops/kernel.py::pairwise_fits``, ``square_R``),
    timed from ready inputs to a synchronized device: the cache build of a
    warm process."""
    spec, S, X, Jc, P_idx = trainer.build_kernel_inputs(task)
    dev = trainer.device
    synchronize(dev)
    t0 = time.perf_counter()
    cache = knl.build_cache(
        X, Jc, S, P_idx, float(task["sig"]), CG_LAM,
        R=knl.square_R(task["R_train"], spec, P_idx.shape[0]),
        pairwise=knl.pairwise_fits(X.shape[0], P_idx.shape[0]),
        device=dev)
    synchronize(dev)
    return time.perf_counter() - t0, cache


def reset_peak_memory(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak_memory_gb(dev: torch.device) -> float | None:
    """Peak device memory since the last reset, GB; None on the CPU."""
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 1e9


def n_of(task: dict) -> int:
    """The kernel dimension n = 3 A N of a task."""
    return int(np.asarray(task["F_train"]).size)


def times(model: dict) -> tuple[float, float, float]:
    """(preconditioner, CG, cold cache build) seconds of a trained model."""
    return (float(model.get("total_time_preconditioner", np.nan)),
            float(model.get("total_time_cg", np.nan)),
            float(model.get("cache_build_s", np.nan)))


def event_ms(dev: torch.device, fn, reps: int = 20, warmup: int = 3
             ) -> float | None:
    """Milliseconds per call of ``fn``: ``reps`` calls back to back between
    two CUDA events after ``warmup`` calls.  Where the host queues the calls
    slower than the card runs them, this is the host's rate, as the calls'
    users see it.  None on the CPU (nothing runs)."""
    if dev.type != "cuda":
        return None
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(stop) / reps


def host_s(dev: torch.device, fn):
    """(result, seconds) of one call of ``fn`` on the host's clock, from a
    synchronized device to a synchronized device; the seconds are None on
    the CPU.  For stages that mix host work, transfers and device work."""
    synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    synchronize(dev)
    return out, (time.perf_counter() - t0 if dev.type == "cuda" else None)


def on_card(dev: torch.device, value):
    """``value`` on the card, None on the CPU: a time read on the CPU is not
    a device number."""
    return value if dev.type == "cuda" else None


def ethanol_system(n_train: int, dev: torch.device, sig: float,
                   lam: float = CG_LAM, perms: bool = False,
                   seed: int = 11) -> tuple:
    """(spec, cache, dataset) of the root profile tools' system: easy
    synthetic ethanol (``make_dataset``, ``n_train`` samples), the identity
    permutation or, with ``perms``, the benchmark's group (P = 6)."""
    from ..data.synthetic import benchmark_perms, make_dataset
    from ..ops import descriptor as dsc

    ds = make_dataset("ethanol", n_samples=n_train, seed=seed)
    spec = dsc.make_spec(ds["R"].shape[1])
    S = dsc.incidence_matrix(spec, device=dev)
    P_idx = (dsc.desc_perms(benchmark_perms("ethanol")) if perms
             else np.arange(spec.dim)[None, :])
    X, Jc = dsc.descriptors_from_R(
        spec, torch.as_tensor(ds["R"], dtype=torch.float64, device=dev))
    cache = knl.build_cache(X, Jc, S, P_idx, sig, lam, device=dev)
    return spec, cache, ds


def chunk_runner(solver, b: torch.Tensor, chunk: int):
    """One chunk of ``solver``'s real PCG loop as a callable: ``chunk``
    iterations of ``PCGSolver._run`` from the start state x = 0 on ``b``,
    with a threshold it never reaches, then the one host read that
    ``solvers/cg.py::_pcg_drive`` makes per chunk.  Returns the iterate."""
    from ..solvers.cg import CGState

    x0 = torch.zeros_like(b)
    resid0 = torch.linalg.norm(b)
    threshold = torch.zeros((), dtype=b.dtype, device=b.device)

    def run():
        state = CGState(
            x=x0, r=b, p=torch.zeros_like(b),
            rho=torch.ones((), dtype=b.dtype, device=b.device),
            resid=resid0, it=torch.zeros((), dtype=torch.int64,
                                         device=b.device),
            done=torch.zeros((), dtype=torch.bool, device=b.device))
        state, log = solver._run(state, threshold, chunk)
        head = torch.stack([state.it.to(b.dtype), state.done.to(b.dtype),
                            state.resid])
        torch.cat([log, head]).cpu()
        return state.x

    return run
