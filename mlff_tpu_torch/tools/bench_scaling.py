"""Per-iteration cost of the CG loop against the kernel size, on one card.

    python3 -m mlff_tpu_torch.tools.bench_scaling
        [--sizes 146 292 583 1166] [--iters 100] [--device cpu]

The port's counterpart of the root ``tools/bench_scaling.py``.  For each
n_train of the ethanol-shaped system (easy synthetic data, seed 7, the
real P = 6 group, sigma = 10, lam = 1e-10, n = 27 n_train) it builds the
pairwise kernel cache (``cache_build_s``, to a synchronized device) and a
dense-T Woodbury preconditioner of rank k = n / 10 from random T, runs 50
PCG iterations at tol 0 (warm-up; ``resid_50`` is their final residual
norm) and then times ``--iters`` more through the real chunked PCG loop
(``solvers/cg.py::PCGSolver``, chunks of 50; the loop's last host read
synchronizes).  One JSON line per size: ``n``, ``k``, ``cache_build_s``,
``ms_per_iter`` and ``matvec_nnz_per_s`` (the dense n x n operator's
entries per second of CG), with the device's name.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from . import benchlib as bl

N_ATOMS, SIG, LAM = 9, 10.0, 1e-10


def ethanol_perms() -> np.ndarray:
    perms = []
    for p3 in itertools.permutations([0, 1, 2]):
        p = np.arange(N_ATOMS)
        p[:3] = p3
        perms.append(p)
    return np.stack(perms)


def setup(n_train: int, dev, k_frac: float = 0.1):
    """(cache, solver, b, k, cache build seconds) of one size."""
    from .. import synchronize
    from ..data.synthetic import make_dataset
    from ..ops import descriptor as dsc
    from ..ops import kernel as knl
    from ..solvers.cg import PCGSolver
    from ..solvers.preconditioners import WoodburyPreconditioner

    ds = make_dataset("ethanol", n_samples=n_train, seed=7)
    spec = dsc.make_spec(N_ATOMS)
    S = dsc.incidence_matrix(spec, device=dev)
    P_idx = torch.as_tensor(dsc.desc_perms(ethanol_perms()),
                            dtype=torch.int64, device=dev)
    X, Jc = dsc.descriptors_from_R(
        spec, torch.as_tensor(ds["R"], dtype=torch.float64, device=dev))
    synchronize(dev)
    t0 = time.perf_counter()
    cache = knl.build_cache(X, Jc, S, P_idx, SIG, LAM, device=dev)
    synchronize(dev)
    t_cache = time.perf_counter() - t0

    n = cache.n
    rng = np.random.default_rng(0)
    b = torch.as_tensor(rng.normal(size=n), device=dev)
    k = max(1, int(k_frac * n))
    T = torch.as_tensor(rng.normal(size=(k, n)) / np.sqrt(n), device=dev)
    P = WoodburyPreconditioner(T=T, lam=LAM, info={})
    solver = PCGSolver(lambda v: knl.matvec_psd(cache, v), precon=P,
                       chunk=50)
    return cache, solver, b, k, t_cache


def measure(n_train: int, dev, iters: int = 100) -> dict:
    _, solver, b, k, t_cache = setup(n_train, dev)
    warm = solver.solve(b, tol=0.0, maxiter=50)
    t0 = time.perf_counter()
    solver.solve(b, tol=0.0, maxiter=iters)
    s_per_iter = (time.perf_counter() - t0) / iters
    n = int(b.shape[0])
    return {
        "n_train": n_train,
        "n": n,
        "k": k,
        "cache_build_s": t_cache,
        "resid_50": warm.resid,
        "s_per_iter": s_per_iter,
        "ms_per_iter": s_per_iter * 1e3,
        "matvec_nnz_per_s": n * n / s_per_iter,
    }


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--sizes", type=int, nargs="*",
                   default=[146, 292, 583, 1166])
    p.add_argument("--iters", type=int, default=100)
    bl.add_device_argument(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    name = bl.device_name(dev)
    results = []
    for n_train in args.sizes:
        row = dict(measure(n_train, dev, iters=args.iters), device=name)
        results.append(row)
        print(json.dumps(row), flush=True)
    return results


if __name__ == "__main__":
    main()
    sys.exit(0)
