"""Experiment: PCG iterations with a reduced-precision Woodbury apply, on
one card.

    python3 -m mlff_tpu_torch.tools.exp_f32_apply [--n-train 1166]
        [--k 2049] [--device cpu]

The port's counterpart of the root ``tools/exp_f32_apply.py``.  An f32
apply halves the bytes of the apply's two passes over the (n, m) factor B;
the question is whether CG tolerates its ~1e-7 relative error (fresh noise
in each apply; the CG state and the matvec stay f64).  The system: easy
synthetic ethanol (seed 11, sigma = 5, lam = 1e-10, the identity
permutation), lev_random columns (25 leverage-score columns, seed 0), the
labels the forces over their standard deviation.  PCG to tol 1e-4 (maxiter
8000) with the f64 split apply and with ``f32_apply``: f32 GEMVs over B in
full f32 (``require_full_f32``), the small W2 products in f64.

One JSON line per apply: ``iters``, ``converged``, ``cg_s`` and
``ms_per_iter`` (host clock to the solve's last host read; null on the
CPU), and ``true_resid``, ||b - (K + lam I) x|| / ||b|| of the end state by
the f64 matvec.  Divergence of the f32 apply is a result, not a failure.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import require_full_f32, resolve_device
from . import benchlib as bl

N_ATOMS, SIG, LAM = 9, 5.0, 1e-10
TOL, MAXITER = 1e-4, 8000


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n-train", type=int, default=1166)
    p.add_argument("--k", type=int, default=2049)
    bl.add_device_argument(p)
    return p


def f32_apply(state, v: torch.Tensor) -> torch.Tensor:
    """lam^-1 (v - B W2 W2^T B^T v) with the two passes over B in f32:
    ``state`` = (B32, W2 (f64), lam)."""
    B32, W2, lam = state
    require_full_f32(B32)
    u = v.to(torch.float32) @ B32                         # (m,) f32 GEMV
    x = W2 @ (W2.T @ u.to(torch.float64))                 # small, f64
    y = B32 @ x.to(torch.float32)                         # (n,) f32 GEMV
    return (v - y.to(torch.float64)) / lam


def system(n_train: int, k: int, dev):
    """(cache, the f64 split preconditioner, b) of the root's experiment."""
    from ..solvers import preconditioners as pc

    spec, cache, ds = bl.ethanol_system(n_train, dev, SIG, LAM)
    rng = np.random.default_rng(0)
    lev, order = pc.leverage_scores(spec, cache, LAM, 25, rng)
    idxs = pc.select_by_leverage("lev_random", lev, order, k, rng)
    y = np.asarray(ds["F"], dtype=np.float64).reshape(-1)[:cache.n]
    b = torch.as_tensor(y / y.std(), device=dev)
    return cache, pc.nystrom_preconditioner(spec, cache, idxs, LAM), b


def solve(cache, precon, b: torch.Tensor, dev) -> dict:
    """PCG to TOL with ``precon``: iterations, convergence, times, and the
    end state's true f64 residual."""
    from .. import synchronize
    from ..ops import kernel as knl
    from ..solvers.cg import pcg

    synchronize(dev)
    t0 = time.perf_counter()
    res = pcg(lambda v: knl.matvec_psd(cache, v), b, precon=precon, tol=TOL,
              maxiter=MAXITER)
    cg_s = time.perf_counter() - t0
    x = torch.as_tensor(res.x, device=dev)
    true = float(torch.linalg.norm(b - knl.matvec_psd(cache, x))
                 / torch.linalg.norm(b))
    return {"iters": res.num_iters, "converged": bool(res.converged),
            "cg_s": bl.on_card(dev, cg_s),
            "ms_per_iter": bl.on_card(dev, cg_s * 1e3 / max(res.num_iters, 1)),
            "resid": res.resid / float(torch.linalg.norm(b)),
            "true_resid": true}


def run(args, dev) -> list:
    cache, P, b = system(args.n_train, args.k, dev)
    state32 = (P.B.to(torch.float32), P.W2, P.lam)
    name = bl.device_name(dev)
    lines = []
    for apply, precon in (("f64", P),
                          ("f32", lambda v: f32_apply(state32, v))):
        line = {"apply": apply, "n": cache.n, "k": args.k, "tol": TOL,
                "maxiter": MAXITER, **solve(cache, precon, b, dev),
                "device": name}
        lines.append(line)
        print(json.dumps(line), flush=True)
    return lines


def main(argv=None) -> list:
    args = parser().parse_args(argv)
    return run(args, resolve_device(args.device))


if __name__ == "__main__":
    main()
    sys.exit(0)
