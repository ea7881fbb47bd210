"""Mixed-precision iterative-refinement PCG.

PyTorch port of ``mlff_tpu.solvers.ir_cg``.  An outer f64 loop keeps the
true residual and solution while an inner reduced-precision PCG solves the
correction equation A e = r to a loose tolerance:

    x_{k+1} = x_k + e_k,   r_{k+1} = b - A x_{k+1}  (one f64 matvec each).

Each outer step contracts the residual by about the inner tolerance until
the f32 accuracy floor, where refinement stalls and the solve reports it
(not converged) instead of looping.  At the production lam = 1e-10 the floor
is reached before tol 1e-4: the JAX package records this as a negative
result, and nothing in either package calls these functions but tests and
users.  No counterpart in the reference, which is f64 throughout.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import require_full_f32
from ..ops import kernel as knl
from ..utils.log import get_logger
from .cg import PCGSolver

log = get_logger(__name__)


@dataclass
class IRResult:
    x: np.ndarray
    converged: bool
    outer_iters: int
    inner_iters_total: int
    resid: float
    time_s: float
    inner_resids: list


def ir_pcg(
    matvec_hi,
    matvec_lo,
    b: torch.Tensor,
    precon_lo=None,
    tol: float = 1e-4,
    inner_tol: float = 1e-2,
    max_outer: int = 12,
    inner_maxiter: int = 500,
    x0: torch.Tensor | None = None,
    chunk: int = 25,
) -> IRResult:
    """Solve A x = b with f64 outer refinement and a reduced-precision inner
    PCG.  ``matvec_hi`` is the f64 operator, ``matvec_lo`` / ``precon_lo``
    the reduced-precision ones (callables on f64 vectors)."""
    t0 = time.perf_counter()
    inner_solver = PCGSolver(matvec_lo, precon=precon_lo, chunk=chunk)
    threshold = tol * float(torch.linalg.norm(b))

    x = torch.zeros_like(b) if x0 is None else x0.to(b)
    r = b - matvec_hi(x)
    inner_total = 0
    inner_resids = []
    resid = float(torch.linalg.norm(r))
    outer = 0
    while resid > threshold and outer < max_outer:
        outer += 1
        rnorm = resid
        inner = inner_solver.solve(r, tol=inner_tol, maxiter=inner_maxiter)
        inner_total += inner.num_iters
        inner_resids.append(inner.resid / max(rnorm, 1e-300))
        x = x + torch.as_tensor(inner.x, dtype=b.dtype, device=b.device)
        r = b - matvec_hi(x)          # true residual, f64
        new_resid = float(torch.linalg.norm(r))
        log.info("IR outer %d: inner %d iters (rel %.2e), residual %.3e -> "
                 "%.3e", outer, inner.num_iters, inner_resids[-1], rnorm,
                 new_resid)
        if new_resid >= 0.9 * resid:
            log.warning(
                "iterative refinement stalled at %.3e (f32 accuracy floor); "
                "continue in full f64 for the remaining digits", new_resid)
            resid = new_resid
            break
        resid = new_resid

    return IRResult(
        x=x.cpu().numpy(),
        converged=resid <= threshold,
        outer_iters=outer,
        inner_iters_total=inner_total,
        resid=resid,
        time_s=time.perf_counter() - t0,
        inner_resids=inner_resids,
    )


def ir_pcg_kernel(
    spec,
    cache64: knl.KernelCache,
    b: torch.Tensor,
    precon_T: torch.Tensor,
    lam: float,
    **kwargs,
) -> IRResult:
    """ir_pcg on the kernel system: the f32 operator from a
    ``downcast_cache`` copy of the f64 cache, the f32 preconditioner
    lam^-1 (v - T^T T v) from a fused Woodbury factor T (m, n)
    (``WoodburySplitPreconditioner.fused_T``), the f64 outer operator from
    the cache itself.  ``spec`` is unused, as in the JAX package."""
    cache32 = knl.downcast_cache(cache64)
    T32 = precon_T.to(torch.float32)
    lam32 = torch.tensor(lam, dtype=torch.float32)

    def precon_lo(v: torch.Tensor) -> torch.Tensor:
        require_full_f32(T32)
        v32 = v.to(torch.float32)
        return ((v32 - T32.T @ (T32 @ v32)) / lam32).to(torch.float64)

    return ir_pcg(
        matvec_hi=lambda v: knl.matvec_psd(cache64, v),
        matvec_lo=lambda v: knl.matvec_psd(cache32, v),
        b=b, precon_lo=precon_lo, **kwargs)
