"""Iterative PCG solve with a Nyström preconditioner.

PyTorch port of the main slice of ``mlff_tpu.solvers.iterative`` (reference:
sgdml/solvers/iterative_solver.py:620-1108): preconditioner dispatch for the
leverage-score family, scipy-parity PCG on the PSD system (K + lam I) a = y,
and the info dict in the JAX package's schema.  Not in this module yet (each
raises NotImplementedError naming its ROADMAP item): the pivoted-Cholesky,
truncated-Cholesky, rank-k and eigvec strategies, stagnation restarts,
spectra diagnostics, energy constraints and the reduced-precision matvecs.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import kernel as knl
from ..ops.descriptor import DescriptorSpec
from ..utils.log import get_logger
from . import preconditioners as pc
from .cg import pcg

log = get_logger(__name__)

PORTED_STRATEGIES = ("lev_scores", "random_scores", "inverse_lev", "lev_random")


@dataclass
class IterativeResult:
    alphas: np.ndarray            # PSD convention
    num_iters: int
    resid: float
    train_rmse: float
    inducing_pts_idxs: np.ndarray
    is_conv: bool
    info: dict = field(default_factory=dict)


def build_preconditioner(
    spec: DescriptorSpec,
    cache: knl.KernelCache,
    strategy: str,
    k: int,
    lam: float,
    rng: np.random.Generator,
    task: dict | None = None,
    n_inducing_pts: int = 25,
):
    """Build (P_apply, inducing_pts_idxs, info) for one strategy string."""
    task = task or {}
    if strategy not in PORTED_STRATEGIES:
        raise NotImplementedError(
            f"str_preconditioner = {strategy!r} is ROADMAP module item 9")
    t0 = time.perf_counter()
    if strategy == "random_scores":
        inducing = pc.select_random(cache.n, k, rng)
    else:
        lev, order = pc.leverage_scores(spec, cache, lam, n_inducing_pts, rng)
        inducing = pc.select_by_leverage(strategy, lev, order, k, rng)
    if inducing.shape != (k,):
        raise RuntimeError("incorrect number of inducing points")
    P = pc.nystrom_preconditioner(
        spec, cache, inducing, lam,
        use_E_cstr=bool(task.get("use_E_cstr", False)),
        method=str(task.get("nystrom_method", "chol_host")),
        rank_tol=float(task.get("rank_tol", 1e-10)),
        apply_impl=str(task.get("apply_impl", "xla")),
        block_cols=(int(task["nystrom_block_cols"])
                    if task.get("nystrom_block_cols") else None),
    )
    info = {"total_time_preconditioner": time.perf_counter() - t0,
            "nystrom": P.info}
    info["total_time_cholesky"] = info["total_time_preconditioner"]
    return P, inducing, info


def _square_matvec_wins(spec: DescriptorSpec, cache: knl.KernelCache) -> bool:
    """The JAX package's rule for its square all-pairs matvec (large-A
    molecules); the port has no square layout yet."""
    N, A, P = cache.n_train, spec.n_atoms, cache.n_perms
    sq_bytes = (2 * N * P * A * A * 3 + 2 * N * P * A * A) * 8
    return A >= 64 * P and sq_bytes < int(4e9)


def solve_iterative(
    spec: DescriptorSpec,
    cache: knl.KernelCache,
    task: dict,
    y: np.ndarray,
    y_std: float,
    break_percentage: float | None = None,
    str_preconditioner: str = "random_scores",
    flag_eigvals: bool = False,
    callback=None,
    save_progr_callback=None,
    seed: int = 0,
    allow_restarts: bool = False,
) -> IterativeResult:
    """Train alphas by PCG (reference Iterative.solve,
    iterative_solver.py:620-1108)."""
    if allow_restarts:
        raise NotImplementedError(
            "stagnation-triggered restarts are ROADMAP module item 9")
    if flag_eigvals:
        raise NotImplementedError(
            "preconditioned-spectrum diagnostics are ROADMAP module item 9")
    if task.get("use_E_cstr"):
        raise NotImplementedError(
            "energy-constrained solves are ROADMAP module item 10")
    matvec_dtype = str(task.get("matvec_dtype", "float64"))
    if matvec_dtype != "float64":
        raise NotImplementedError(
            f"matvec_dtype {matvec_dtype!r} is ROADMAP module items 10-11")
    impl = str(task.get("matvec_impl", "auto"))
    if impl == "square" or (impl == "auto" and _square_matvec_wins(spec, cache)):
        raise NotImplementedError(
            "the square all-pairs matvec is ROADMAP module item 10")

    t_start = time.perf_counter()
    rng = np.random.default_rng(seed)
    n = cache.n
    n_train = cache.n_train
    lam = float(cache.lam)
    dev = cache.device

    # warm start from a previous model (resume path, reference :644-646)
    alphas0 = None
    num_iters0 = int(task.get("solver_iters", 0) or 0)
    if task.get("alphas0_F") is not None:
        alphas0 = -np.asarray(task["alphas0_F"])  # reference convention

    if break_percentage is None:
        n_inducing_pts = min(n_train, int(task.get("n_inducing_pts_init", 25)))
        k = n_inducing_pts * spec.dim_i
    else:
        n_inducing_pts = int(max(np.ceil(break_percentage * n_train), 1))
        k = int(break_percentage * n)
    k = max(1, min(k, n))

    P_apply, inducing, info_pc = build_preconditioner(
        spec, cache, str_preconditioner, k, lam, rng,
        task=task, n_inducing_pts=n_inducing_pts,
    )
    log.info(
        "preconditioner '%s' built: k=%d (%.1f%% of n=%d) in %.2fs",
        str_preconditioner, k, 100.0 * k / n, n,
        info_pc["total_time_preconditioner"],
    )
    info = dict(info_pc)

    maxiter = 3 * spec.n_atoms * n_train * 5
    if task.get("solver_maxiter"):
        maxiter = int(task["solver_maxiter"])

    def ckpt(x_np, iters, resid):
        if save_progr_callback is not None:
            save_progr_callback(alphas_psd=x_np, num_iters=iters, resid=resid,
                                inducing_pts_idxs=inducing)

    y_dev = torch.as_tensor(np.asarray(y), dtype=torch.float64, device=dev)
    x0 = (torch.as_tensor(alphas0, dtype=torch.float64, device=dev)
          if alphas0 is not None else None)
    result = pcg(
        lambda v: knl.matvec_psd(cache, v), y_dev, precon=P_apply, x0=x0,
        tol=float(task.get("solver_tol", 1e-4)),
        maxiter=maxiter,
        callback=callback, checkpoint_callback=ckpt,
        it0=num_iters0,
    )

    info.update({
        "is_conv": result.converged,
        "total_time_cg": result.time_s,
        "total_time_solve": time.perf_counter() - t_start,
        "num_restarts": 0,
    })
    return IterativeResult(
        alphas=result.x,
        num_iters=result.num_iters,
        resid=result.resid,
        train_rmse=result.resid / np.sqrt(len(y)),
        inducing_pts_idxs=inducing,
        is_conv=result.converged,
        info=info,
    )
