"""Iterative PCG solver with the full preconditioner zoo and restart logic.

PyTorch port of ``mlff_tpu.solvers.iterative`` (reference:
sgdml/solvers/iterative_solver.py:620-1108, and the adaptive restarts of
sgdml/solvers/iterative_inpoints.py:1011-1066):

  * preconditioner dispatch over the strategy strings of
    iterative_solver.py:672-807,
  * scipy-parity PCG (solvers.cg) on the PSD system (K + lam I) a = y,
  * wall-time breakdown and the info dict in the JAX package's schema,
  * optional spectra diagnostics (``flag_eigvals``; reference
    dev_utils.py:8-58),
  * optional stagnation-triggered restarts that grow the inducing set and
    warm-start from the last iterate (off by default, like the reference),
  * the square all-pairs matvec for large-A molecules
    (``ops.kernel.SquareCache``), chosen by the JAX package's rule,
  * energy constraints (``task["use_E_cstr"]``): the system of n + N rows,
    on the pairwise cache and the packed matvec only, as in the JAX package,
  * the precision options of the task: ``matvec_dtype`` "float64" (the
    default), "float32" (the product operands downcast), "mixed" (centred
    split f32 products) or "ozaki" (exact-slice products), the last three
    with f64 residual replacement (``residual_replacement``, on by
    default, governs the ozaki one); ``apply_impl`` "xla", "df64" or
    "ozaki".  With energy constraints "mixed" and "ozaki" take the f64
    matvec, the JAX package's rule.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import kernel as knl
from ..ops.descriptor import DescriptorSpec
from ..utils.log import get_logger
from . import preconditioners as pc
from .cg import pcg
from .pivoted_cholesky import (
    block_rp_cholesky, panel_pivoted_cholesky, pivoted_cholesky,
)

log = get_logger(__name__)

LEV_STRATEGIES = (
    "lev_scores", "random_scores", "inverse_lev", "lev_random",
    "truncated_cholesky", "truncated_cholesky_custom",
    "rank_k_lev_scores", "rank_k_lev_scores_custom",
)
ALL_STRATEGIES = LEV_STRATEGIES + (
    "cholesky", "cholesky_panel", "rpcholesky", "eigvec_precon",
    "eigvec_precon_block_diagonal", "eigvec_precon_atomic_interactions",
)


@dataclass
class IterativeResult:
    alphas: np.ndarray            # PSD convention
    num_iters: int
    resid: float
    train_rmse: float
    inducing_pts_idxs: np.ndarray
    is_conv: bool
    info: dict = field(default_factory=dict)


MATVEC_DTYPES = ("float64", "float32", "mixed", "ozaki")


def _check_task(task: dict) -> str:
    """Raise ValueError for an unknown ``apply_impl`` or ``matvec_dtype``
    (the JAX package takes an unknown ``matvec_dtype`` as "float64");
    returns ``apply_impl``."""
    apply_impl = str(task.get("apply_impl", "xla"))
    if apply_impl not in ("xla", "df64", "ozaki"):
        raise ValueError(f"unknown apply_impl {apply_impl!r}")
    matvec_dtype = str(task.get("matvec_dtype", "float64"))
    if matvec_dtype not in MATVEC_DTYPES:
        raise ValueError(f"unknown matvec_dtype {matvec_dtype!r}")
    return apply_impl


def build_preconditioner(
    spec: DescriptorSpec,
    cache: knl.KernelCache,
    strategy: str,
    k: int,
    lam: float,
    rng: np.random.Generator,
    task: dict | None = None,
    svd_cache: dict | None = None,
    n_inducing_pts: int = 25,
):
    """Build (P_apply, inducing_pts_idxs, info) for one strategy string."""
    task = task or {}
    apply_impl = _check_task(task)
    use_E_cstr = bool(task.get("use_E_cstr", False))
    info: dict = {}
    t0 = time.perf_counter()

    def _factor_precon(L):
        P = pc.woodbury_from_factor(L, lam)
        if apply_impl == "ozaki":
            return pc.ozaki_from_split(P)
        if apply_impl != "df64":
            return P
        # the JAX package's rule, kept verbatim so that the same task builds
        # the same operator: 3 components unless the conversion transient
        # (f64 B + three f32 slices, ~20 bytes per element) passes 8 GB
        comps = 3 if P.B.numel() * 20 < int(8e9) else 2
        return pc.df64_from_split(P, components=comps)

    if strategy == "cholesky":
        res, info_chol = pivoted_cholesky(spec, cache, max_rank=k,
                                          use_E_cstr=use_E_cstr)
        P = _factor_precon(res.L)
        inducing = np.arange(k)  # reference uses a size marker here
        info.update(info_chol)

    elif strategy == "cholesky_panel":
        # greedy panel variant: top-`block` residual-diagonal pivots per
        # round, rank-block product updates
        res, info_chol = panel_pivoted_cholesky(spec, cache, max_rank=k,
                                                use_E_cstr=use_E_cstr)
        P = _factor_precon(res.L)
        inducing = np.sort(np.asarray(info_chol["pivots"]))
        info.update(info_chol)

    elif strategy == "rpcholesky":
        # blocked randomly-pivoted variant (no reference counterpart;
        # arXiv:2410.03969-style block sampling)
        res, info_chol = block_rp_cholesky(spec, cache, max_rank=k,
                                           use_E_cstr=use_E_cstr)
        P = _factor_precon(res.L)
        inducing = np.sort(np.asarray(info_chol["pivots"]))
        info.update(info_chol)

    elif strategy in ("eigvec_precon", "eigvec_precon_block_diagonal",
                      "eigvec_precon_atomic_interactions"):
        P = pc.eigvec_preconditioner(spec, cache, k, lam, variant=strategy,
                                     svd_cache=svd_cache,
                                     use_E_cstr=use_E_cstr)
        inducing = np.arange(k)

    elif strategy in LEV_STRATEGIES:
        n_Fcols = cache.n  # inducing columns are always force columns
        if strategy == "random_scores":
            inducing = pc.select_random(n_Fcols, k, rng)
        elif strategy in ("truncated_cholesky", "truncated_cholesky_custom"):
            # hybrid: first k_trunc columns by pivot order of an incomplete
            # Cholesky, rest uniformly from the remainder
            # (reference iterative_solver.py:687-712)
            k_trunc = min(int(task.get("truncated_cholesky", 1500)), k)
            _, info_chol = pivoted_cholesky(spec, cache, max_rank=k_trunc)
            order = info_chol["index_columns"]
            chosen = order[:k_trunc]
            rest = rng.choice(order[k_trunc:], size=k - k_trunc, replace=False) \
                if k > k_trunc else np.array([], dtype=int)
            inducing = np.sort(np.concatenate([chosen, rest]).astype(int))
            info["truncated_cholesky_k"] = k_trunc
        elif strategy in ("rank_k_lev_scores", "rank_k_lev_scores_custom"):
            lev = pc.rank_k_leverage_scores(spec, cache, k)
            p = lev / lev.sum()
            inducing = np.sort(rng.choice(n_Fcols, size=k, replace=False, p=p))
        else:  # lev_scores / inverse_lev / lev_random
            # with energy constraints the scores come from the force block
            lev, order = pc.leverage_scores(spec, cache, lam, n_inducing_pts,
                                            rng)
            inducing = pc.select_by_leverage(strategy, lev, order, k, rng)

        if inducing.shape != (k,):
            raise RuntimeError("incorrect number of inducing points")
        P = pc.nystrom_preconditioner(
            spec, cache, inducing, lam, use_E_cstr=use_E_cstr,
            method=str(task.get("nystrom_method", "chol_host")),
            rank_tol=float(task.get("rank_tol", 1e-10)),
            apply_impl=apply_impl,
            block_cols=(int(task["nystrom_block_cols"])
                        if task.get("nystrom_block_cols") else None),
        )
        info["nystrom"] = P.info

    else:
        raise NotImplementedError(f"str_preconditioner = {strategy!r}")

    info["total_time_preconditioner"] = time.perf_counter() - t0
    info["total_time_cholesky"] = info["total_time_preconditioner"]
    return P, inducing, info


def compute_precon_spectrum(spec, cache, P_apply=None) -> np.ndarray:
    """Eigenvalues of P^-1 (K + lam I), sorted real parts: the
    preconditioner-quality diagnostic (reference dev_utils.py:8-58
    materializes the operator column by column).  Dense, on the cache's
    device; the preconditioner is applied to one column at a time, as its
    applies take vectors."""
    A = knl.assemble_full(spec, cache, add_ridge=float(cache.lam))
    if P_apply is not None:
        A = torch.stack([P_apply(col) for col in A.T], dim=1)
    return np.sort(torch.linalg.eigvals(A).real.cpu().numpy())


def _square_matvec_wins(spec: DescriptorSpec, cache: knl.KernelCache) -> bool:
    """Pick the square all-pairs matvec when the packed layout's dense
    incidence-matrix contractions dominate: they cost ~N D 3A operations per
    iteration against the square layout's ~N P A^2 12 elementwise ones, a
    ratio of ~(A - 1) / (4 P).  The square layout also holds
    (N P, A, A, 3) f64 fields, which must stay under 4 GB."""
    N, A, P = cache.n_train, spec.n_atoms, cache.n_perms
    sq_bytes = (2 * N * P * A * A * 3 + 2 * N * P * A * A) * 8
    return A >= 64 * P and sq_bytes < int(4e9)


def _matvec_for(task: dict, cache: knl.KernelCache, use_E_cstr: bool):
    """(matvec, exact_matvec) of the solve by ``task["matvec_dtype"]``:
    exact_matvec is the f64 operator of residual replacement (None: no
    replacement).  The preconditioner was built from the f64 cache in every
    case."""
    mv = knl.matvec_psd_ecstr if use_E_cstr else knl.matvec_psd
    f64 = functools.partial(mv, cache)
    matvec_dtype = str(task.get("matvec_dtype", "float64"))
    if matvec_dtype == "float32":
        # the three products on f32 operands (TF32 off); without residual
        # replacement the ~5e-7 matvec error drifts the recursive residual
        # and fakes convergence
        log.info("matvec: float32 products, f64 residual replacement")
        return functools.partial(mv, knl.downcast_cache(cache)), f64
    if matvec_dtype in ("ozaki", "mixed") and use_E_cstr:
        log.info("matvec: %r has no energy-constrained form; the f64 "
                 "matvec, as in the JAX package", matvec_dtype)
        return f64, None
    if matvec_dtype == "ozaki":
        # f64-grade exact-slice products, inside the lam-floor bound;
        # residual replacement stays on as a backstop unless the task
        # turns it off
        exact = f64 if task.get("residual_replacement", True) else None
        log.info("matvec: ozaki exact-slice products%s",
                 ", f64 residual replacement" if exact is not None else "")
        return functools.partial(knl.matvec_psd_ozaki,
                                 knl.ozaki_matvec_state(cache)), exact
    if matvec_dtype == "mixed":
        # ~1e-7-grade; the JAX package measured divergence where the
        # spectrum reaches the ridge floor (calibrated ethanol, n = 31,482:
        # residual 3500x ||b|| by iteration 50), so it is an option only
        log.info("matvec: mixed precision (centred f32 products, f64 chunk "
                 "sums), f64 residual replacement")
        return functools.partial(knl.matvec_psd_mixed, cache), f64
    return f64, None


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
    svd_cache: dict | None = None,
) -> IterativeResult:
    """Train alphas by PCG (reference Iterative.solve,
    iterative_solver.py:620-1108)."""
    _check_task(task)
    use_E_cstr = bool(task.get("use_E_cstr", False))
    if use_E_cstr:
        knl.require_pairwise(cache)
        if flag_eigvals:
            # the JAX package assembles the force-only K there but applies
            # the (n + N) preconditioner to its columns, and crashes
            raise ValueError(
                "flag_eigvals has no energy-constrained form: the spectrum "
                "diagnostic assembles the force-only (n, n) kernel")
    t_start = time.perf_counter()
    rng = np.random.default_rng(seed)
    n = cache.n + (cache.n_train if use_E_cstr else 0)
    n_train = cache.n_train
    dim_i = spec.dim_i
    lam = float(cache.lam)
    dev = cache.device

    # warm start from a previous model (resume path, reference :644-646)
    alphas0 = None
    num_iters0 = int(task.get("solver_iters", 0) or 0)
    if task.get("alphas0_F") is not None:
        alphas0 = -np.asarray(task["alphas0_F"])  # reference convention
        if use_E_cstr and task.get("alphas0_E") is not None:
            alphas0 = np.hstack([alphas0, -np.asarray(task["alphas0_E"])])

    if break_percentage is None:
        n_inducing_pts = min(n_train, int(task.get("n_inducing_pts_init", 25)))
        k = n_inducing_pts * dim_i
    else:
        n_inducing_pts = int(max(np.ceil(break_percentage * n_train), 1))
        k = int(break_percentage * n)
    k = max(1, min(k, n))

    P_apply, inducing, info_pc = build_preconditioner(
        spec, cache, str_preconditioner, k, lam, rng,
        task=task, svd_cache=svd_cache, n_inducing_pts=n_inducing_pts,
    )
    log.info(
        "preconditioner '%s' built: k=%d (%.1f%% of n=%d) in %.2fs",
        str_preconditioner, k, 100.0 * k / n, n,
        info_pc["total_time_preconditioner"],
    )
    info = dict(info_pc)
    if flag_eigvals:
        info["eigvals"] = compute_precon_spectrum(spec, cache, P_apply)
        info["eigvals_K"] = compute_precon_spectrum(spec, cache, None)

    matvec, exact_matvec = _matvec_for(task, cache, use_E_cstr)
    info["matvec_impl"] = "packed"
    impl = str(task.get("matvec_impl", "auto"))
    # the square layout has no energy-constrained form (nor in the JAX
    # package): energy constraints keep the packed matvec, also when forced
    if not use_E_cstr and (impl == "square" or (
            impl == "auto" and _square_matvec_wins(spec, cache))):
        # large-A molecules: the square all-pairs layout replaces the dense
        # incidence-matrix products (ops.kernel.SquareCache), whatever
        # matvec_dtype chose; its residual replacement stays (JAX rule)
        sq = knl.build_cache_square(
            np.asarray(task["R_train"], dtype=np.float64),
            np.asarray(task.get("perms", np.arange(spec.n_atoms)[None])),
            cache.sig, lam, device=dev)
        matvec = functools.partial(knl.matvec_psd_square, sq)
        info["matvec_impl"] = "square"
        log.info("matvec: square all-pairs layout (A=%d)", spec.n_atoms)

    maxiter = 3 * spec.n_atoms * n_train * 5 if not flag_eigvals else 10
    if task.get("solver_maxiter"):
        # explicit cap (probing / budgeted runs); reference semantics keep
        # the unconverged iterate (train.py:892-908).  flag_eigvals keeps
        # its 10-iteration diagnostic cap (iterative_solver.py:1002).
        maxiter = min(maxiter, int(task["solver_maxiter"])) if flag_eigvals \
            else int(task["solver_maxiter"])

    def ckpt(x_np, iters, resid):
        if save_progr_callback is not None:
            save_progr_callback(alphas_psd=x_np, num_iters=iters, resid=resid,
                                inducing_pts_idxs=inducing)

    y_dev = torch.as_tensor(np.asarray(y), dtype=torch.float64, device=dev)
    x0 = (torch.as_tensor(alphas0, dtype=torch.float64, device=dev)
          if alphas0 is not None else None)
    num_restarts = 0
    idxs_ordered_by_lev_score = None
    it0_initial = num_iters0  # maxiter budgets TOTAL new iterations across restarts
    while True:
        result = pcg(
            matvec, y_dev, precon=P_apply, x0=x0,
            tol=float(task.get("solver_tol", 1e-4)),
            maxiter=max(0, maxiter - (num_iters0 - it0_initial)),
            callback=callback, checkpoint_callback=ckpt,
            it0=num_iters0,
            break_on_stagnation=allow_restarts,
            exact_matvec=exact_matvec,
        )
        if result.num_iters - it0_initial >= maxiter:
            break
        if (not result.stagnated or not allow_restarts
                or n_inducing_pts >= n_train):
            break

        # adaptive restart: grow the inducing set and rebuild, warm-starting
        # from the current iterate (reference iterative_inpoints.py:1011-1066)
        num_restarts += 1
        n_inducing_pts = min(
            n_inducing_pts + (5 if result.eff <= 50 else 1), n_train)
        if (num_restarts == 1 or num_restarts % 10 == 0
                or idxs_ordered_by_lev_score is None):
            _, idxs_ordered_by_lev_score = pc.leverage_scores(
                spec, cache, lam, n_inducing_pts, rng,
                idxs_ordered_by_lev_score=idxs_ordered_by_lev_score,
            )
        dim_m = n_inducing_pts * dim_i
        inducing = np.sort(idxs_ordered_by_lev_score[-dim_m:])
        # rebuild with the SAME configuration as the initial build: a
        # restart must not silently change preconditioner semantics
        P_apply = pc.nystrom_preconditioner(
            spec, cache, inducing, lam, use_E_cstr=use_E_cstr,
            method=str(task.get("nystrom_method", "chol_host")),
            rank_tol=float(task.get("rank_tol", 1e-10)),
            apply_impl=str(task.get("apply_impl", "xla")),
        )
        x0 = torch.as_tensor(result.x, dtype=torch.float64, device=dev)
        num_iters0 = result.num_iters
        log.info("CG restart %d: inducing points -> %d", num_restarts,
                 n_inducing_pts)

    info.update({
        "is_conv": result.converged,
        "total_time_cg": result.time_s,
        "total_time_solve": time.perf_counter() - t_start,
        "num_restarts": num_restarts,
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
