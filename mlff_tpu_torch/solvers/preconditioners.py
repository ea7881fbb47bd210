"""Nyström preconditioner with leverage-score column selection.

PyTorch port of the main slice of ``mlff_tpu.solvers.preconditioners``
(reference: sgdml/solvers/iterative_solver.py:447-552, 672-807):

  * column selection: 'random_scores', 'lev_scores', 'inverse_lev',
    'lev_random' (NumPy ``Generator`` draws identical to the JAX package's),
  * the split Nyström factorization B = K_nm W1, W2 W2^T = (B^T B + lam I)^-1
    with both m x m decompositions in host LAPACK (scipy),
  * the Woodbury apply through the SPLIT factors (B, W2), never a fused
    T = W2^T B^T: the fused product freezes its rounding noise, amplified by
    ||W2|| ~ lam^-1/2, into the operator and made P^-1 indefinite at n = 75k
    (see ``mlff_tpu.solvers.preconditioners.WoodburySplitPreconditioner``).

All builders work in the PSD convention (K + lam*I).  Not in this module yet
(each raises NotImplementedError naming its ROADMAP item): the column-blocked
factor, the fused-Cholesky method, energy constraints, and the df64 / ozaki
apply engines.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import scipy.linalg
import torch

from ..ops import kernel as knl
from ..ops.descriptor import DescriptorSpec
from ..utils.log import get_logger

log = get_logger(__name__)


@dataclass
class WoodburySplitPreconditioner:
    """Woodbury apply through the split factors B (n, m) and W2 (m, m):

        P^-1 v = lam^-1 (v - B W2 (W2^T (B^T v)))

    The frozen operator is the exact symmetric contraction B W2 W2^T B^T;
    per-apply rounding is fresh, unamplified noise that PCG absorbs.  B is
    padded with zero columns (and W2 with zero rows/cols) to a multiple of
    128, which is inert in the apply.

    ``info`` carries the build's diagnostics: whether the Gram guard fired,
    its probe error and the stage times.
    """

    B: torch.Tensor    # (n, m) whitened columns
    W2: torch.Tensor   # (m, m) inner inverse-sqrt factor
    lam: float
    info: dict

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return woodbury_split_apply(self, v)


def woodbury_split_apply(P: WoodburySplitPreconditioner,
                         v: torch.Tensor) -> torch.Tensor:
    """lam^-1 (v - B W2 W2^T B^T v): two skinny (n, m) passes (DGEMV) and
    two small (m, m) ones."""
    u = P.B.T @ v                      # (m,)  == B^T v
    x = P.W2 @ (P.W2.T @ u)            # (m,)
    return (v - P.B @ x) / P.lam


def _pad_split(B: torch.Tensor, W2: torch.Tensor):
    """Pad B (n, m) with zero columns and W2 (m, m) with zero rows/cols to a
    multiple of 128 (inert in the split apply)."""
    m = B.shape[1]
    m_pad = -(-m // 128) * 128
    if m_pad == m:
        return B, W2
    Bp = torch.zeros((B.shape[0], m_pad), dtype=B.dtype, device=B.device)
    Bp[:, :m] = B
    Wp = torch.zeros((m_pad, m_pad), dtype=W2.dtype, device=W2.device)
    Wp[:m, :m] = W2
    return Bp, Wp


def _unpack_sym(packed: np.ndarray, m: int) -> np.ndarray:
    """Packed lower triangle -> full symmetric (m, m) on host."""
    M = np.zeros((m, m), dtype=packed.dtype)
    il = np.tril_indices(m)
    M[il] = packed
    M = M + M.T
    M[np.diag_indices(m)] /= 2.0
    return M


def _host_sym(M_dev: torch.Tensor) -> np.ndarray:
    """Device (m, m) -> host symmetric matrix built from its lower
    triangle (what the JAX package's packed d2h transfer hands LAPACK)."""
    M = M_dev.cpu().numpy()
    m = M.shape[0]
    return _unpack_sym(M[np.tril_indices(m)], m)


def _host_whiten_factor(M: np.ndarray, rank_tol: float, host_decomp: str):
    """Host-LAPACK W with W^T M W ~ I (pseudo-inverse whitening).

    'eigh': V diag(w^-1/2) with eigenvalues clamped at rank_tol * w_max.
    'chol': L^-T from a deterministic escalating-jitter Cholesky of
      M + j*I, j = rank_tol * diag_max * 4^i.
    """
    m = M.shape[0]
    if host_decomp == "eigh":
        w1, V1 = scipy.linalg.eigh(M, driver="evd", overwrite_a=True)
        tol1 = max(w1[-1], 0.0) * rank_tol
        wi = np.where(w1 > tol1, 1.0 / np.sqrt(np.maximum(w1, tol1)), 0.0)
        return V1 * wi[None, :]
    j0 = float(np.abs(np.diagonal(M)).max()) * rank_tol
    for i in range(16):
        try:
            L = scipy.linalg.cholesky(
                M + (j0 * 4.0**i) * np.eye(m), lower=True)
        except scipy.linalg.LinAlgError:
            continue
        if i:
            log.info("whiten chol: jitter escalated to %.1e rel",
                     rank_tol * 4.0**i)
        return scipy.linalg.lapack.dtrtri(L, lower=1)[0].T
    raise np.linalg.LinAlgError("whiten chol failed to regularize")


def _host_inner_isqrt(inner: np.ndarray, lam: float, host_decomp: str):
    """Host-LAPACK W2 with W2 W2^T ~ (inner + lam I)^-1.

    'eigh': V diag((max(w,0)+lam)^-1/2) — exact pseudo-inverse scaling.
    'chol': L^-T of inner + (lam + j) I with the ladder j = lam * 4^i."""
    m = inner.shape[0]
    if host_decomp == "eigh":
        w2, V2 = scipy.linalg.eigh(inner, driver="evd", overwrite_a=True)
        return V2 * (1.0 / np.sqrt(np.maximum(w2, 0.0) + lam))[None, :]
    for i in range(16):
        j = 0.0 if i == 0 else lam * 4.0 ** (i - 1)
        try:
            L = scipy.linalg.cholesky(
                inner + (lam + j) * np.eye(m), lower=True)
        except scipy.linalg.LinAlgError:
            continue
        if i:
            log.info("inner chol: extra jitter escalated to %.1e", j)
        return scipy.linalg.lapack.dtrtri(L, lower=1)[0].T
    raise np.linalg.LinAlgError("inner chol failed to regularize")


def _nystrom_factor_split(
    K_nm: torch.Tensor, inducing_idxs: np.ndarray, lam: float,
    rank_tol: float, host_decomp: str = "eigh",
) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Split Nyström factorization (B (n, m), W2 (m, m), info) with
    B = K_nm W1 and W2 W2^T = (B^T B + lam I)^+.

    SELF-CONSISTENCY IS LOAD-BEARING: the inner matrix is the Gram of the
    stored B itself (``B.T @ B`` of the same tensor), never a congruence
    W1^T (K_nm^T K_nm) W1 evaluated elsewhere.  With lam = 1e-10 the
    (w2 + lam)^-1/2 scaling needs ``inner`` to match B's true Gram to ~lam
    absolute in its small eigenvalues.
    """
    dev = K_nm.device
    m = len(inducing_idxs)
    stages: dict[str, float] = {}
    t = time.perf_counter()

    def mark(label):
        nonlocal t
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        stages[label] = now - t
        t = now

    K_mm = _host_sym(K_nm[torch.as_tensor(inducing_idxs, device=dev)])
    mark("gather_Kmm")
    W1 = torch.as_tensor(_host_whiten_factor(K_mm, rank_tol, host_decomp),
                         dtype=torch.float64, device=dev)
    mark("host_W1")
    B = K_nm @ W1                                    # (n, m)
    inner_dev = B.T @ B                              # Gram of the stored B
    mark("whiten_gram")
    inner = _host_sym(inner_dev)
    # GUARD: inner must match B's true Gram to ~lam ABSOLUTE, or the
    # (w2 + lam)^-1/2 scaling silently stops preconditioning.  Probe the full
    # diagonal and a few random cross entries with independent column dots;
    # on failure recompute the whole Gram on host from the factor.
    rng_p = np.random.default_rng(0)
    ii = np.concatenate([np.arange(m), rng_p.integers(0, m, size=min(8, m))])
    jj = np.concatenate([np.arange(m), rng_p.integers(0, m, size=min(8, m))])
    exact = torch.sum(B[:, torch.as_tensor(ii, device=dev)]
                      * B[:, torch.as_tensor(jj, device=dev)], dim=0)
    probe_err = float(np.abs(inner[ii, jj] - exact.cpu().numpy()).max())
    fired = probe_err > max(0.1 * lam, 1e-12)
    if fired:
        log.warning(
            "device Gram failed the spot check (max abs err %.2e vs lam = "
            "%.0e): recomputing inner on host from the factor (%d x %d)",
            probe_err, lam, B.shape[0], m)
        B_host = B.cpu().numpy()
        inner = B_host.T @ B_host
    mark("gram_probe")
    W2 = torch.as_tensor(_host_inner_isqrt(inner, lam, host_decomp),
                         dtype=torch.float64, device=dev)
    mark("host_W2")
    log.info("nystrom factor stages: %s",
             "  ".join(f"{k} {v:.2f}s" for k, v in stages.items()))
    info = {"gram_guard_fired": bool(fired), "gram_probe_err": probe_err,
            "stages": stages}
    return B, W2, info


def _nystrom_factor_eigh(
    K_nm: torch.Tensor, inducing_idxs: np.ndarray, lam: float,
    rank_tol: float, host_decomp: str = "eigh",
) -> torch.Tensor:
    """Fused factor T = W2^T B^T (m, n) — for leverage scores only; the
    preconditioner apply never materializes it (see module docstring)."""
    B, W2, _ = _nystrom_factor_split(K_nm, inducing_idxs, lam, rank_tol,
                                     host_decomp)
    return (B @ W2).T


def nystrom_preconditioner(
    spec: DescriptorSpec,
    cache: knl.KernelCache,
    inducing_idxs: np.ndarray,
    lam: float,
    use_E_cstr: bool = False,
    method: str = "chol_host",
    rank_tol: float = 1e-10,
    apply_impl: str = "xla",
    block_cols: int | None = None,
) -> WoodburySplitPreconditioner:
    """Nyström preconditioner P = K_nm K_mm^+ K_mn + lam I from a column
    subset, whitened form, applied through the Woodbury identity
    (reference iterative_solver.py:218-254, 370-374).

    ``method``: 'chol_host' (Cholesky + triangular inverse on host, the
    default) or 'eigh' (host eigendecompositions with clamping).
    ``apply_impl``: 'xla' names the plain f64 apply, as in the JAX package.
    """
    if use_E_cstr:
        raise NotImplementedError(
            "energy-constrained columns are ROADMAP module item 10")
    if block_cols is not None:
        raise NotImplementedError(
            "the column-blocked Nystrom factor is ROADMAP module item 9")
    if method not in ("chol_host", "eigh"):
        raise NotImplementedError(
            f"nystrom method {method!r} is ROADMAP module item 9")
    if apply_impl != "xla":
        raise NotImplementedError(
            f"apply_impl {apply_impl!r}: the df64 / ozaki applies are ROADMAP "
            "module item 11 and kernel queue items 2-3")
    inducing_idxs = np.sort(np.asarray(inducing_idxs))
    t0 = time.perf_counter()
    K_nm = knl.assemble_columns(spec, cache, inducing_idxs)   # (n, m) PSD
    if cache.device.type == "cuda":
        torch.cuda.synchronize(cache.device)
    t1 = time.perf_counter()
    B, W2, info = _nystrom_factor_split(
        K_nm, inducing_idxs, lam, rank_tol,
        host_decomp="chol" if method == "chol_host" else "eigh")
    del K_nm
    B, W2 = _pad_split(B, W2)
    info = dict(info, columns_s=t1 - t0,
                factorization_s=time.perf_counter() - t1)
    log.info("nystrom build (%s): columns %.2fs, factorization %.2fs",
             method, info["columns_s"], info["factorization_s"])
    return WoodburySplitPreconditioner(B=B, W2=W2, lam=float(lam), info=info)


def select_random(n: int, k: int, rng: np.random.Generator) -> np.ndarray:
    """'random_scores': uniform column subset (iterative_solver.py:683-686)."""
    return np.sort(rng.choice(n, size=k, replace=False))


def leverage_scores(
    spec: DescriptorSpec,
    cache: knl.KernelCache,
    lam: float,
    n_inducing_pts: int,
    rng: np.random.Generator,
    idxs_ordered_by_lev_score: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Approximate ridge leverage scores for all n columns (reference
    `_lev_scores`, iterative_solver.py:447-552): sample
    m = max(1, n_ind//4)*dim_i columns, and take the column sums-of-squares
    of the Nyström factor T = (B B^T + lam I)^-1/2 B.
    Returns (lev_scores, argsort(lev_scores))."""
    n = cache.n_train * spec.dim_i
    dim_m = max(1, n_inducing_pts // 4) * spec.dim_i

    if idxs_ordered_by_lev_score is None:
        lev_approx_idxs = np.sort(rng.choice(n, size=dim_m, replace=False))
    else:
        if len(idxs_ordered_by_lev_score) != n:
            raise ValueError("idxs_ordered_by_lev_score must cover all n")
        lev_approx_idxs = np.sort(idxs_ordered_by_lev_score[-dim_m:])

    t0 = time.perf_counter()
    K_nm = knl.assemble_columns(spec, cache, lev_approx_idxs)  # (n, m)
    t1 = time.perf_counter()
    T = _nystrom_factor_eigh(K_nm, lev_approx_idxs, lam, rank_tol=1e-10,
                             host_decomp="chol")
    lev = torch.sum(T * T, dim=0).cpu().numpy()
    log.info("lev scores (m=%d): columns %.2fs, factor+scores %.2fs",
             len(lev_approx_idxs), t1 - t0, time.perf_counter() - t1)
    return lev, np.argsort(lev)


def select_by_leverage(
    strategy: str,
    lev: np.ndarray,
    order: np.ndarray,
    k: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Deterministic / inverse / probabilistic leverage-score selection
    (iterative_solver.py:736-753)."""
    if strategy == "lev_scores":
        return np.sort(order[-k:])
    if strategy == "inverse_lev":
        return np.sort(order[:k])
    if strategy == "lev_random":
        p = lev / lev.sum()
        return np.sort(rng.choice(len(lev), size=k, replace=False, p=p))
    raise ValueError(strategy)
