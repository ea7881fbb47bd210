"""Matrix-free pivoted incomplete Cholesky on the cache's device.

PyTorch port of ``mlff_tpu.solvers.pivoted_cholesky`` (reference:
sgdml/solvers/incomplete_cholesky.py:24-93 and its caller,
iterative_cholesky.py:115-156).  Three factorizations of (K + lam I):

  * ``pivoted_cholesky``: the exact greedy loop, largest remaining diagonal
    first, so the pivot order (and with it the preconditioner's quality and
    the CG iteration count) matches the reference up to rounding.  Columns
    come from direct assembly (``ops.kernel.kernel_column``), not from a
    unit-vector matvec.  The loop is a Python loop whose steps are queued on
    the device: the pivot stays a device tensor, nothing is read back per
    step, and whether every pivot was positive is checked once afterwards.
  * ``panel_pivoted_cholesky``: each round takes the ``block`` largest
    residual diagonals as candidates, Schur-corrects their columns with one
    product, and lets LAPACK's pivoted Cholesky (``dpstrf``, on the host; the
    block is at most ``block`` x ``block``) order them against each other.
  * ``block_rp_cholesky``: blocked randomly-pivoted Cholesky, pivots drawn in
    proportion to the residual diagonal (cf. arXiv:2410.03969).

Large-D molecules take their columns and diagonal from the inflation-free
compressed routes of ``ops.kernel``.  With ``use_E_cstr`` each factorizes the
energy-constrained system (n + N rows; reference
iterative_cholesky.py:351-373): force columns are assembled as before, energy
columns are read from the dense (n, N) and (N, N) energy blocks, which each
build assembles once.

On a row-sharded cache (``parallel.mesh.shard_cache``) each factorization
keeps this rank's rows of L and returns the global pivots and residual
diagonal on every rank.  The greedy loop picks its pivot on the global
residual diagonal (an all-gather of every rank's (max, index), ties to the
lowest index as ``torch.argmax`` breaks them) and broadcasts the pivot's row
of L from its owner; the panel and block-RP variants rank their candidates
on the all-gathered diagonal, with the same generator on every rank.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import scipy.linalg
import torch

from ..ops import kernel as knl
from ..ops.descriptor import DescriptorSpec
from ..utils.log import get_logger

log = get_logger(__name__)


class PivotedCholeskyResult(NamedTuple):
    L: torch.Tensor               # (n, k) low-rank factor (this rank's rows)
    pivots: torch.Tensor          # (k,) chosen column indices (pivot order)
    pivot_values: torch.Tensor    # (k,) diagonal value at each pivot
    remaining_diag: torch.Tensor  # (n,) residual diagonal after k steps


def _take(layout, t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[idx] at global rows, gathered from their owners when sharded."""
    return t[idx] if layout is None else layout.take(t, idx)


def _whole(layout, v: torch.Tensor) -> torch.Tensor:
    """A row-sharded vector gathered whole (the vector itself unsharded)."""
    return v if layout is None else layout.gather(v)


def _seed_diag(spec: DescriptorSpec, cache: knl.KernelCache, diag,
               use_E_cstr: bool = False):
    if diag is None:
        return (knl.kernel_diag_ecstr(spec.dim_i, cache) if use_E_cstr
                else knl.kernel_diag_any(spec, cache))
    return torch.as_tensor(diag, dtype=torch.float64, device=cache.device)


def _column_assembler(spec: DescriptorSpec, cache: knl.KernelCache,
                      use_E_cstr: bool):
    """The batched column assembly of the block builders: (n, b) force
    columns, or with ``use_E_cstr`` (n + N, b) columns of the extended
    system, its energy blocks assembled once here for every round."""
    if not use_E_cstr:
        return lambda idx: knl.assemble_columns(spec, cache, idx)
    blocks = knl.assemble_ecstr_blocks(spec.dim_i, cache)
    return lambda idx: knl.assemble_columns_ecstr_any(spec, cache, idx,
                                                      blocks=blocks)


def _greedy_loop(diag0: torch.Tensor, max_rank: int,
                 getcol, layout=None) -> PivotedCholeskyResult:
    """The greedy loop over the columns ``getcol(p)`` of (K + lam I), p a
    (1,) index tensor.  Every step is queued on the device without a host
    read: the pivot stays a device tensor throughout.  ``layout``: diag0
    and the columns are this rank's rows of a sharded system (module
    docstring)."""
    n = diag0.shape[0]
    dev, dtype = diag0.device, diag0.dtype
    L = torch.zeros((n, max_rank), dtype=dtype, device=dev)
    diag = diag0.clone()
    chosen = torch.zeros(n, dtype=torch.bool, device=dev)
    pivots = torch.zeros(max_rank, dtype=torch.int64, device=dev)
    pvals = torch.zeros(max_rank, dtype=dtype, device=dev)
    if max_rank == 0:
        return PivotedCholeskyResult(L, pivots, pvals, _whole(layout, diag))

    # numerical-rank floor: pivots this far below the initial diagonal scale
    # are roundoff; emit a zero column instead of dividing by ~0 (the caller
    # still sees the raw pivot values for PSD validation)
    top = torch.max(diag0)
    if layout is not None:
        top = layout.shard.all_reduce(top, op=torch.distributed.ReduceOp.MAX)
    eps_floor = top * 1e-30
    neg_inf = torch.full((), -torch.inf, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)

    for m in range(max_rank):
        # greedy pivot: largest remaining diagonal among unchosen columns
        if layout is None:
            p = torch.argmax(torch.where(chosen, neg_inf, diag)).reshape(1)
            pval = diag[p]                                # (1,)
        else:
            p, pval = layout.argmax(torch.where(chosen, neg_inf, diag))
        ok = pval > eps_floor
        l_mm = torch.sqrt(torch.maximum(pval, eps_floor))

        col = getcol(p)                                   # includes +lam e_p

        # Schur correction from the m filled columns: one (n, m) x (m,) GEMV
        newcol = col
        if m:
            newcol = col - L[:, :m] @ _take(layout, L[:, :m], p)[0]
        newcol = newcol / l_mm
        # rows of already-chosen pivots are exactly zero in the true factor
        newcol = torch.where(chosen, zero, newcol)
        if layout is None:
            newcol[p] = l_mm
        else:
            layout.set_at(newcol, p, l_mm)
        newcol = torch.where(ok, newcol, zero)

        L[:, m] = newcol
        diag = diag - newcol**2
        if layout is None:
            chosen.index_fill_(0, p, True)
        else:
            layout.set_at(chosen, p, torch.ones(1, dtype=torch.bool,
                                                device=dev))
        pivots[m:m + 1] = p
        pvals[m:m + 1] = pval
    return PivotedCholeskyResult(L, pivots, pvals, _whole(layout, diag))


def _pivoted_cholesky_device(
    spec_dim_i: int,
    cache: knl.KernelCache,
    diag0: torch.Tensor,
    max_rank: int,
    compressed: bool = False,
) -> PivotedCholeskyResult:
    """The greedy loop over (K + lam I).  ``compressed`` takes the columns
    from ``kernel_column_compressed`` (large D)."""
    getcol = knl.kernel_column_compressed if compressed else knl.kernel_column
    cc = knl._col_side(cache)            # gathered once on a sharded cache
    return _greedy_loop(diag0, max_rank,
                        lambda p: getcol(spec_dim_i, cache, p, cc),
                        knl.vector_layout(cache))


def _pivoted_cholesky_device_ecstr(
    spec_dim_i: int,
    cache: knl.KernelCache,
    diag0: torch.Tensor,
    K_fe: torch.Tensor,      # (n, N) dense energy-constraint cross block
    K_ee: torch.Tensor,      # (N, N) dense energy-constraint block
    max_rank: int,
) -> PivotedCholeskyResult:
    """The greedy loop over the energy-constrained extended system
    (n + N,): force columns are assembled matrix-free as in the plain loop,
    energy columns are reads of the dense energy blocks.  The pivot stays a
    device tensor, so both candidates are formed and the pivot's kind picks
    one (the JAX package branches with ``lax.cond``; the column is the
    same)."""
    n_f = cache.n_global
    cc = knl._col_side(cache)
    layout = knl.vector_layout(cache, use_E_cstr=True)
    # a force column's energy rows: row pf of K_fe (its owner's), at this
    # cache's energy rows
    e_rows = slice(cache.row0, cache.row0 + cache.n_train)
    f_layout = knl.vector_layout(cache)

    def getcol(p):
        pf = torch.clamp(p, max=n_f - 1)                  # as a force column
        col_f = torch.cat([knl.kernel_column(spec_dim_i, cache, pf, cc),
                           _take(f_layout, K_fe, pf)[0][e_rows]])
        j = torch.clamp(p - n_f, min=0)                   # as an energy column
        col_e = torch.cat([K_fe[:, j][:, 0], K_ee[:, j][:, 0]])
        if layout is None:
            col_e[p] += cache.lam
        else:
            layout.add_at(col_e, p, cache.lam)
        return torch.where(p < n_f, col_f, col_e)

    return _greedy_loop(diag0, max_rank, getcol, layout)


def pivoted_cholesky(
    spec: DescriptorSpec,
    cache: knl.KernelCache,
    max_rank: int,
    diag=None,
    use_E_cstr: bool = False,
) -> tuple[PivotedCholeskyResult, dict]:
    """Rank-``max_rank`` pivoted incomplete Cholesky of (K + lam I).

    The seed diagonal intentionally omits the ridge term, mirroring the
    reference's mixed convention (the diagonal from
    iterative_cholesky._assemble_kernel_mat_diag has no +lam, the extracted
    columns do), so the pivot order is the reference's.  With ``use_E_cstr``
    the factorization runs over the energy-constrained extended system.

    Returns the factor plus an info dict in the reference's
    ``info_cholesky`` schema (incomplete_cholesky.py:86-88).  ``diag``: the
    seed diagonal over this cache's rows.
    """
    t0 = time.perf_counter()
    diag = _seed_diag(spec, cache, diag, use_E_cstr)
    if use_E_cstr:
        K_fe, K_ee = knl.assemble_ecstr_blocks(spec.dim_i, cache)
        res = _pivoted_cholesky_device_ecstr(spec.dim_i, cache, diag, K_fe,
                                             K_ee, max_rank)
        del K_fe, K_ee
    else:
        # large-D molecules: columns without Jacobian inflation
        res = _pivoted_cholesky_device(
            spec.dim_i, cache, diag, max_rank,
            compressed=knl._is_large_D(spec, cache.n_perms))
    # the first host read since the loop began; it also waits for the device
    min_pivot = float(res.pivot_values.min()) if max_rank > 0 else float("inf")
    elapsed = time.perf_counter() - t0
    if not min_pivot > 0:  # also catches NaN
        raise ValueError(
            f"matrix is not PSD: pivot value {min_pivot:.3e} encountered")
    pivots = res.pivots.cpu().numpy()
    info = {
        "time_cholesky": np.full(max_rank, elapsed / max(max_rank, 1)),
        "L.shape": tuple(res.L.shape),
        "index_columns": _full_index_order(pivots,
                                           res.remaining_diag.shape[0]),
        "pivots": pivots,
        "remaining_diag_error": float(torch.linalg.norm(res.remaining_diag,
                                                        ord=1)),
        "min_pivot": min_pivot,
        "total_time_cholesky_s": elapsed,
    }
    return res, info


def _add_ridge(cols: torch.Tensor, idx: torch.Tensor, lam: float,
               layout=None):
    """cols[idx[j], j] += lam: the ridge on the assembled columns' own rows
    (their owners' rows when sharded)."""
    if layout is not None:
        return layout.add_at(cols, idx, lam)
    cols[idx, torch.arange(idx.shape[0], device=cols.device)] += lam
    return cols


def _block_info(res: PivotedCholeskyResult, pivots: np.ndarray,
                diag_host: np.ndarray, chosen: np.ndarray, elapsed: float,
                block: int) -> dict:
    n_piv = max(len(pivots), 1)
    return {
        "time_cholesky": np.full(n_piv, elapsed / n_piv),
        "L.shape": tuple(res.L.shape),
        "index_columns": _full_index_order(pivots, len(diag_host)),
        "pivots": pivots,
        "remaining_diag_error": float(np.abs(diag_host[~chosen]).sum()),
        "min_pivot": float(res.pivot_values.min()) if len(pivots)
        else float("inf"),
        "total_time_cholesky_s": elapsed,
        "block": block,
    }


def _block_result(L, pivots_all, pvals_all, diag_host, dev):
    pivots = np.concatenate(pivots_all) if pivots_all else np.zeros(0, int)
    pvals = np.concatenate(pvals_all) if pvals_all else np.zeros(0)
    res = PivotedCholeskyResult(
        L=L,
        pivots=torch.as_tensor(pivots, dtype=torch.int64, device=dev),
        pivot_values=torch.as_tensor(pvals, dtype=torch.float64, device=dev),
        remaining_diag=torch.as_tensor(diag_host, dtype=torch.float64,
                                       device=dev),
    )
    return res, pivots


def block_rp_cholesky(
    spec: DescriptorSpec,
    cache: knl.KernelCache,
    max_rank: int,
    block: int = 128,
    seed: int = 0,
    diag=None,
    use_E_cstr: bool = False,
) -> tuple[PivotedCholeskyResult, dict]:
    """Blocked randomly-pivoted Cholesky of (K + lam I).

    Each round samples a block of pivots in proportion to the current
    residual diagonal, assembles those columns in one batched call, and
    applies a rank-``block`` update as matrix products: k/block rounds of
    large products in place of k sequential rank-1 steps.  The draws come
    from ``numpy.random.default_rng(seed)``, the residual diagonal is kept
    on the host, so the same seed draws the JAX package's pivots.
    """
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    dev = cache.device
    layout = knl.vector_layout(cache, use_E_cstr)
    diag = _seed_diag(spec, cache, diag, use_E_cstr)
    assemble = _column_assembler(spec, cache, use_E_cstr)
    diag_host = _whole(layout, diag).cpu().numpy().copy()
    n = diag_host.shape[0]

    pivots_all: list[np.ndarray] = []
    pvals_all: list[np.ndarray] = []
    chosen = np.zeros(n, dtype=bool)

    L = torch.zeros((diag.shape[0], max_rank), dtype=diag.dtype, device=dev)
    off = 0
    while off < max_rank:
        b = min(block, max_rank - off)
        probs = np.clip(diag_host, 0.0, None)
        probs[chosen] = 0.0
        total = probs.sum()
        if total <= 0:
            break  # numerically exhausted
        # sample pivots ~ residual diagonal (without replacement)
        idx = rng.choice(n, size=min(b, int((probs > 0).sum())),
                         replace=False, p=probs / total)
        idx = np.sort(idx)
        b = len(idx)
        idx_dev = torch.as_tensor(idx, device=dev)

        cols = assemble(idx)                                 # (n, b), no ridge
        cols = _add_ridge(cols, idx_dev, float(cache.lam), layout)
        Lb = _rp_block_update(L[:, :off], cols, idx_dev, layout)  # (n, b)
        Lb_host_diag = _whole(layout, torch.sum(Lb * Lb, dim=1)).cpu().numpy()
        diag_host = diag_host - Lb_host_diag
        pvals_all.append(np.clip(diag_host[idx] + Lb_host_diag[idx], 0, None))
        pivots_all.append(idx)
        chosen[idx] = True
        L[:, off:off + b] = Lb
        off += b

    res, pivots = _block_result(L[:, :off], pivots_all, pvals_all, diag_host,
                                dev)
    return res, _block_info(res, pivots, diag_host, chosen,
                            time.perf_counter() - t0, block)


def panel_pivoted_cholesky(
    spec: DescriptorSpec,
    cache: knl.KernelCache,
    max_rank: int,
    block: int = 128,
    accept_tol: float = 0.25,
    diag=None,
    use_E_cstr: bool = False,
) -> tuple[PivotedCholeskyResult, dict]:
    """Greedy *panel* pivoted Cholesky of (K + lam I).

    Each round takes the ``block`` largest entries of the residual diagonal
    as candidates (instead of one, like the exact greedy loop of
    ``pivoted_cholesky``), assembles those columns in one batched call,
    Schur-corrects them with a rank-``block`` product, and then lets a host
    LAPACK pivoted Cholesky (``dpstrf``) of the small candidate block order
    the candidates against each other.  Redundant candidates (large diagonal
    but nearly dependent on an earlier pick of the same round) get tiny
    within-block pivots and are dropped rather than accepted: only
    within-block pivots of at least ``accept_tol`` of the round's best are
    kept, the others are ranked again next round.  This cuts the sequential
    depth by the block size and deviates from the exact greedy order only
    through the staleness of the ranking within one round.
    """
    t0 = time.perf_counter()
    dev = cache.device
    layout = knl.vector_layout(cache, use_E_cstr)
    diag = _seed_diag(spec, cache, diag, use_E_cstr)
    assemble = _column_assembler(spec, cache, use_E_cstr)
    diag_host = _whole(layout, diag).cpu().numpy().copy()
    n = diag_host.shape[0]

    pivots_all: list[np.ndarray] = []
    pvals_all: list[np.ndarray] = []
    chosen = np.zeros(n, dtype=bool)
    eps_floor = float(diag_host.max()) * 1e-30

    L = torch.zeros((diag.shape[0], max_rank), dtype=diag.dtype, device=dev)
    off = 0
    while off < max_rank:
        b = min(block, max_rank - off)
        masked = np.where(chosen, -np.inf, diag_host)
        order = np.argsort(masked)[::-1][:b]
        order = order[masked[order] > eps_floor]
        if len(order) == 0:
            break  # numerically exhausted
        idx = np.sort(order)
        idx_dev = torch.as_tensor(idx, device=dev)

        cols = assemble(idx)                                 # (n, b), no ridge
        cols = _add_ridge(cols, idx_dev, float(cache.lam), layout)
        corr = _schur_correct(L[:, :off], cols, idx_dev, layout)  # (n, b)
        A_ss = _take(layout, corr, idx_dev).cpu().numpy()    # (b, b)

        # within-block greedy pivoting on the host: keep the numerically
        # independent prefix, in pivot order
        F, piv, rank, _ = scipy.linalg.lapack.dpstrf(A_ss, lower=1)
        piv = piv - 1                                        # LAPACK is 1-based
        fdiag = np.diagonal(F)[:rank] ** 2
        r = int(np.sum(fdiag >= fdiag[0] * accept_tol)) if rank > 0 else 0
        if rank > 0:
            r = max(r, 1)
        if r == 0:
            break
        perm = piv[:r]
        # Lb = corr[:, perm] tril(F_r)^-T
        Fr_inv = scipy.linalg.solve_triangular(
            np.tril(F[:r, :r]), np.eye(r), lower=True)
        Lb_sumsq = _panel_commit(
            L, corr, torch.as_tensor(perm.astype(np.int64), device=dev),
            torch.as_tensor(Fr_inv, device=dev), off)

        pvals_all.append(np.clip(diag_host[idx[perm]], 0, None))
        diag_host = diag_host - _whole(layout, Lb_sumsq).cpu().numpy()
        pivots_all.append(idx[perm])
        chosen[idx[perm]] = True
        off += r

    res, pivots = _block_result(L[:, :off], pivots_all, pvals_all, diag_host,
                                dev)
    return res, _block_info(res, pivots, diag_host, chosen,
                            time.perf_counter() - t0, block)


def _schur_correct(L: torch.Tensor, cols: torch.Tensor, idx: torch.Tensor,
                   layout=None):
    """cols - L L[idx]^T: rank-k_cur correction of the candidate panel."""
    if L.shape[1] == 0:
        return cols
    return cols - L @ _take(layout, L, idx).T


def _panel_commit(L: torch.Tensor, corr: torch.Tensor, perm: torch.Tensor,
                  Fr_inv: torch.Tensor, off: int) -> torch.Tensor:
    """Commit one panel round: Lb = corr[:, perm] Fr^-T lands in columns
    [off, off + r) of L.  Returns the row sums of squares of Lb."""
    Lb = corr[:, perm] @ Fr_inv.T                           # (n, r)
    L[:, off:off + Lb.shape[1]] = Lb
    return torch.sum(Lb * Lb, dim=1)


def _rp_block_update(L: torch.Tensor, cols: torch.Tensor, idx: torch.Tensor,
                     layout=None):
    """One RPCholesky block step: Schur-correct the sampled columns against
    the current factor and orthonormalize within the block."""
    corr = _schur_correct(L, cols, idx, layout)
    A_ss = _take(layout, corr, idx)                         # (b, b)
    # small relative jitter keeps the in-block factorization finite when the
    # sampled block is (nearly) rank-deficient; rejected directions then
    # contribute ~zero columns
    scale = torch.clamp(torch.max(torch.abs(torch.diagonal(A_ss))), min=1e-300)
    F, _ = torch.linalg.cholesky_ex(
        A_ss + (scale * 1e-12) * torch.eye(A_ss.shape[0], dtype=A_ss.dtype,
                                           device=A_ss.device))
    return torch.linalg.solve_triangular(F, corr.T, upper=False).T


def _full_index_order(pivots: np.ndarray, n: int) -> np.ndarray:
    """Pivot order extended to a full permutation of [0, n): the reference's
    ``index_columns`` (chosen pivots first, remaining columns after, in the
    swap order its in-place algorithm leaves them)."""
    index_columns = np.arange(n)
    position = np.arange(n)          # position[c] = where column c sits now
    for m, p in enumerate(np.asarray(pivots).tolist()):
        j = position[p]
        c = index_columns[m]
        index_columns[m], index_columns[j] = p, c
        position[p], position[c] = m, j
    return index_columns
