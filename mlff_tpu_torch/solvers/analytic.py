"""Closed-form solver: dense Cholesky with LU and least-squares fallbacks.

PyTorch port of ``mlff_tpu.solvers.analytic`` (reference:
sgdml/solvers/analytic.py:47-208).  The kernel is assembled and factorized
on the cache's device in f64.

Conventions: PSD system (K + reg I) alpha_psd = y with the reference's fixed
reg = 1e-10 (analytic.py:136 subtracts 1e-10 on the negative-definite K).
The returned alphas are in the PSD convention; the model boundary flips sign
(alphas_ref = -alphas_psd).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kernel as knl
from ..ops.descriptor import DescriptorSpec
from ..utils.log import get_logger

log = get_logger(__name__)

ANALYTIC_REG = 1e-10  # reference analytic.py:136


def _lstsq(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least-squares solution through the SVD pseudo-inverse,
    singular values cut at machine epsilon times the largest (what
    ``rcond=-1`` asks of LAPACK's gelsd in the JAX package)."""
    return torch.linalg.pinv(A, rtol=float(np.finfo(np.float64).eps)) @ y


def solve_analytic(
    spec: DescriptorSpec,
    cache: knl.KernelCache,
    y: np.ndarray,
    reg: float = ANALYTIC_REG,
    return_K: bool = False,
    use_E_cstr: bool = False,
    cprsn_keep_atoms_idxs: np.ndarray | None = None,
):
    """Solve (K + reg I) alpha = y densely.  Returns alpha (PSD convention,
    a NumPy array), optionally also the assembled PSD kernel (NumPy).

    With ``cprsn_keep_atoms_idxs`` the kernel is compressed along symmetric
    degrees of freedom: only the partials of the kept atoms form columns and
    the (n, m) system is solved by least squares
    (reference analytic.py:58-76, 183-193).  With ``use_E_cstr`` the dense
    system is the energy-constrained one, (n + N, n + N).
    """
    y_dev = torch.as_tensor(np.asarray(y), dtype=torch.float64,
                            device=cache.device)
    if cprsn_keep_atoms_idxs is not None:
        n_train = cache.n_train
        dim_i = spec.dim_i
        keep_lin = (
            np.arange(dim_i).reshape(spec.n_atoms, 3)[cprsn_keep_atoms_idxs]
        ).ravel()
        col_idxs = (keep_lin[:, None] + np.arange(n_train) * dim_i).T.ravel()
        K = knl.assemble_columns(spec, cache, np.sort(col_idxs))
        alphas = _lstsq(K, y_dev)
    else:
        K = (knl.assemble_full_ecstr(spec, cache) if use_E_cstr
             else knl.assemble_full(spec, cache))
        # the ridge goes onto the diagonal of one f64 copy of K (K itself
        # unless it is returned): no dense identity, the same bits as
        # K + reg * I
        A = K.clone() if return_K else K
        A.diagonal().add_(reg)
        L, info = torch.linalg.cholesky_ex(A)
        if int(info) == 0:
            # cholesky_solve takes a column-major copy of L: free A first,
            # so that two (n, n) arrays are alive at a time, not three
            del A
            if not return_K:
                del K
            alphas = torch.cholesky_solve(y_dev[:, None], L)[:, 0]
        else:
            log.warning("Cholesky failed; falling back to LU solve")
            alphas, info = torch.linalg.solve_ex(A, y_dev)
            if int(info) != 0 or not bool(torch.isfinite(alphas).all()):
                log.warning("LU failed; falling back to least squares")
                alphas = _lstsq(A, y_dev)
    alphas = alphas.cpu().numpy()
    if return_K:
        return alphas, K.cpu().numpy()
    return alphas
