"""Standalone dense prototypes with import-time-style self-tests.

PyTorch port of ``mlff_tpu.experiments.prototypes`` (reference:
src/tools/cholesky.py:6-95 dense pivoted Cholesky with pivot
(un)transforms, src/tools/custom_cg_solver.py:84-158 dense
Woodbury-preconditioned CG, src/tools/gp.py:34-52 RBF GP regression demo,
src/tools/utils.py:161-226 toy kernel builders).  Small dense references,
used as oracles and teaching code; the production implementations live in
``mlff_tpu_torch.solvers``.

Every function takes NumPy arrays or tensors and computes in f64 on
``device`` (``resolve_device``: cuda unless the caller asks for the CPU);
the self-tests draw their inputs from a ``torch.Generator`` seeded on the
CPU.  The reference's bugs are not replicated (stale 2-tuple unpacking at
custom_cg_solver.py:107, ``is not 0`` comparisons at :149), and its
import-time self-tests are the ``selftest_*`` functions.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device


def _f64(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=torch.float64, device=device)


def _dev(x, device) -> torch.device:
    """The device of a computation: ``device`` when given, else a tensor
    argument's own, else ``resolve_device()``."""
    if device is not None or not torch.is_tensor(x):
        return resolve_device(device)
    return x.device


def dense_pivoted_cholesky(A, max_rank: int | None = None, device=None):
    """Outer-product pivoted Cholesky of a dense SPD matrix.

    Returns (L, piv) with A[piv][:, piv] ~= L_tri L_tri^T where
    L_tri = L[piv] is lower triangular (reference cholesky.py:32-77); L is
    a tensor on the device, piv an int64 NumPy array."""
    dev = _dev(A, device)
    A = _f64(A, dev)
    n = A.shape[0]
    if max_rank is None:
        max_rank = n
    diag = torch.diagonal(A).clone()
    L = torch.zeros((n, max_rank), dtype=A.dtype, device=dev)
    chosen = torch.zeros(n, dtype=torch.bool, device=dev)
    piv = []
    for m in range(max_rank):
        p = int(torch.argmax(torch.where(chosen, -torch.inf, diag)))
        if diag[p] <= 0:
            L = L[:, :m]
            break
        piv.append(p)
        lmm = torch.sqrt(diag[p])
        col = A[:, p] - L[:, :m] @ L[p, :m]
        newcol = col / lmm
        newcol[chosen] = 0.0
        newcol[p] = lmm
        L[:, m] = newcol
        diag -= newcol**2
        chosen[p] = True
    return L, np.asarray(piv, dtype=np.int64)


def pivot_transformation(M, piv, inverse: bool = False):
    """(Un)apply a pivot permutation to the rows of M (reference
    cholesky.py pivot/transformation helpers): the pivots first, the other
    rows after in their order."""
    piv = np.asarray(piv)
    order = np.concatenate([piv, np.setdiff1d(np.arange(M.shape[0]), piv)])
    if inverse:
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        order = inv
    if torch.is_tensor(M):
        return M[torch.as_tensor(order, device=M.device)]
    return np.asarray(M)[order]


def init_precond_operator(K, k: int, lam: float, device=None):
    """Woodbury preconditioner from a rank-k pivoted Cholesky of dense K
    (reference custom_cg_solver.py:102-123): a function v -> P^-1 v with
    P = L L^T + lam I."""
    dev = _dev(K, device)
    L, _ = dense_pivoted_cholesky(K, max_rank=k, device=dev)
    G = torch.linalg.cholesky(
        lam * torch.eye(L.shape[1], dtype=L.dtype, device=dev) + L.T @ L)
    T = torch.linalg.solve_triangular(G, L.T, upper=False)

    def apply_inv(v):
        return (v - T.T @ (T @ v)) / lam

    return apply_inv


def solve_linear_system_woodbury(K, y, k: int, lam: float, tol: float = 1e-6,
                                 device=None):
    """Dense-K PCG with the Woodbury preconditioner (reference
    custom_cg_solver.py:126-158), through the port's scipy-semantics PCG:
    (x as a NumPy array, iterations)."""
    from ..solvers.cg import pcg

    dev = _dev(K, device)
    K = _f64(K, dev)
    A = K + lam * torch.eye(K.shape[0], dtype=K.dtype, device=dev)
    res = pcg(lambda v: A @ v, _f64(y, dev),
              precon=init_precond_operator(K, k, lam, device=dev), tol=tol)
    if not res.converged:
        raise RuntimeError("woodbury-preconditioned CG did not converge")
    return res.x, res.num_iters


def rbf_kernel(Xa, Xb, lengthscale: float = 1.0, device=None):
    """Toy RBF kernel matrix (reference utils.py:161-200 kernel builders)."""
    dev = _dev(Xa, device)
    Xa, Xb = _f64(Xa, dev), _f64(Xb, dev)
    d2 = ((Xa[:, None, :] - Xb[None, :, :]) ** 2).sum(-1)
    return torch.exp(-0.5 * d2 / lengthscale**2)


def gp_regression(X_train, y_train, X_query, lengthscale: float = 1.0,
                  noise: float = 1e-6, device=None):
    """Plain GP regression demo (reference gp.py:34-52): posterior mean and
    variance on the query points, as NumPy arrays."""
    dev = _dev(X_train, device)
    K = rbf_kernel(X_train, X_train, lengthscale, device=dev)
    Ks = rbf_kernel(X_query, X_train, lengthscale, device=dev)
    Kss = rbf_kernel(X_query, X_query, lengthscale, device=dev)
    C = torch.linalg.cholesky(
        K + noise * torch.eye(K.shape[0], dtype=K.dtype, device=dev))
    alpha = torch.cholesky_solve(_f64(y_train, dev)[:, None], C)[:, 0]
    mean = Ks @ alpha
    v = torch.cholesky_solve(Ks.T, C)
    var = torch.diagonal(Kss - Ks @ v)
    return mean.cpu().numpy(), var.cpu().numpy()


def condition_number(K, lam: float = 0.0, device=None) -> float:
    """Spectral condition number diagnostic (reference utils.py:203-226)."""
    dev = _dev(K, device)
    K = _f64(K, dev)
    w = torch.linalg.eigvalsh(
        K + lam * torch.eye(K.shape[0], dtype=K.dtype, device=dev))
    return float(w.max() / max(float(w.min()), np.finfo(float).tiny))


def _randn(gen: torch.Generator, *shape, device) -> torch.Tensor:
    return torch.randn(*shape, generator=gen, dtype=torch.float64).to(device)


def selftest_pivoted_cholesky(seed: int = 0, n: int = 40,
                              device=None) -> None:
    """Factor a random SPD matrix and verify the reconstruction and the
    pivot round trip (the reference runs this at import,
    cholesky.py:80-95)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    B = _randn(gen, n, n, device=dev)
    A = B @ B.T + n * torch.eye(n, dtype=B.dtype, device=dev)
    L, piv = dense_pivoted_cholesky(A, device=dev)
    assert torch.linalg.norm(A - L @ L.T) < 1e-8 * torch.linalg.norm(A)
    M = _randn(gen, n, 3, device=dev)
    round_trip = pivot_transformation(pivot_transformation(M, piv), piv,
                                      inverse=True)
    assert torch.equal(round_trip, M)


def selftest_woodbury(seed: int = 1, n: int = 60, device=None) -> None:
    """Woodbury-PCG on a random SPD system (reference
    custom_cg_solver.py:84-99)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    B = _randn(gen, n, n // 2, device=dev)
    K = B @ B.T
    lam = 1e-4
    y = _randn(gen, n, device=dev)
    x, iters = solve_linear_system_woodbury(K, y, k=n // 2, lam=lam,
                                            device=dev)
    x = torch.as_tensor(x, device=dev)
    A = K + lam * torch.eye(n, dtype=K.dtype, device=dev)
    assert torch.linalg.norm(A @ x - y) < 1e-4 * torch.linalg.norm(y)
    assert iters < n  # the preconditioner helps
