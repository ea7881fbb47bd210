"""Matérn-5/2 Hessian force-field kernel: operator cache, matvec, columns.

PyTorch port of the main slice of ``mlff_tpu.ops.kernel`` (reference:
sgdml/train.py:150-236, 1121-1308; sgdml/predict.py:72-234).

Math.  For training descriptors x_i (D,) with compressed Jacobians J_i and a
permutation group acting by descriptor index arrays P (P_perms, D), the PSD
kernel block between training points i, j is

    K[i, j] = Jf_i^T  sum_p  base_p [ (sig^2 + sig*n_p) I - 5 d_p d_p^T ] Jf~_{j,p}

with d_p = x_i - x_j[P_p],  n_p = sqrt(5) ||d_p||,
base_p = 5 exp(-n_p / sig) / (3 sig^4).

The pairwise distance matrix, its exponential and the (1 + dist) weight are
computed once per solve (``KernelCache``); each CG iteration is then three
(N, M) x (M, D) f64 products (cuBLAS DGEMM on the card) plus elementwise
work.  Not in this module yet (each raises NotImplementedError naming its
ROADMAP item): the on-the-fly tiled matvec, the square all-pairs layout, the
large-D compressed column paths, energy constraints, and the mixed/ozaki
precision engines.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from .descriptor import DescriptorSpec, d_desc_dot_vec, vec_dot_d_desc

SQRT5 = math.sqrt(5.0)

# above this (D, 3A, perms) inflation size the JAX package switches to its
# compressed / square column paths (ops/kernel.py _INFLATION_BUDGET)
_INFLATION_BUDGET = int(2e8)


@dataclass
class KernelCache:
    """Per-solve state of the implicit kernel operator, on one device.

    Shapes: N = n_train, P = n_perms, M = N*P, D = descriptor dim,
    A = n_atoms.  Float fields are f64; ``P_idx`` is int64.
    """

    X: torch.Tensor        # (N, D) descriptors
    Jc: torch.Tensor       # (N, D, 3) compressed Jacobians
    S: torch.Tensor        # (D, A) incidence matrix
    P_idx: torch.Tensor    # (P, D) descriptor permutations
    Xq: torch.Tensor       # (N, D) q-scaled descriptors, q = sqrt(5)/sig
    Xqt: torch.Tensor      # (M, D) q-scaled permuted descriptors
    A_exp: torch.Tensor    # (N, M) 5/(3 sig^2) * exp(-dist)
    A_exp1: torch.Tensor   # (N, M) A_exp * (1 + dist)
    sig: float             # kernel length scale
    lam: float             # ridge regularization

    @property
    def n_train(self) -> int:
        return self.X.shape[0]

    @property
    def n_perms(self) -> int:
        return self.P_idx.shape[0]

    @property
    def n(self) -> int:
        """Kernel dimension n = 3 * A * N."""
        return self.S.shape[1] * 3 * self.X.shape[0]

    @property
    def device(self) -> torch.device:
        return self.X.device


def permuted_descriptors(X: torch.Tensor, P_idx: torch.Tensor) -> torch.Tensor:
    """(N, D) -> (N*P, D): row (j*P + p) = X[j, P_idx[p]] (point-major)."""
    return X[:, P_idx].reshape(-1, X.shape[1])


def pairwise_dist_gram(Xq_a: torch.Tensor, Xq_b: torch.Tensor) -> torch.Tensor:
    """Pairwise distances ||a_i - b_j|| via the Gram trick (one matmul)."""
    na = torch.sum(Xq_a * Xq_a, dim=1)
    nb = torch.sum(Xq_b * Xq_b, dim=1)
    g = Xq_a @ Xq_b.T
    d2 = torch.clamp(na[:, None] + nb[None, :] - 2.0 * g, min=0.0)
    return torch.sqrt(d2)


def _f64(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=torch.float64, device=device)


def build_cache(
    X,
    Jc,
    S,
    P_idx,
    sig: float,
    lam: float,
    R=None,
    pairwise: bool = True,
    device=None,
) -> KernelCache:
    """Build the per-solve operator cache on ``device`` (cuda by default).

    ``X`` (N, D), ``Jc`` (N, D, 3), ``S`` (D, A) and ``P_idx`` (P, D) may be
    NumPy arrays or tensors; they are moved to the device as f64 / int64.
    """
    if not pairwise:
        raise NotImplementedError(
            "build_cache(pairwise=False): the on-the-fly tiled matvec is "
            "ROADMAP module item 10")
    if R is not None:
        raise NotImplementedError(
            "build_cache(R=...): the square all-pairs layout is ROADMAP "
            "module item 10")
    dev = resolve_device(device)
    X = _f64(X, dev)
    Jc = _f64(Jc, dev)
    S = _f64(S, dev)
    P_idx = torch.as_tensor(np.asarray(P_idx) if not torch.is_tensor(P_idx)
                            else P_idx, dtype=torch.int64, device=dev)
    sig, lam = float(sig), float(lam)
    q = SQRT5 / sig
    Xq = q * X
    Xqt = permuted_descriptors(Xq, P_idx)
    dist = pairwise_dist_gram(Xq, Xqt)
    A_exp = (5.0 / (3.0 * sig**2)) * torch.exp(-dist)
    A_exp1 = A_exp * (1.0 + dist)
    return KernelCache(X=X, Jc=Jc, S=S, P_idx=P_idx, Xq=Xq, Xqt=Xqt,
                       A_exp=A_exp, A_exp1=A_exp1, sig=sig, lam=lam)


def _desc_forces_x(Xqt, sig, Xq_query, A_exp, A_exp1, wt):
    """Descriptor-space force contraction shared by matvec and prediction:
    three (B, M)-shaped products around the cached exp weights.  Returns
    (F_desc (B, D), E (B,)) in the reference predictor's sign convention.

        dot = Xq_query . wt^T - sum(Xqt * wt)
        F   = Xq_query * sum_m(A_exp * dot) - (A_exp * dot) @ Xqt - A_exp1 @ wt
        E   = sum_m(A_exp1 * dot) / q
    """
    ct = torch.sum(Xqt * wt, dim=1)                         # (M,)
    dot = Xq_query @ wt.T - ct[None, :]                     # (B, M)
    G = A_exp * dot
    F1 = Xq_query * torch.sum(G, dim=1, keepdim=True) - G @ Xqt
    F2 = A_exp1 @ wt
    q = SQRT5 / sig
    E = torch.sum(A_exp1 * dot, dim=1) / q
    return F1 - F2, E


def perm_expand_w(w: torch.Tensor, P_idx: torch.Tensor) -> torch.Tensor:
    """(N, D) -> (N*P, D) permuted copies of per-point descriptor cotangents."""
    return w[:, P_idx].reshape(-1, w.shape[1])


def matvec_ref(cache: KernelCache, v: torch.Tensor) -> torch.Tensor:
    """K_ref @ v, the reference-convention (negative-definite) kernel matvec
    (reference predict.py:997-1110).  v: flat (n,); returns flat (n,)."""
    N = cache.n_train
    A = cache.S.shape[1]
    w = d_desc_dot_vec(cache.Jc, cache.S, v.reshape(N, A, 3))   # (N, D)
    wt = perm_expand_w(w, cache.P_idx)                          # (M, D)
    F_desc, _ = _desc_forces_x(cache.Xqt, cache.sig, cache.Xq, cache.A_exp,
                               cache.A_exp1, wt)
    return vec_dot_d_desc(cache.Jc, cache.S, F_desc).reshape(-1)


def matvec_psd(cache: KernelCache, v: torch.Tensor) -> torch.Tensor:
    """(K + lam*I) @ v in the PSD convention: the CG system operator."""
    return cache.lam * v - matvec_ref(cache, v)


# ---------------------------------------------------------------------------
# Column assembly (Nyström / leverage-score columns)
# ---------------------------------------------------------------------------


def _inflate_full(Jc: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """(..., D, 3) compressed -> (..., D, 3A) full Jacobians."""
    full = S[:, :, None] * Jc[..., :, None, :]      # (..., D, A, 3)
    return full.reshape(*Jc.shape[:-1], -1)


def _group_columns(points: np.ndarray, partials: np.ndarray, g: int):
    """Group requested (point, partial) columns by owning point, padding each
    group to ``g`` slots (points with more than g requested partials split
    into several groups).  Returns (grp_pt (C,), grp_t (C, g) with -1 pads,
    flat_valid (k,) mapping sorted input columns to flattened (C*g) slots)."""
    groups: list[tuple[int, list[int]]] = []
    prev_pt = None
    for p, t in zip(points.tolist(), partials.tolist()):
        if p != prev_pt or len(groups[-1][1]) == g:
            groups.append((p, []))
        prev_pt = p
        groups[-1][1].append(t)
    grp_pt = np.array([p for p, _ in groups], dtype=np.int64)
    grp_t = np.full((len(groups), g), -1, dtype=np.int64)
    flat_valid = []
    for i, (_, ts) in enumerate(groups):
        grp_t[i, : len(ts)] = ts
        flat_valid.extend(i * g + s for s in range(len(ts)))
    return grp_pt, grp_t, np.asarray(flat_valid, dtype=np.int64)


def _columns_jcol(cache: KernelCache, grp_pt: torch.Tensor,
                  grp_t: torch.Tensor) -> torch.Tensor:
    """Permuted compressed Jacobian COLUMNS for the grouped column set:
    jcol[c, s, p, q] = Jc[grp_pt[c]][P[p,q], x] * S[P[p,q], b] for partial
    t = (b, x) = grp_t[c, s]; zero for -1 pads.  Shape (C, g, P, D)."""
    C, g = grp_t.shape
    valid = grp_t >= 0
    t_safe = torch.where(valid, grp_t, 0)
    b = t_safe // 3                                       # (C, g) atom index
    x = t_safe % 3                                        # (C, g) xyz
    J_g = cache.Jc[grp_pt][:, cache.P_idx, :]             # (C, P, D, 3)
    rows = torch.arange(C, device=grp_t.device)[:, None]
    jx = J_g.permute(0, 3, 1, 2)[rows, x]                 # (C, g, P, D)
    S_p = cache.S[cache.P_idx]                            # (P, D, A)
    sb = S_p[:, :, b].permute(2, 3, 0, 1)                 # (C, g, P, D)
    return jx * sb * valid[:, :, None, None]


def _assemble_columns_grouped(
    spec_dim_i: int,
    cache: KernelCache,
    grp_pt: torch.Tensor,    # (C,)
    grp_t: torch.Tensor,     # (C, g) partial indices, -1 pads
    tile: int,
    flat_valid: torch.Tensor,  # (k,) column slots to keep
) -> torch.Tensor:
    """Column-exact assembly: computes ONLY the requested partials, with the
    permutation axis collapsed before the row-side Jacobian is applied —
    O(B C D (3 g P + g 3A)) per row tile of B training points.  Returns the
    (n, k) PSD columns."""
    sig = cache.sig
    N = cache.n_train
    T = spec_dim_i
    jcol = _columns_jcol(cache, grp_pt, grp_t)            # (C, g, P, D)
    X_g = cache.X[grp_pt][:, cache.P_idx]                 # (C, P, D)
    out = torch.empty((N * T, flat_valid.shape[0]), dtype=cache.X.dtype,
                      device=cache.device)
    for start in range(0, N, tile):
        stop = min(start + tile, N)
        X_I = cache.X[start:stop]                         # (B, D)
        Jf_I = _inflate_full(cache.Jc[start:stop], cache.S)  # (B, D, T)
        delta = X_I[:, None, None, :] - X_g[None]         # (B, C, P, D)
        nrm = SQRT5 * torch.linalg.norm(delta, dim=-1)    # (B, C, P)
        base = (5.0 / (3.0 * sig**4)) * torch.exp(-nrm / sig)
        c_iso = (sig**2 + sig * nrm) * base
        u = torch.einsum("bcpd,cgpd->bcgp", delta, jcol)  # (B, C, g, P)
        z = torch.einsum("bcgp,bcpd->bcgd", u * base[:, :, None, :], delta)
        W = torch.einsum("bcp,cgpd->bcgd", c_iso, jcol)
        G = W - 5.0 * z                                   # (B, C, g, D)
        blk = torch.einsum("bcsd,bdt->btcs", G, Jf_I)     # (B, T, C, g)
        out[start * T:stop * T] = blk.reshape((stop - start) * T, -1)[
            :, flat_valid]
    return out


def assemble_columns(
    spec: DescriptorSpec,
    cache: KernelCache,
    col_idxs: np.ndarray,
) -> torch.Tensor:
    """PSD kernel columns K[:, col_idxs] (n, k) for a sorted column subset
    (the Nyström / leverage-score path; reference train.py:1192-1263).

    Every column set goes through the grouped column-exact assembly.  The
    JAX package sends sparse sets on small problems through a chunked
    point-block path instead; the columns are the same.
    """
    col_idxs = np.asarray(col_idxs)
    if not np.array_equal(col_idxs, np.sort(col_idxs)):
        raise ValueError("column indices must be sorted")
    if len(np.unique(col_idxs)) != len(col_idxs):
        raise ValueError("duplicate column indices")
    T = spec.dim_i
    if spec.dim * T * 8 * max(4, cache.n_perms) > _INFLATION_BUDGET:
        raise NotImplementedError(
            "large-D column assembly (compressed / square paths) is ROADMAP "
            "module item 10")
    points = col_idxs // T
    n_pts = len(np.unique(points))
    g = int(min(8, max(1, round(len(col_idxs) / n_pts))))
    grp_pt, grp_t, flat_valid = _group_columns(points, col_idxs % T, g)
    # row tile sized so the (tile, C, g, P, D) intermediates stay ~<= 0.2 GB
    row_bytes = len(grp_pt) * g * max(cache.n_perms, 1) * spec.dim * 8
    tile = max(2, min(cache.n_train, int(2e8 / max(row_bytes, 1))))
    dev = cache.device
    return _assemble_columns_grouped(
        T, cache, torch.as_tensor(grp_pt, device=dev),
        torch.as_tensor(grp_t, device=dev), tile,
        torch.as_tensor(flat_valid, device=dev))
