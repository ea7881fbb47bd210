"""Matérn-5/2 Hessian force-field kernel: operator cache, matvec, columns.

PyTorch port of the main slice of ``mlff_tpu.ops.kernel`` (reference:
sgdml/train.py:150-236, 1121-1308; sgdml/predict.py:72-234).

Math.  For training descriptors x_i (D,) with compressed Jacobians J_i and a
permutation group acting by descriptor index arrays P (P_perms, D), the PSD
kernel block between training points i, j is

    K[i, j] = Jf_i^T  sum_p  base_p [ (sig^2 + sig*n_p) I - 5 d_p d_p^T ] Jf~_{j,p}

with d_p = x_i - x_j[P_p],  n_p = sqrt(5) ||d_p||,
base_p = 5 exp(-n_p / sig) / (3 sig^4).

The pairwise distance matrix, its exponential and the (1 + dist) weight
(``pair_weights``) are computed once per solve (``KernelCache``); each CG
iteration is then the contraction ``desc_forces``: three (N, M) x (M, D)
f64 products (cuBLAS DGEMM on the card) plus elementwise work.  The
Predictor's f64 route and the fused kernel's plain version take the same
two steps.  Above 3 GB of such caches (``pairwise_fits``) the matvec
recomputes them in every call instead (``build_cache(pairwise=False)``,
``_matvec_ref_otf``): on the card in one call of the fused contraction
kernel (``ops/fused_predict.py``), which keeps the (N, M) weights out of
device memory; on the CPU, and for an f32 copy, per row tile in plain
PyTorch (``_otf_row_tiles``, the tile loop of every on-the-fly matvec).
Dense assembly (``assemble_block``, ``assemble_full``), the kernel diagonal
and single columns serve the pivoted-Cholesky, eigenvector and analytic
solvers.
Large molecules take inflation-free routes: compressed columns and diagonal
(``assemble_columns_compressed*``, ``kernel_diag_compressed``,
``kernel_column_compressed``) and the square all-pairs layout
(``SquareCache``, ``matvec_psd_square``, ``assemble_columns_square``).
Energy constraints extend the system by one row and column per training
point (``matvec_psd_ecstr``, ``assemble_*_ecstr``, ``kernel_diag_ecstr``),
on the pairwise cache only.  The precision engines are options of the
solve, never its default: the f32 matvec on a ``downcast_cache`` copy, the
mixed matvec (``matvec_psd_mixed``: centred f32 products with hi/lo operand
corrections and f64 chunk sums) and the Ozaki exact-slice matvec
(``ozaki_matvec_state``, ``matvec_psd_ozaki``: f64-grade products from
exact f32 digit passes, ``ops/ozaki.py``), each on the cached and the
on-the-fly cache.
"""

from __future__ import annotations

import dataclasses
import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import require_full_f32, resolve_device
from ..utils import trace
from ..utils.log import get_logger
from .descriptor import DescriptorSpec, d_desc_dot_vec, vec_dot_d_desc

log = get_logger(__name__)

SQRT5 = math.sqrt(5.0)

# above this (D, 3A, perms) inflation size the JAX package switches to its
# compressed / square column paths (ops/kernel.py _INFLATION_BUDGET)
_INFLATION_BUDGET = int(2e8)


@dataclass
class KernelCache:
    """Per-solve state of the implicit kernel operator, on one device.

    Shapes: N = n_train, P = n_perms, M = N*P, D = descriptor dim,
    A = n_atoms.  Float fields are f64; ``P_idx`` is int64.  ``A_exp`` and
    ``A_exp1`` are None for an on-the-fly cache (``pairwise=False``); the
    square fields are set by ``build_cache(R=...)`` only.
    """

    X: torch.Tensor        # (N, D) descriptors
    Jc: torch.Tensor       # (N, D, 3) compressed Jacobians
    S: torch.Tensor        # (D, A) incidence matrix
    P_idx: torch.Tensor    # (P, D) descriptor permutations
    Xq: torch.Tensor       # (N, D) q-scaled descriptors, q = sqrt(5)/sig
    Xqt: torch.Tensor      # (M, D) q-scaled permuted descriptors
    A_exp: torch.Tensor | None   # (N, M) 5/(3 sig^2) * exp(-dist)
    A_exp1: torch.Tensor | None  # (N, M) A_exp * (1 + dist)
    sig: float             # kernel length scale
    lam: float             # ridge regularization
    # square all-pairs layout of single-perm large molecules (SquareCache)
    Xsq: torch.Tensor | None = None   # (N, A, A) 1/sqrt(2)-scaled descriptors
    Gsq: torch.Tensor | None = None   # (N, A, A, 3) scaled Jacobian field
    # per-point assembly projections (_square_point_columns), built when
    # their N^2 A 120 bytes fit in 2 GB
    Usq: torch.Tensor | None = None   # (N, N, A, 3)  U[j, n, b, x]
    Zsq: torch.Tensor | None = None   # (N, N, A, 3)  Z[j, n, a, y]
    C1sq: torch.Tensor | None = None  # (N, N, A, 3, 3) C1[j, n, b, x, y]
    # parallel.mesh.RowShard of a row-sharded cache (parallel.mesh.
    # shard_cache): the fields with a training-point row axis then hold this
    # rank's rows, and n_train / n count them
    shard: object = None

    @property
    def n_train(self) -> int:
        """Training points in this cache's rows (all of them unsharded)."""
        return self.X.shape[0]

    @property
    def n_train_global(self) -> int:
        return self.n_train * (1 if self.shard is None else self.shard.world)

    @property
    def n_global(self) -> int:
        return self.S.shape[1] * 3 * self.n_train_global

    @property
    def row0(self) -> int:
        """Global index of this cache's first training point."""
        return 0 if self.shard is None else self.shard.rank * self.n_train

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


def vector_layout(cache, use_E_cstr: bool = False):
    """The ``parallel.mesh.VecLayout`` of the solve's vectors on a
    row-sharded cache, None when it is not sharded: one segment (n,), or
    (n, N) with energy constraints (each rank holds its points' force and
    energy entries)."""
    if cache.shard is None:
        return None
    return cache.shard.layout((cache.n_global, cache.n_train_global)
                              if use_E_cstr else (cache.n_global,))


def _all_points(cache, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Per-point rows of this cache -> rows of every training point: the
    sharded matvec's one all-gather (the tensor itself unsharded)."""
    return t if cache.shard is None else cache.shard.gather(t, dim=dim)


def permuted_descriptors(X: torch.Tensor, P_idx: torch.Tensor) -> torch.Tensor:
    """(N, D) -> (N*P, D): row (j*P + p) = X[j, P_idx[p]] (point-major)."""
    return X[:, P_idx].reshape(-1, X.shape[1])


def pairwise_dist_gram(Xq_a: torch.Tensor, Xq_b: torch.Tensor) -> torch.Tensor:
    """Pairwise distances ||a_i - b_j|| via the Gram trick (one matmul)."""
    na = torch.sum(Xq_a * Xq_a, dim=1)
    nb = torch.sum(Xq_b * Xq_b, dim=1)
    return _dist_from_gram(na, nb, Xq_a @ Xq_b.T)


def _dist_from_gram(na: torch.Tensor, nb: torch.Tensor,
                    g: torch.Tensor) -> torch.Tensor:
    """(B, M) distances from squared row norms na (B,), nb (M,) and the Gram
    matrix g (B, M) of the two sides, however g was formed."""
    return torch.sqrt(torch.clamp(na[:, None] + nb[None, :] - 2.0 * g,
                                  min=0.0))


def pair_weights(dist: torch.Tensor, sig: float):
    """(A_exp, A_exp1) = (5/(3 sig^2) exp(-dist), A_exp (1 + dist)): the two
    Matern-5/2 weights of the descriptor-force contraction (``desc_forces``)
    over q-scaled pairwise distances, at the dtype of ``dist``.  The
    Hessian block's weights are ``_matern_weights``."""
    A_exp = (5.0 / (3.0 * sig**2)) * torch.exp(-dist)
    return A_exp, A_exp * (1.0 + dist)


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
    ``pairwise=False`` leaves out the two (N, M) weight arrays: the matvec
    then recomputes them per row tile (``_matvec_ref_otf``).  ``R`` (N, A, 3)
    adds the square all-pairs fields (``SquareCache``) that the large-A
    column assembly reads.
    """
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
    A_exp = A_exp1 = None
    if pairwise:
        A_exp, A_exp1 = pair_weights(pairwise_dist_gram(Xq, Xqt), sig)
    square = {}
    if R is not None:
        square = _square_fields(_f64(R, dev).reshape(X.shape[0], -1, 3), sig)
    return KernelCache(X=X, Jc=Jc, S=S, P_idx=P_idx, Xq=Xq, Xqt=Xqt,
                       A_exp=A_exp, A_exp1=A_exp1, sig=sig, lam=lam, **square)


def _square_geometry(R: torch.Tensor):
    """(inv (N, A, A), diffs (N, A, A, 3)) of geometries R (N, A, 3):
    1 / |r_i - r_l| with a zero diagonal, and r_i - r_l."""
    A = R.shape[1]
    diffs = R[:, :, None, :] - R[:, None, :, :]
    d2 = torch.sum(diffs * diffs, dim=-1)
    eye = torch.eye(A, dtype=torch.bool, device=R.device)[None]
    inv = torch.where(eye, 0.0, 1.0 / torch.sqrt(torch.where(eye, 1.0, d2)))
    return inv, diffs


def _square_fields(R: torch.Tensor, sig: float) -> dict:
    """The square fields of ``build_cache(R=...)``: Xsq, Gsq and, when their
    N^2 A 120 bytes fit in 2 GB, the per-point assembly projections U, Z,
    C1 shared by every column of a point."""
    N, A = R.shape[:2]
    inv, diffs = _square_geometry(R)
    isqrt2 = 1.0 / math.sqrt(2.0)
    Xsq = ((SQRT5 / sig) * isqrt2) * inv
    Gsq = diffs * (isqrt2 * inv**3)[..., None]
    out = {"Xsq": Xsq, "Gsq": Gsq}
    if N * N * A * 120 <= int(2e9):
        U, Z, C1 = [], [], []
        for j in range(N):
            delta = (Xsq - Xsq[j][None]) * (sig / SQRT5)            # (N, A, A)
            U.append(-2.0 * torch.sum(delta[..., None] * Gsq[j][None], dim=2))
            Z.append(2.0 * torch.sum(delta[..., None] * Gsq, dim=1))
            C1.append(2.0 * torch.einsum("ibx,niby->nbxy", Gsq[j], Gsq))
        out.update(Usq=torch.stack(U), Zsq=torch.stack(Z),
                   C1sq=torch.stack(C1))
    return out


def desc_forces(Xqt, sig, Xq_query, A_exp, A_exp1, wt,
                energies: bool = True):
    """Descriptor-space force contraction shared by matvec and prediction:
    three (B, M)-shaped products around the ``pair_weights``.  Returns
    (F_desc (B, D), E (B,)) in the reference predictor's sign convention,
    E None with ``energies=False`` (the matvecs: eager PyTorch would spend a
    (B, M) pass on energies that XLA drops as dead code).  The same math
    serves the packed (B, D) and the square (B, A*A) layouts, and cotangents
    ``wt`` with leading batch axes (``matmat_psd``).

        dot = Xq_query . wt^T - sum(Xqt * wt)
        F   = Xq_query * sum_m(A_exp * dot) - (A_exp * dot) @ Xqt - A_exp1 @ wt
        E   = sum_m(A_exp1 * dot) / q
    """
    ct = torch.sum(Xqt * wt, dim=-1)                        # (..., M)
    dot = Xq_query @ wt.mT - ct[..., None, :]               # (..., B, M)
    G = A_exp * dot
    F1 = Xq_query * torch.sum(G, dim=-1, keepdim=True) - G @ Xqt
    F2 = A_exp1 @ wt
    if not energies:
        return F1 - F2, None
    q = SQRT5 / sig
    E = torch.sum(A_exp1 * dot, dim=-1) / q
    return F1 - F2, E


def energy_coef_terms(Xq_query, Xqt, sig, A_exp1, vE_lin, F_desc, E, K_ee):
    """``desc_forces``' (F_desc, E) plus the terms of energy-constraint
    coefficients ``vE_lin`` (M,) (reference predict.py:210-218): the forces
    gain sum_m vE_m A_exp1[b, m] delta with delta unscaled by q, the
    energies the plain Matern-5/2 block ``K_ee`` (B, M) applied to vE_lin.
    The caller forms K_ee (from distances, or from a pairwise cache)."""
    q = SQRT5 / sig
    H = A_exp1 * vE_lin[None, :]                                 # (B, M)
    F_desc = F_desc + (Xq_query * torch.sum(H, dim=1, keepdim=True)
                       - H @ Xqt) / q
    return F_desc, E + K_ee @ vE_lin


def perm_expand_w(w: torch.Tensor, P_idx: torch.Tensor) -> torch.Tensor:
    """(N, D) -> (N*P, D) permuted copies of per-point descriptor cotangents."""
    return w[:, P_idx].reshape(-1, w.shape[1])


# row tile of the on-the-fly matvec: (tile, M) pairwise transients
_OTF_TILE = 4096

# counters (utils.trace): row tiles the on-the-fly matvecs' tile loop
# (``_otf_row_tiles``) has run, and on-the-fly matvecs run through the
# fused kernel
OTF_TILES = "matvec.otf_tiles"
OTF_FUSED = "matvec.otf_fused"

# elements budget for one (tile, M) OTF transient, the JAX package's rule
# kept verbatim (there it bounds the f64 emulation's 8-way split
# transients); MLFF_OTF_TILE_BUDGET overrides it
_OTF_TILE_BUDGET = int(float(os.environ.get("MLFF_OTF_TILE_BUDGET", 3e7)))


def _otf_tile(N: int, M: int) -> int:
    """Row tile of the OTF matvec: bounded by both _OTF_TILE and the
    (tile, M) transient element budget.  The 128-row floor can EXCEED the
    budget when M > _OTF_TILE_BUDGET/128 (~234k columns, e.g. P = 6 beyond
    n ~ 1M): warn loudly so the ensuing memory pressure is attributable
    instead of an opaque out-of-memory error."""
    budget_t = (_OTF_TILE_BUDGET // max(M, 1)) // 128 * 128
    t = max(128, min(_OTF_TILE, budget_t))
    if budget_t < 128 and N >= 128:
        log.warning(
            "OTF matvec: 128-row tile floor exceeds the transient budget "
            "(M = %d columns -> %.1f GB of f64-split transients vs ~4 GB "
            "target); expect HBM pressure or OOM at this scale", M,
            128 * M * 32 / 1e9)
    return min(t, N)


def _matvec_ref_otf(cache: KernelCache, v: torch.Tensor) -> torch.Tensor:
    """K_ref @ v with the pairwise weights recomputed in every call (the
    cache carries no (N, M) arrays: ``build_cache(pairwise=False)``).

    An f64 cache on the card takes all its rows in one call of the fused
    contraction kernel (``fused_predict.desc_forces_fused``, the narrow
    route to D = 129, the wide one beyond; its energies are dropped), which
    forms distances and weights on its tiles: no (N, M) array reaches
    device memory.  Such calls are counted in ``OTF_FUSED``.  A CPU cache,
    and an f32 ``downcast_cache`` copy, run the plain version,
    ``_desc_forces_otf_tiles``.  While ``utils.trace`` records, the
    kernel's launches or the tile loop (not the all-gather of the
    cotangents before them) are a span ``matvec.otf``.  A CUDA graph of
    the CG iteration adds the capture's counts once per replay
    (``trace.counted``), so replayed matvecs are counted too."""
    N = cache.n_train
    A = cache.S.shape[1]
    w = d_desc_dot_vec(cache.Jc, cache.S, v.reshape(N, A, 3))   # (N, D)
    w = _all_points(cache, w)
    # an f32 cache (downcast_cache): distances, weights and the products in
    # f32 (the JAX package promotes this variant's products to f64 against
    # its f64 cotangents; torch does not promote in a product)
    wt = perm_expand_w(_at_cache_dtype(cache, w), cache.P_idx)  # (M, D)
    if cache.Xq.is_cuda and cache.Xq.dtype == torch.float64:
        from .fused_predict import desc_forces_fused

        with trace.span("matvec.otf"):
            F_desc, _ = desc_forces_fused(cache.Xq, cache.Xqt, wt, cache.sig)
        trace.count(OTF_FUSED)
    else:
        F_desc = _desc_forces_otf_tiles(cache, wt)
    return vec_dot_d_desc(cache.Jc, cache.S,
                          F_desc.to(cache.Jc.dtype)).reshape(-1)


def _otf_row_tiles(cache: KernelCache, tile_forces) -> torch.Tensor:
    """The (N, D) descriptor forces of an on-the-fly matvec, row tile by
    row tile of ``_otf_tile`` rows (the last a shorter slice):
    ``tile_forces(Xq_t)`` gives the (tile, D) forces of the cache's rows
    ``Xq_t``, from their own distances and weights.  While ``utils.trace``
    records, the loop is a span ``matvec.otf``; the tiles run are counted
    in ``OTF_TILES``.  The plain, the mixed and the Ozaki matvec share
    it."""
    N = cache.n_train
    F_desc = torch.empty_like(cache.Xq)
    tile = _otf_tile(N, cache.Xqt.shape[0])
    with trace.span("matvec.otf"):
        for start in range(0, N, tile):
            F_desc[start:start + tile] = tile_forces(
                cache.Xq[start:start + tile])
    trace.count(OTF_TILES, -(-N // tile))
    return F_desc


def _desc_forces_otf_tiles(cache: KernelCache,
                           wt: torch.Tensor) -> torch.Tensor:
    """The on-the-fly matvec's (N, D) descriptor forces in plain PyTorch:
    per row tile one (tile, D) x (D, M) distance product, the
    ``pair_weights`` and the three products of ``desc_forces``."""
    def tile_forces(Xq_t):
        A_exp, A_exp1 = pair_weights(pairwise_dist_gram(Xq_t, cache.Xqt),
                                     cache.sig)
        return desc_forces(cache.Xqt, cache.sig, Xq_t, A_exp, A_exp1, wt,
                           energies=False)[0]

    return _otf_row_tiles(cache, tile_forces)


def _at_cache_dtype(cache: KernelCache, w: torch.Tensor) -> torch.Tensor:
    """Cotangents at the dtype of the cache's product operands: f64 as they
    are, or f32 for a ``downcast_cache`` copy, whose products must then run
    in full f32 (TF32 checked)."""
    if cache.Xqt.dtype == torch.float32:
        require_full_f32(cache.Xqt)
    return w.to(cache.Xqt.dtype)


def matvec_ref(cache: KernelCache, v: torch.Tensor) -> torch.Tensor:
    """K_ref @ v, the reference-convention (negative-definite) kernel matvec
    (reference predict.py:997-1110).  v: flat (n,); returns flat (n,).  On
    a ``downcast_cache`` copy the three products run in f32 and the
    Jacobian contractions in f64, as in the JAX package."""
    if cache.A_exp is None:
        return _matvec_ref_otf(cache, v)
    N = cache.n_train
    A = cache.S.shape[1]
    w = d_desc_dot_vec(cache.Jc, cache.S, v.reshape(N, A, 3))   # (N, D)
    w = _all_points(cache, w)
    wt = perm_expand_w(_at_cache_dtype(cache, w), cache.P_idx)  # (M, D)
    F_desc, _ = desc_forces(cache.Xqt, cache.sig, cache.Xq, cache.A_exp,
                            cache.A_exp1, wt, energies=False)
    return vec_dot_d_desc(cache.Jc, cache.S,
                          F_desc.to(cache.Jc.dtype)).reshape(-1)


def matvec_psd(cache: KernelCache, v: torch.Tensor) -> torch.Tensor:
    """(K + lam*I) @ v in the PSD convention: the CG system operator."""
    return cache.lam * v - matvec_ref(cache, v)


def matmat_psd(cache: KernelCache, V: torch.Tensor) -> torch.Tensor:
    """(K + lam*I) @ V for V (n, B).  The JAX package maps ``matvec_psd``
    over the columns; here each block of columns goes through the matvec's
    products at once, with the block as a leading batch axis, in blocks
    whose (b, N, M) products stay near 1 GB.  A cache without pairwise
    fields takes its columns one at a time through the on-the-fly matvec."""
    if cache.A_exp is None:
        return torch.stack([matvec_psd(cache, V[:, j])
                            for j in range(V.shape[1])], dim=1)
    N, A, D = cache.n_train, cache.S.shape[1], cache.X.shape[1]
    M = cache.Xqt.shape[0]
    block = max(1, 2**27 // (N * M))
    out = torch.empty_like(V)
    for start in range(0, V.shape[1], block):
        Vb = V[:, start:start + block].T                        # (b, n)
        b = Vb.shape[0]
        w = d_desc_dot_vec(cache.Jc, cache.S, Vb.reshape(b, N, A, 3))
        w = _all_points(cache, w, dim=1)
        wt = w[:, :, cache.P_idx].reshape(b, M, D)              # (b, M, D)
        F_desc, _ = desc_forces(cache.Xqt, cache.sig, cache.Xq,
                                cache.A_exp, cache.A_exp1, wt, energies=False)
        Kv = vec_dot_d_desc(cache.Jc, cache.S, F_desc).reshape(b, -1)
        out[:, start:start + block] = (cache.lam * Vb - Kv).T
    return out


# ---------------------------------------------------------------------------
# Reduced-precision matvecs (options of the solve, never its default)
# ---------------------------------------------------------------------------
#
# A plain f32 downcast of the matvec (downcast_cache) lands ~1e-5..1e-6
# relative error, for two separable reasons that the mixed matvec removes:
#
#   1. CANCELLATION in the Gram-trick dot:  dot = Xq.wt - Xqt.wt rounds at
#      the magnitude of the uncancelled products.  Fix: centre both
#      descriptor sets by a common vector c before the product
#      ((Xq-c).wt - (Xqt-c).wt = dot exactly).
#   2. f32 ACCUMULATION over the M = N*P kernel axis (~sqrt(M) * 2^-24).
#      Fix: products over chunks of _MIXED_CHUNK columns, one batched f32
#      product for all chunks, the partials summed in f64.
#
# Operand quantization (2^-24 of the weights, Xqt and the per-iteration w)
# is corrected with one extra product per split operand (hi/lo splitting,
# ops.df64.split_f64): the correction terms are 2^-24-scaled, so plain f32
# products carry them at 2^-48 overall.  Everything outside the (B, M)
# products stays f64.  The JAX package measured that these matvecs diverge
# CG on the calibrated system, whose spectrum reaches the ridge floor
# (mlff_tpu/solvers/iterative.py:309-322): they are options, with f64
# residual replacement.

_MIXED_CHUNK = 32


def downcast_cache(cache: KernelCache, dtype=torch.float32) -> KernelCache:
    """Copy of an f64 cache with the per-iteration product operands (Xq,
    Xqt, A_exp, A_exp1) downcast, for the f32 CG matvec.  The
    preconditioner build keeps the f64 cache; lam, X and Jc stay f64, so
    the result is combined with lam * v in f64."""
    return dataclasses.replace(
        cache,
        Xq=cache.Xq.to(dtype),
        Xqt=cache.Xqt.to(dtype),
        A_exp=None if cache.A_exp is None else cache.A_exp.to(dtype),
        A_exp1=None if cache.A_exp1 is None else cache.A_exp1.to(dtype))


def _f32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 product, promoted to f64 (``precision=HIGHEST`` in the JAX
    package: full f32, TF32 checked)."""
    require_full_f32(a)
    return (a @ b).to(torch.float64)


def _gemm_f32_chunkacc(A32: torch.Tensor, B32: torch.Tensor,
                       mc: int | None = None) -> torch.Tensor:
    """A32 (B, M) @ B32 (M, D) with f32 products over chunks of ``mc``
    columns and the chunk partials summed in f64: the f32 rounding lands at
    ~2^-24 * mc / sqrt(M) of a cancelling result (~2e-8 at M ~ 7000)."""
    require_full_f32(A32)
    mc = _MIXED_CHUNK if mc is None else mc
    Bn, M = A32.shape
    D = B32.shape[1]
    nc = -(-M // mc)
    pad = nc * mc - M
    if pad:
        A32 = torch.nn.functional.pad(A32, (0, pad))
        B32 = torch.nn.functional.pad(B32, (0, 0, 0, pad))
    part = torch.bmm(A32.reshape(Bn, nc, mc).transpose(0, 1),
                     B32.reshape(nc, mc, D))              # (nc, B, D) f32
    return torch.sum(part.to(torch.float64), dim=0)


def _rowsum_f32_chunkacc(A32: torch.Tensor, mc: int | None = None):
    """sum(A32, dim=1) with f64 chunk accumulation: (B, M) f32 -> (B,) f64."""
    mc = _MIXED_CHUNK if mc is None else mc
    Bn, M = A32.shape
    nc = -(-M // mc)
    pad = nc * mc - M
    if pad:
        A32 = torch.nn.functional.pad(A32, (0, pad))
    part = torch.sum(A32.reshape(Bn, nc, mc), dim=2)    # (B, nc) f32
    return torch.sum(part.to(torch.float64), dim=1)


def _mixed_forces(Xq_t, c, Xtch, Xtcl, wh, wl, ct_c, A_exp, A_exp1):
    """Descriptor-space forces (tile, D) of the mixed matvec for one block
    of query rows ``Xq_t`` (f64) against f64 weights: the centred dot, then
    G @ Xqt and A_exp1 @ wt through split f32 products."""
    from .df64 import split_f64

    Xch, Xcl = split_f64(Xq_t - c)
    dot = (_f32_mm(Xch, wh.T) + _f32_mm(Xcl, wh.T) + _f32_mm(Xch, wl.T)
           - ct_c[None, :])                             # (B, M) f64
    Gh, Gl = split_f64(A_exp * dot)
    GX = (_gemm_f32_chunkacc(Gh, Xtch) + _f32_mm(Gl, Xtch)
          + _f32_mm(Gh, Xtcl))                          # (B, D) f64
    rowsum = _rowsum_f32_chunkacc(Gh) + torch.sum(Gl.to(torch.float64),
                                                  dim=1)
    # G @ Xqt = G @ Xtc + rowsum(G) * c  (undo the centring)
    F1 = Xq_t * rowsum[:, None] - (GX + rowsum[:, None] * c[None, :])
    A1h, A1l = split_f64(A_exp1)
    F2 = (_gemm_f32_chunkacc(A1h, wh) + _f32_mm(A1l, wh)
          + _f32_mm(A1h, wl))                           # (B, D) f64
    return F1 - F2


def _mixed_operands(cache: KernelCache, v: torch.Tensor):
    """The per-iteration operands of the mixed matvec: the centre c, the
    split centred training descriptors and cotangents, and ct_c."""
    from .df64 import split_f64

    N = cache.n_train
    A = cache.S.shape[1]
    w64 = d_desc_dot_vec(cache.Jc, cache.S, v.reshape(N, A, 3))  # (N, D)
    wt64 = perm_expand_w(_all_points(cache, w64), cache.P_idx)  # (M, D)
    if cache.shard is None:
        c = torch.mean(cache.Xq, dim=0)                         # (D,)
    else:
        c = cache.shard.all_reduce(torch.sum(cache.Xq, dim=0)) \
            / cache.n_train_global
    Xtc = cache.Xqt - c                                         # (M, D)
    ct_c = torch.sum(Xtc * wt64, dim=1)                         # (M,)
    wh, wl = split_f64(wt64)
    Xtch, Xtcl = split_f64(Xtc)
    return c, Xtch, Xtcl, wh, wl, ct_c


def matvec_ref_mixed(cache: KernelCache, v: torch.Tensor) -> torch.Tensor:
    """K_ref @ v with f32 products and ~sqrt(_MIXED_CHUNK) * 2^-24 relative
    error, from the f64 cache (the splits are made per call).  An
    on-the-fly cache forms its weights per row tile (``_otf_row_tiles``):
    the distances from three split f32 products of the Gram trick (~1e-9
    absolute in dist), exp and the weights in f64."""
    from .df64 import split_f64

    ops = _mixed_operands(cache, v)
    if cache.A_exp is not None:
        F_desc = _mixed_forces(cache.Xq, *ops, cache.A_exp, cache.A_exp1)
        return vec_dot_d_desc(cache.Jc, cache.S, F_desc).reshape(-1)
    nb = torch.sum(cache.Xqt * cache.Xqt, dim=1)                # (M,)
    Xqth, Xqtl = split_f64(cache.Xqt)

    def tile_forces(Xq_t):
        na = torch.sum(Xq_t * Xq_t, dim=1)
        Xh, Xl = split_f64(Xq_t)
        g = _f32_mm(Xh, Xqth.T) + _f32_mm(Xl, Xqth.T) + _f32_mm(Xh, Xqtl.T)
        A_exp, A_exp1 = pair_weights(_dist_from_gram(na, nb, g), cache.sig)
        return _mixed_forces(Xq_t, *ops, A_exp, A_exp1)

    F_desc = _otf_row_tiles(cache, tile_forces)
    return vec_dot_d_desc(cache.Jc, cache.S, F_desc).reshape(-1)


def matvec_psd_mixed(cache: KernelCache, v: torch.Tensor) -> torch.Tensor:
    """(K + lam*I) @ v through the mixed matvec (cached pairwise weights when
    present, on-the-fly recomputation otherwise)."""
    return cache.lam * v - matvec_ref_mixed(cache, v)


# ---------------------------------------------------------------------------
# Ozaki exact-slice matvec (ops/ozaki.py): f64-grade from exact f32 products
# ---------------------------------------------------------------------------
#
# The three per-iteration (N, M)-shaped products run through ops.ozaki's
# error-free digit products: ~2^-48 of the operand scale, inside the ~1e-12
# lam-floor bound that the f32-grade matvecs miss.  The iteration-invariant
# operands (Xq, Xqt, A_exp1) are sliced once per solve (OzakiMatvecState);
# each iteration slices its own wt (M, D) and G (N, M).  Everything outside
# the products stays f64, as in matvec_ref.


@dataclass
class OzakiMatvecState:
    """KernelCache plus the digit decompositions of the iteration-invariant
    product operands.  Cached (pairwise) mode uses Xq_sl / Xqt_sl / Ae1_sl;
    on-the-fly mode (``cache.A_exp is None``) uses Xqt_sl / Xqt_sl_T and
    slices the per-tile operands in the loop."""

    cache: KernelCache
    Xq_sl: tuple | None     # slice_digits(Xq, axis=1):    product 1 left
    Xqt_sl: tuple           # slice_digits(Xqt, axis=0):   product 2 right
    Ae1_sl: tuple | None    # slice_digits(A_exp1, axis=1): product 3 left
    Xqt_sl_T: tuple | None = None  # slice_digits(Xqt.T, axis=0): distance
    #                                Gram's right side (on-the-fly only)


# On-the-fly digits: at M = 112k the JAX package's 6-digit on-the-fly path
# measured 1.3e-10 against f64 and stalled CG; 7 digits measured 3.5e-13 at
# n = 503,982 (on a TPU).  MLFF_OZAKI_DIST64=1 computes the distance Gram in
# plain f64 instead of through the digits (default off, as there).
_OZ_DIGITS = int(os.environ.get("MLFF_OZAKI_DIGITS", "7"))
_OZ_DIST64 = os.environ.get("MLFF_OZAKI_DIST64", "0") == "1"


def ozaki_matvec_state(cache: KernelCache) -> OzakiMatvecState:
    """The once-per-solve sliced operands (~s bf16 copies of each: the
    (N, M) A_exp1 digits exist in cached mode only)."""
    from . import ozaki

    if cache.A_exp1 is None:
        return OzakiMatvecState(
            cache=cache, Xq_sl=None,
            Xqt_sl=ozaki.slice_digits(cache.Xqt, axis=0, s=_OZ_DIGITS),
            Ae1_sl=None,
            Xqt_sl_T=ozaki.slice_digits(cache.Xqt.T, axis=0, s=_OZ_DIGITS))
    return OzakiMatvecState(
        cache=cache,
        Xq_sl=ozaki.slice_digits(cache.Xq, axis=1),
        Xqt_sl=ozaki.slice_digits(cache.Xqt, axis=0),
        Ae1_sl=ozaki.slice_digits(cache.A_exp1, axis=1))


def _ozaki_cotangents(cache: KernelCache, v: torch.Tensor):
    N = cache.n_train
    A = cache.S.shape[1]
    w = d_desc_dot_vec(cache.Jc, cache.S, v.reshape(N, A, 3))  # (N, D)
    wt = perm_expand_w(_all_points(cache, w), cache.P_idx)     # (M, D)
    return wt, torch.sum(cache.Xqt * wt, dim=1)                # (M,)


def matvec_ref_ozaki(state: OzakiMatvecState, v: torch.Tensor
                     ) -> torch.Tensor:
    """K_ref @ v with exact-slice products (~2^-48 against matvec_ref).  On
    an on-the-fly cache, per row tile (``_otf_row_tiles``), the distance
    Gram and the three force products all run as exact-slice products at
    ``_OZ_DIGITS``; distances and weights are f64.  The tile keeps the
    (segments, tile, D) f32 partials of the M-deep products and the
    (tile, M) weights and digits within a few GB at n = 157k."""
    from . import ozaki

    cache = state.cache
    wt, ct = _ozaki_cotangents(cache, v)
    if cache.A_exp is None:
        s = _OZ_DIGITS
        nq = torch.sum(cache.Xqt * cache.Xqt, dim=1)              # (M,)
        wtT_sl = ozaki.slice_digits(wt.T, axis=0, s=s)            # product 1
        wt_sl = ozaki.slice_digits(wt, axis=0, s=s)               # product 3

        def tile_forces(Xq_t):
            Xq_t_sl = ozaki.slice_digits(Xq_t, axis=1, s=s)
            if _OZ_DIST64:
                g = Xq_t @ cache.Xqt.T
            else:
                g = ozaki.gemm_presliced(Xq_t_sl, state.Xqt_sl_T)
            dist = _dist_from_gram(torch.sum(Xq_t * Xq_t, dim=1), nq, g)
            A_exp, A_exp1 = pair_weights(dist, cache.sig)
            dot = ozaki.gemm_presliced(Xq_t_sl, wtT_sl) - ct[None, :]
            G = A_exp * dot
            F1 = Xq_t * torch.sum(G, dim=1, keepdim=True) \
                - ozaki.gemm_presliced(ozaki.slice_digits(G, axis=1, s=s),
                                       state.Xqt_sl)
            F2 = ozaki.gemm_presliced(
                ozaki.slice_digits(A_exp1, axis=1, s=s), wt_sl)
            return F1 - F2

        F_desc = _otf_row_tiles(cache, tile_forces)
        return vec_dot_d_desc(cache.Jc, cache.S, F_desc).reshape(-1)
    # product 1: dot = Xq @ wt^T  (contraction D)
    dot = ozaki.gemm_presliced(
        state.Xq_sl, ozaki.slice_digits(wt.T, axis=0)) - ct[None, :]
    G = cache.A_exp * dot
    # product 2: G @ Xqt  (contraction M)
    F1 = cache.Xq * torch.sum(G, dim=1, keepdim=True) \
        - ozaki.gemm_presliced(ozaki.slice_digits(G, axis=1), state.Xqt_sl)
    # product 3: A_exp1 @ wt  (contraction M)
    F2 = ozaki.gemm_presliced(state.Ae1_sl, ozaki.slice_digits(wt, axis=0))
    return vec_dot_d_desc(cache.Jc, cache.S, F1 - F2).reshape(-1)


def matvec_psd_ozaki(state: OzakiMatvecState, v: torch.Tensor
                     ) -> torch.Tensor:
    """(K + lam*I) @ v on the Ozaki sliced operator (cached or on the fly)."""
    return state.cache.lam * v - matvec_ref_ozaki(state, v)


# ---------------------------------------------------------------------------
# Square all-pairs descriptor layout (large-A molecules)
# ---------------------------------------------------------------------------
#
# The packed layout contracts the compressed Jacobian against the +/-1
# incidence matrix S (D, A) as dense products: at A = 370 that is ~185x
# more work than its 2 nonzeros per row need.  The square layout keeps
# descriptors on an (A, A) grid (both orientations of each pair) and the
# Jacobian as an antisymmetric (A, A, 3) field, so both S-contractions
# become elementwise products and axis sums.  Every array carries a
# 1/sqrt(2) factor, so inner products over the A^2 entries equal the packed
# inner products over D: the kernel weights match the packed cache to
# rounding, and the last Jacobian-transpose contraction gains the factor 2.


@dataclass
class SquareCache:
    """Operator cache in the square all-pairs layout (N training points,
    P atom permutations, M = N*P):

    Gs   (N, A, A, 3): (r_i - r_l) / (sqrt(2) d^3), zero diagonal;
    Gst  (M, A, A, 3): atom-permuted copies of Gs, point-major;
    Xs   (N, A*A):     (sqrt(5)/sig) / (sqrt(2) d) square descriptors;
    Xst  (M, A*A):     atom-permuted square descriptors;
    perms (P, A):      the atom permutation group (row 0 = identity);
    A_exp, A_exp1 (N, M): the Matern-5/2 weights of the packed cache.
    """

    Gs: torch.Tensor
    Gst: torch.Tensor
    Xs: torch.Tensor
    Xst: torch.Tensor
    perms: torch.Tensor
    A_exp: torch.Tensor
    A_exp1: torch.Tensor
    sig: float
    lam: float
    # parallel.mesh.RowShard of a row-sharded cache (shard_square_cache):
    # every field with a leading N or M axis holds this rank's rows
    shard: object = None

    @property
    def device(self) -> torch.device:
        return self.Xs.device


def build_cache_square(R, perms, sig: float, lam: float,
                       device=None) -> SquareCache:
    """Square-layout cache from raw training geometries R (N, A, 3) and the
    atom permutation group perms (P, A), on ``device`` (cuda by default)."""
    dev = resolve_device(device)
    R = _f64(R, dev)
    N = R.shape[0]
    R = R.reshape(N, -1, 3)
    A = R.shape[1]
    perms = torch.as_tensor(np.asarray(perms) if not torch.is_tensor(perms)
                            else perms, dtype=torch.int64,
                            device=dev).reshape(-1, A)
    P = perms.shape[0]
    sig, lam = float(sig), float(lam)
    inv, diffs = _square_geometry(R)
    isqrt2 = 1.0 / math.sqrt(2.0)
    Xs = ((SQRT5 / sig) * isqrt2) * inv                      # (N, A, A)
    Gs = diffs * (isqrt2 * inv**3)[..., None]                # (N, A, A, 3)
    Xst = _perm_square(Xs, perms).reshape(N * P, A * A)
    Gst = _perm_square(Gs, perms).reshape(N * P, A, A, 3)
    Xs_flat = Xs.reshape(N, A * A)
    A_exp, A_exp1 = pair_weights(pairwise_dist_gram(Xs_flat, Xst), sig)
    return SquareCache(Gs=Gs, Gst=Gst, Xs=Xs_flat, Xst=Xst, perms=perms,
                       A_exp=A_exp, A_exp1=A_exp1, sig=sig, lam=lam)


def _perm_square(M_sq: torch.Tensor, perms: torch.Tensor) -> torch.Tensor:
    """Permute both grid axes of (N, A, A, ...) by each atom permutation:
    out[j, p, i, l] = M_sq[j, perm_p(i), perm_p(l)], the square-layout form
    of the packed descriptor permutation."""
    out = M_sq[:, perms]                                     # (N, P, A, A, ...)
    idx = perms[None, :, None, :]                            # (1, P, 1, A)
    while idx.dim() < out.dim():
        idx = idx[..., None]
    return torch.gather(out, 3, idx.expand(out.shape))


def matvec_ref_square(sq: SquareCache, v: torch.Tensor) -> torch.Tensor:
    """K_ref @ v in the square layout: the kernel weights of ``matvec_ref``,
    its reductions reordered."""
    N, A = sq.Gs.shape[0], sq.Gs.shape[1]
    P = sq.perms.shape[0]
    vt = v.reshape(N, A, 3)[:, sq.perms, :]                  # (N, P, A, 3)
    # wt[j, p, i, l] = Gst[j, p, i, l] . (vt[j, p, l] - vt[j, p, i])
    dvt = vt[:, :, None, :, :] - vt[:, :, :, None, :]
    wt = torch.sum(sq.Gst.reshape(N, P, A, A, 3) * dvt, dim=-1)
    wt = wt.reshape(N * P, A * A)
    Xst = sq.Xst
    if sq.shard is not None:
        # one all-gather per matvec: the row-local wt and this rank's rows
        # of the (sharded) training side, which G @ Xst reads whole
        both = sq.shard.gather(torch.stack([wt, Xst], dim=1))
        wt, Xst = both[:, 0], both[:, 1]
    F_desc, _ = desc_forces(Xst, sq.sig, sq.Xs, sq.A_exp, sq.A_exp1, wt,
                            energies=False)
    Fsq = F_desc.reshape(N, A, A)
    return (2.0 * torch.sum(Fsq[..., None] * sq.Gs, dim=1)).reshape(-1)


def matvec_psd_square(sq: SquareCache, v: torch.Tensor) -> torch.Tensor:
    """(K + lam*I) @ v through the square-layout operator."""
    return sq.lam * v - matvec_ref_square(sq, v)


# ---------------------------------------------------------------------------
# Column assembly (Nyström / leverage-score columns)
# ---------------------------------------------------------------------------


def _inflate_full(Jc: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """(..., D, 3) compressed -> (..., D, 3A) full Jacobians."""
    full = S[:, :, None] * Jc[..., :, None, :]      # (..., D, A, 3)
    return full.reshape(*Jc.shape[:-1], -1)


def _col_side(cache: KernelCache, col_cache: KernelCache | None = None):
    """The column side of an assembly: the cache itself, or on a row-sharded
    cache its all-gathered descriptors and Jacobians
    (``parallel.mesh.column_side``), indexed by global point.  The rows of
    the result stay this cache's rows."""
    if col_cache is not None or cache.shard is None:
        return cache if col_cache is None else col_cache
    from ..parallel.mesh import column_side
    return column_side(cache)


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
    col_cache: KernelCache | None = None,
) -> torch.Tensor:
    """Column-exact assembly: computes ONLY the requested partials, with the
    permutation axis collapsed before the row-side Jacobian is applied —
    O(B C D (3 g P + g 3A)) per row tile of B training points.  Returns the
    (n, k) PSD columns (this cache's rows; the column points are read from
    ``col_cache``, see ``_col_side``)."""
    sig = cache.sig
    N = cache.n_train
    T = spec_dim_i
    cc = _col_side(cache, col_cache)
    jcol = _columns_jcol(cc, grp_pt, grp_t)               # (C, g, P, D)
    X_g = cc.X[grp_pt][:, cache.P_idx]                    # (C, P, D)
    out = torch.empty((N * T, flat_valid.shape[0]), dtype=cache.X.dtype,
                      device=cache.device)
    for start in range(0, N, tile):
        stop = min(start + tile, N)
        X_I = cache.X[start:stop]                         # (B, D)
        Jf_I = _inflate_full(cache.Jc[start:stop], cache.S)  # (B, D, T)
        delta = X_I[:, None, None, :] - X_g[None]         # (B, C, P, D)
        base, c_iso = _matern_weights(delta, sig)         # (B, C, P)
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
    chunk: int = 8,
) -> torch.Tensor:
    """PSD kernel columns K[:, col_idxs] (n, k) for a sorted column subset
    (the Nystrom / leverage-score path; reference train.py:1192-1263), by
    the JAX package's routing rule:

      * large D (``_is_large_D``): the inflation-free paths, square when the
        cache carries the all-pairs fields of a single-perm molecule,
        grouped-compressed when the selection holds >= 4 partials per point,
        per-column compressed otherwise;
      * dense selections, or point blocks above 0.5 GB: the grouped
        column-exact assembly;
      * otherwise every touched point's whole (n, 3A) block, ``chunk``
        points at a time, and the requested partials taken from them.

    On a row-sharded cache each rank forms its own rows of the columns; the
    column points' data is all-gathered once (``_col_side``) and the route
    is chosen on the global sizes, so every rank takes the unsharded one.
    """
    col_idxs = np.asarray(col_idxs)
    if not np.array_equal(col_idxs, np.sort(col_idxs)):
        raise ValueError("column indices must be sorted")
    if len(np.unique(col_idxs)) != len(col_idxs):
        raise ValueError("duplicate column indices")
    T = spec.dim_i
    points = col_idxs // T
    uniq = np.unique(points)
    dev = cache.device
    cc = _col_side(cache)
    if _is_large_D(spec, cache.n_perms):
        if cache.Xsq is not None and cache.n_perms == 1:
            return assemble_columns_square(spec, cache, col_idxs,
                                           col_cache=cc)
        if len(col_idxs) >= 4 * len(uniq):
            return assemble_columns_compressed_grouped(spec, cache, col_idxs,
                                                       col_cache=cc)
        return assemble_columns_compressed(spec, cache, col_idxs,
                                           col_cache=cc)

    if (len(uniq) > cache.n_train_global // 3
            or len(uniq) * cache.n_global * T * 8 > int(5e8)):
        g = int(min(8, max(1, round(len(col_idxs) / len(uniq)))))
        grp_pt, grp_t, flat_valid = _group_columns(points, col_idxs % T, g)
        # row tile sized so the (tile, C, g, P, D) intermediates stay
        # ~<= 0.2 GB
        row_bytes = len(grp_pt) * g * max(cache.n_perms, 1) * spec.dim * 8
        tile = max(2, min(cache.n_train, int(2e8 / max(row_bytes, 1))))
        return _assemble_columns_grouped(
            T, cache, torch.as_tensor(grp_pt, device=dev),
            torch.as_tensor(grp_t, device=dev), tile,
            torch.as_tensor(flat_valid, device=dev), col_cache=cc)

    blocks = torch.cat([
        _point_blocks_chunk(T, cache,
                            torch.as_tensor(uniq[start:start + chunk],
                                            device=dev), cc)
        for start in range(0, len(uniq), chunk)])          # (n_pts, n, T)
    pt_pos = torch.as_tensor(np.searchsorted(uniq, points), device=dev)
    partial = torch.as_tensor(col_idxs % T, device=dev)
    return blocks[pt_pos, :, partial].T.contiguous()


def _point_blocks_chunk(spec_dim_i: int, cache: KernelCache,
                        pts: torch.Tensor,
                        col_cache: KernelCache | None = None) -> torch.Tensor:
    """All-row kernel blocks of a chunk of training points:
    (len(pts), n, 3A)."""
    return torch.stack([_point_block_cols(spec_dim_i, cache, j[None],
                                          col_cache)
                        for j in pts])


# ---------------------------------------------------------------------------
# Large-D columns without Jacobian inflation (compressed form)
# ---------------------------------------------------------------------------


def _columns_compressed_chunk(cache: KernelCache, pts: torch.Tensor,
                              atoms: torch.Tensor, xyzs: torch.Tensor,
                              col_cache: KernelCache | None = None
                              ) -> torch.Tensor:
    """PSD kernel columns (C, n), no ridge, for partial (atoms[c], xyzs[c])
    of point pts[c], all (C,) index tensors, straight from the compressed
    form: the permuted Jacobian column is Jc[j, P[p, q], x] * S[P[p, q], b],
    and nothing larger than (C, N, P, D) forms (a (D, 3A) inflated Jacobian
    costs ~0.6 GB per point at D = 68,265)."""
    cc = _col_side(cache, col_cache)
    Pj = cache.P_idx                                         # (P, D)
    ix = (pts[:, None, None], Pj[None], xyzs[:, None, None])
    jcol = cc.Jc[ix] * cache.S[Pj[None], atoms[:, None, None]]  # (C, P, D)
    Xt_j = cc.X[pts[:, None, None], Pj[None]]                # (C, P, D)
    delta = cache.X[None, :, None, :] - Xt_j[:, None]        # (C, N, P, D)
    base, c_iso = _matern_weights(delta, cache.sig)          # (C, N, P)
    u = torch.einsum("cnpd,cpd->cnp", delta, jcol)
    G = (torch.einsum("cnp,cpd->cnd", c_iso, jcol)
         - 5.0 * torch.einsum("cnp,cnpd->cnd", base * u, delta))  # (C, N, D)
    return vec_dot_d_desc(cache.Jc, cache.S, G).reshape(G.shape[0], -1)


def assemble_columns_compressed(
    spec: DescriptorSpec,
    cache: KernelCache,
    col_idxs: np.ndarray,
    chunk: int | None = None,
    col_cache: KernelCache | None = None,
) -> torch.Tensor:
    """Inflation-free PSD kernel columns K[:, col_idxs] (n, k) for large-D
    molecules, ``chunk`` columns per batched call (by default as many as
    keep the (N, P, D) per-column intermediates under ~1 GB)."""
    cc = _col_side(cache, col_cache)
    col_idxs = np.asarray(col_idxs)
    if chunk is None:
        per_col = cache.n_train * max(cache.n_perms, 1) * spec.dim * 8
        chunk = int(max(16, min(256, 1e9 // max(per_col, 1))))
    T = spec.dim_i
    dev = cache.device
    pts = torch.as_tensor(col_idxs // T, device=dev)
    partial = torch.as_tensor(col_idxs % T, device=dev)
    out = torch.empty((cache.n, len(col_idxs)), dtype=cache.X.dtype,
                      device=dev)
    for start in range(0, len(col_idxs), chunk):
        sl = slice(start, start + chunk)
        out[:, sl] = _columns_compressed_chunk(
            cache, pts[sl], partial[sl] // 3, partial[sl] % 3, cc).T
    return out


def _columns_compressed_point_group(
    spec_dim_i: int,
    cache: KernelCache,
    j: int,
    ts: torch.Tensor,     # (g,) partial indices of point j, -1 pads
    g_chunk: int,
    col_cache: KernelCache | None = None,
) -> torch.Tensor:
    """All requested kernel columns of ONE training point, batched: (n, g).
    The (N, P, D) geometry of the point is shared by its columns, and each
    chunk of ``g_chunk`` columns contracts with the Jacobians as one wide
    product.  No (D, 3A) inflation anywhere."""
    N = cache.n_train
    g = ts.shape[0]
    cc = _col_side(cache, col_cache)
    jt = torch.as_tensor([j], device=cache.device)
    jcol = _columns_jcol(cc, jt, ts[None])[0]                # (g, P, D)
    Xt_j = cc.X[j][cache.P_idx]                              # (P, D)
    delta = cache.X[:, None, :] - Xt_j[None]                 # (N, P, D)
    base, c_iso = _matern_weights(delta, cache.sig)          # (N, P)
    bdelta = base[..., None] * delta                         # (N, P, D)
    out = torch.empty((N, g, spec_dim_i), dtype=cache.X.dtype,
                      device=cache.device)
    for start in range(0, g, g_chunk):
        jc = jcol[start:start + g_chunk]                     # (gc, P, D)
        u = torch.einsum("npd,spd->nsp", delta, jc)          # (N, gc, P)
        z = torch.einsum("nsp,npd->nsd", u, bdelta)          # (N, gc, D)
        W = torch.einsum("np,spd->nsd", c_iso, jc)
        G = W - 5.0 * z
        out[:, start:start + g_chunk] = vec_dot_d_desc(
            cache.Jc[:, None], cache.S, G).reshape(N, jc.shape[0], -1)
    return out.permute(0, 2, 1).reshape(N * spec_dim_i, g)


def assemble_columns_compressed_grouped(
    spec: DescriptorSpec,
    cache: KernelCache,
    col_idxs: np.ndarray,
    g_chunk: int = 8,
    col_cache: KernelCache | None = None,
) -> torch.Tensor:
    """Inflation-free kernel columns for DENSE selections on large-D
    molecules: one ``_columns_compressed_point_group`` call per owning
    point, its partials padded to a multiple of ``4 * g_chunk``.  col_idxs
    sorted."""
    col_idxs = np.asarray(col_idxs)
    cc = _col_side(cache, col_cache)
    T = spec.dim_i
    points = col_idxs // T
    partials = col_idxs % T
    out = torch.empty((cache.n, len(col_idxs)), dtype=cache.X.dtype,
                      device=cache.device)
    bucket = 4 * g_chunk
    done = 0
    for j in np.unique(points):
        ts = partials[points == j]
        ts_pad = np.full(-(-len(ts) // bucket) * bucket, -1, dtype=np.int64)
        ts_pad[:len(ts)] = ts
        blk = _columns_compressed_point_group(
            T, cache, int(j), torch.as_tensor(ts_pad, device=cache.device),
            g_chunk, cc)
        out[:, done:done + len(ts)] = blk[:, :len(ts)]
        done += len(ts)
    return out


# ---------------------------------------------------------------------------
# Large-A columns in the square all-pairs layout
# ---------------------------------------------------------------------------


def _square_point_columns(
    cache: KernelCache,
    j: int,
    bs: torch.Tensor,     # (g,) atom of each requested column (pad: 0)
    xs: torch.Tensor,     # (g,) cartesian component of each column (pad: 0)
    g_chunk: int,
    col_cache: KernelCache | None = None,
) -> torch.Tensor:
    """Requested kernel columns of ONE training point in the square layout:
    (n, g), with no (N, P, D) geometry and no incidence products.

    A compressed Jacobian column (b, x) of point j lives, on the square
    grid, on the b-cross of the antisymmetric field Gsq[j].  With the
    1/sqrt(2)-scaled square quantities the per-column pipeline reduces to
    three point-shared products (U, Z, C1; see ``_square_fields``) and
    cheap per-column elementwise work:

      col[n, a, y] = A_exp1[n, j] (delta_ab C1[n, b, x, y]
                                   - 2 Gsq[j, b, a, x] Gsq[n, b, a, y])
                     - 5 (A_exp[n, j] / sig^2) U[n, b, x] Z[n, a, y]
    """
    Xs, Gs = cache.Xsq, cache.Gsq
    cc = _col_side(cache, col_cache)
    N, A = Xs.shape[0], Xs.shape[1]
    a1j = cache.A_exp1[:, j]                                 # (N,)
    w5 = 5.0 * cache.A_exp[:, j] / cache.sig**2              # (N,) 5 base
    Gsj = cc.Gsq[j]                                          # (A, A, 3)
    if cache.Usq is not None:
        # [column point j, this cache's row points]
        U, Z, C1 = cache.Usq[j], cache.Zsq[j], cache.C1sq[j]
    else:
        # Xsq carries the matvec's q = sqrt(5)/sig; the assembly contracts
        # unscaled descriptor differences, so q comes off here
        delta = (Xs - cc.Xsq[j][None]) * (cache.sig / SQRT5)  # (N, A, A)
        U = -2.0 * torch.sum(delta[..., None] * Gsj[None], dim=2)  # (N, A, 3)
        Z = 2.0 * torch.sum(delta[..., None] * Gs, dim=1)          # (N, A, 3)
        C1 = 2.0 * torch.einsum("ibx,niby->nbxy", Gsj, Gs)         # (N, A, 3, 3)

    g = bs.shape[0]
    out = torch.empty((N * A * 3, g), dtype=Xs.dtype, device=Xs.device)
    for start in range(0, g, g_chunk):
        bc, xc = bs[start:start + g_chunk], xs[start:start + g_chunk]
        gc = bc.shape[0]
        Uc = U[:, bc, xc]                                    # (N, gc)
        Gsel = Gsj[bc, :, xc]                                # (gc, A)
        Gn = Gs[:, bc, :, :]                                 # (N, gc, A, 3)
        blk = (-a1j[:, None, None, None] * (2.0 * Gsel[None, :, :, None] * Gn)
               - (w5[:, None] * Uc)[..., None, None] * Z[:, None])
        ar = torch.arange(gc, device=Xs.device)
        blk[:, ar, bc, :] += a1j[:, None, None] * C1[:, bc, xc, :]
        # rows are (n, a, y)
        out[:, start:start + gc] = blk.permute(0, 2, 3, 1).reshape(
            N * A * 3, gc)
    return out


def _square_points_batched(cache: KernelCache, js: np.ndarray,
                           ts: torch.Tensor, g_chunk: int,
                           col_cache: KernelCache | None = None
                           ) -> torch.Tensor:
    """All requested columns of a batch of points: (n_pts, n, g_pad) for the
    points ``js`` and their partial indices ``ts`` (n_pts, g_pad)."""
    return torch.stack([_square_point_columns(cache, int(j), t // 3, t % 3,
                                              g_chunk, col_cache)
                        for j, t in zip(js, ts)])


def _square_gather_columns(blocks: torch.Tensor,
                           flat_cols: torch.Tensor) -> torch.Tensor:
    """(n_pts, n, g_pad) point blocks -> (n, k) selected columns, slot
    ``flat_cols[c] = row * g_pad + s`` being column s of point row."""
    g_pad = blocks.shape[2]
    return blocks[flat_cols // g_pad, :, flat_cols % g_pad].T.contiguous()


def assemble_columns_square(
    spec: DescriptorSpec,
    cache: KernelCache,
    col_idxs: np.ndarray,
    g_chunk: int = 8,
    col_cache: KernelCache | None = None,
) -> torch.Tensor:
    """Kernel columns K[:, col_idxs] (n, k) through the square all-pairs
    layout, the large-A route of single-perm molecules (the cache needs
    ``build_cache(..., R=...)``).  Per-point partial counts are padded to a
    common multiple of ``4 * g_chunk``; the points go in chunks whose
    (points, n, g_pad) blocks stay near 2 GB."""
    if cache.Xsq is None or cache.n_perms != 1:
        raise ValueError("assemble_columns_square needs the square fields of "
                         "build_cache(R=...) and a single permutation")
    col_idxs = np.asarray(col_idxs)
    cc = _col_side(cache, col_cache)
    T = spec.dim_i
    points = col_idxs // T
    partials = col_idxs % T
    uniq = np.unique(points)
    bucket = 4 * g_chunk
    counts = np.array([(points == j).sum() for j in uniq])
    g_pad = -(-int(counts.max()) // bucket) * bucket
    pts_chunk = max(1, min(len(uniq), int(2e9 / (cache.n * g_pad * 8))))
    dev = cache.device
    outs = []
    for c0 in range(0, len(uniq), pts_chunk):
        uc = uniq[c0:c0 + pts_chunk]
        ts = np.zeros((len(uc), g_pad), dtype=np.int64)
        flat = []
        for row, j in enumerate(uc):
            sel = partials[points == j]
            ts[row, :len(sel)] = sel
            flat.append(row * g_pad + np.arange(len(sel)))
        blocks = _square_points_batched(cache, uc,
                                        torch.as_tensor(ts, device=dev),
                                        g_chunk, cc)
        outs.append(_square_gather_columns(
            blocks, torch.as_tensor(np.concatenate(flat), device=dev)))
        del blocks
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Dense assembly (tiled), diagonal and single columns
# ---------------------------------------------------------------------------


def _is_large_D(spec: DescriptorSpec, n_perms: int) -> bool:
    """The JAX package's routing rule: above this Jacobian-inflation size it
    takes its compressed (inflation-free) paths."""
    return spec.dim * spec.dim_i * 8 * max(4, n_perms) > _INFLATION_BUDGET


def pairwise_fits(n_train: int, n_perms: int) -> bool:
    """Whether the two (N, M) f64 pairwise arrays fit (<= 3 GB): the JAX
    package's rule for ``build_cache(pairwise=...)``, whose other answer is
    the on-the-fly matvec (``_matvec_ref_otf``).  The Trainer judges it on
    the global N, so a row-sharded training takes the route its unsharded
    form would."""
    return 2 * n_train * n_train * n_perms * 8 <= int(3e9)


def square_R(R_train, spec: DescriptorSpec, n_perms: int):
    """R_train as f64 for ``build_cache(R=...)``'s square all-pairs fields,
    or None: only single-perm molecules whose descriptor size takes the
    large-D paths (``_is_large_D``) get them, as their columns assemble
    ~(D/A)x faster in the square layout."""
    if n_perms == 1 and _is_large_D(spec, n_perms):
        return np.asarray(R_train, dtype=np.float64)
    return None


def _matern_weights(delta: torch.Tensor, sig: float):
    """(base, c_iso) over the last axis of ``delta``: the two scalar weights
    of the Matern-5/2 Hessian block, base = 5 exp(-n/sig) / (3 sig^4) and
    c_iso = (sig^2 + sig n) base with n = sqrt(5) ||delta||."""
    nrm = SQRT5 * torch.linalg.norm(delta, dim=-1)
    base = (5.0 / (3.0 * sig**4)) * torch.exp(-nrm / sig)
    return base, (sig**2 + sig * nrm) * base


def assemble_block(
    spec_dim_i: int,
    cache: KernelCache,
    I_idx: torch.Tensor,
    J_idx: torch.Tensor,
    col_cache: KernelCache | None = None,
) -> torch.Tensor:
    """Dense PSD kernel block between training-point sets I (rows, of this
    cache) and J (cols, read from ``col_cache`` when given): returns
    (|I|*3A, |J|*3A).  No ridge term.

    Mirrors the reference worker math (train.py:150-236), batched over pairs
    and permutations in one einsum chain.
    """
    cc = cache if col_cache is None else col_cache
    X_I = cache.X[I_idx]                              # (B, D)
    Jf_I = _inflate_full(cache.Jc[I_idx], cache.S)    # (B, D, T)
    X_J = cc.X[J_idx][:, cache.P_idx]                 # (C, P, D)
    Jf_J = _inflate_full(cc.Jc[J_idx], cache.S)       # (C, D, T)
    Jf_Jp = Jf_J[:, cache.P_idx, :]                   # (C, P, D, T) row-permuted

    delta = X_I[:, None, None, :] - X_J[None]         # (B, C, P, D)
    base, c_iso = _matern_weights(delta, cache.sig)   # (B, C, P)

    u = torch.einsum("bcpd,cpdt->bcpt", delta, Jf_Jp)       # (B, C, P, T)
    v1 = torch.einsum("bcpd,bds->bcps", delta, Jf_I)        # (B, C, P, T)
    # the perm axis is contracted as a batched product: a fused
    # three-operand einsum would form a (B, C, P, T, T) tensor
    rank = torch.einsum("bcps,bcpt->bcst", base[..., None] * v1, u)
    W = torch.einsum("bcp,cpdt->bcdt", c_iso, Jf_Jp)        # (B, C, D, T)
    iso = torch.einsum("bds,bcdt->bcst", Jf_I, W)           # (B, C, T, T)

    blk = iso - 5.0 * rank                                  # PSD convention
    B, C, T = I_idx.shape[0], J_idx.shape[0], spec_dim_i
    return blk.permute(0, 2, 1, 3).reshape(B * T, C * T)


def assemble_full(
    spec: DescriptorSpec,
    cache: KernelCache,
    tile: int = 32,
    add_ridge: float | None = None,
) -> torch.Tensor:
    """Full dense PSD kernel matrix (n, n) on the cache's device, assembled
    in row tiles.  Equivalent to -1 * reference _assemble_kernel_mat with all
    columns (train.py:1121-1308).  ``add_ridge`` optionally adds c*I.  A
    row-sharded cache is gathered first and the whole matrix formed on
    every rank (a small-n diagnostic)."""
    cache = _unsharded(cache)
    K = torch.empty((cache.n, cache.n), dtype=cache.X.dtype,
                    device=cache.device)
    _assemble_full_into(spec.dim_i, cache, K, tile)
    if add_ridge is not None:
        K.diagonal().add_(add_ridge)
    return K


def _unsharded(cache: KernelCache) -> KernelCache:
    """The whole cache on every rank (``parallel.mesh.unshard_cache``)."""
    if cache.shard is None:
        return cache
    from ..parallel.mesh import unshard_cache
    return unshard_cache(cache)


def _assemble_full_into(T: int, cache: KernelCache, K: torch.Tensor,
                        tile: int) -> None:
    """Write the dense (n, n) PSD kernel into ``K`` (a view may be given),
    ``tile`` training points of rows at a time."""
    N = cache.n_train
    all_idx = torch.arange(N, device=cache.device)
    for start in range(0, N, tile):
        I_idx = all_idx[start:start + tile]
        K[start * T:(start + tile) * T] = assemble_block(T, cache, I_idx,
                                                         all_idx)


def _point_block_cols(spec_dim_i: int, cache: KernelCache,
                      j: torch.Tensor,
                      col_cache: KernelCache | None = None) -> torch.Tensor:
    """All-row kernel block for a single training point j, given as a (1,)
    index tensor: (n, 3A)."""
    return assemble_block(
        spec_dim_i, cache, torch.arange(cache.n_train, device=cache.device), j,
        col_cache=col_cache)


def kernel_diag(spec_dim_i: int, cache: KernelCache) -> torch.Tensor:
    """diag(K) (n,), PSD convention, no ridge (mirrors reference
    iterative_cholesky.py:241-373, which returns the negated = PSD diagonal).

    The (i, i) blocks go through the arithmetic of ``assemble_block``,
    batched over points in chunks and reduced to their diagonals before any
    (T, T) block is formed."""
    N = cache.n_train
    P, D = cache.P_idx.shape
    chunk = max(1, int(1e8) // (P * D * spec_dim_i * 8))
    out = torch.empty((N, spec_dim_i), dtype=cache.X.dtype,
                      device=cache.device)
    for start in range(0, N, chunk):
        X_i = cache.X[start:start + chunk]                   # (B, D)
        Jf = _inflate_full(cache.Jc[start:start + chunk], cache.S)  # (B, D, T)
        Jf_p = Jf[:, cache.P_idx, :]                         # (B, P, D, T)
        delta = X_i[:, None, :] - X_i[:, cache.P_idx]        # (B, P, D)
        base, c_iso = _matern_weights(delta, cache.sig)      # (B, P)
        u = torch.einsum("bpd,bpdt->bpt", delta, Jf_p)
        v1 = torch.einsum("bpd,bdt->bpt", delta, Jf)
        rank = torch.sum(base[..., None] * v1 * u, dim=1)    # (B, T)
        W = torch.einsum("bp,bpdt->bdt", c_iso, Jf_p)
        iso = torch.sum(Jf * W, dim=1)                       # (B, T)
        out[start:start + chunk] = iso - 5.0 * rank
    return out.reshape(-1)


def kernel_diag_compressed(spec_dim_i: int,
                           cache: KernelCache) -> torch.Tensor:
    """diag(K) (n,) without Jacobian inflation, for large-D molecules.

    For point i and partial t = (b, x) the two terms of the Matern-5/2
    Hessian contraction reduce to compressed-Jacobian contractions:

      isotropic:    sum_q S[q,b] S[P_p[q],b] Jc[q,x] Jc[P_p[q],x]
      anisotropic:  -5 base_p v_p[b,x] vt_p[b,x] with
                    v_p  = vec_dot_d_desc(Jc_i, S, delta_p)
                    vt_p = vec_dot_d_desc(Jc_i, S, delta_p[Pinv_p]).

    Cost O(N P D A); memory O(P D + D A)."""
    Pinv = torch.argsort(cache.P_idx, dim=1)                 # (P, D)
    out = torch.empty((cache.n_train, spec_dim_i), dtype=cache.X.dtype,
                      device=cache.device)
    for i in range(cache.n_train):
        Jc_i, X_i = cache.Jc[i], cache.X[i]
        delta = X_i[None, :] - X_i[cache.P_idx]              # (P, D)
        base, c_iso = _matern_weights(delta, cache.sig)      # (P,)
        acc = torch.zeros((spec_dim_i // 3, 3), dtype=cache.X.dtype,
                          device=cache.device)
        for p in range(cache.n_perms):
            Pp = cache.P_idx[p]
            g = Jc_i * Jc_i[Pp]                              # (D, 3)
            termA = (cache.S * cache.S[Pp]).T @ g            # (A, 3)
            v = vec_dot_d_desc(Jc_i, cache.S, delta[p])
            vt = vec_dot_d_desc(Jc_i, cache.S, delta[p][Pinv[p]])
            acc += c_iso[p] * termA - 5.0 * base[p] * v * vt
        out[i] = acc.reshape(-1)
    return out.reshape(-1)


def kernel_diag_any(spec: DescriptorSpec, cache: KernelCache) -> torch.Tensor:
    """diag(K): the inflating path for small D, the compressed path for
    large D (the routing rule of ``assemble_columns``)."""
    if _is_large_D(spec, cache.n_perms):
        return kernel_diag_compressed(spec.dim_i, cache)
    return kernel_diag(spec.dim_i, cache)


def _column_index(cache: KernelCache, col, T: int):
    """(col, point, atom, xyz) of a column given as an int or a one-element
    index tensor, as (1,) tensors on the cache's device."""
    col = torch.as_tensor(col, dtype=torch.int64,
                          device=cache.device).reshape(1)
    t = col % T
    return col, col // T, t // 3, t % 3


def _add_ridge_at(cache: KernelCache, out: torch.Tensor, col: torch.Tensor
                  ) -> torch.Tensor:
    """out[col] += lam for a global row ``col`` ((1,) tensor): on a
    row-sharded cache only its owner's row, with no host read."""
    if cache.shard is None:
        out[col] += cache.lam
        return out
    return vector_layout(cache).add_at(out, col, cache.lam)


def kernel_column(spec_dim_i: int, cache: KernelCache, col,
                  col_cache: KernelCache | None = None) -> torch.Tensor:
    """Single column of (K + lam*I), (n,): direct assembly of only the
    requested partial, O(n * P * D).

    ``col`` is an int or an integer tensor of one element on the cache's
    device.  With a tensor nothing is read back to the host, so a loop that
    picks its next column on the device (the greedy pivoted Cholesky) queues
    its steps without a round trip.  The JAX package assembles the owning
    point's whole (n, 3A) block and takes one column of it; the column is
    the same.  On a row-sharded cache ``col`` is global and the result this
    cache's rows; the column point is read from ``col_cache``
    (``_col_side``, gathered here when not given)."""
    col, j, b, x = _column_index(cache, col, spec_dim_i)
    cc = _col_side(cache, col_cache)
    Pj = cache.P_idx                                         # (P, D)
    jcol = (cc.Jc[j][0][Pj].index_select(2, x)[..., 0]
            * cache.S[Pj].index_select(2, b)[..., 0])        # (P, D)
    Xt_j = cc.X[j][0][Pj]                                    # (P, D)
    delta = cache.X[:, None, :] - Xt_j[None]                 # (N, P, D)
    base, c_iso = _matern_weights(delta, cache.sig)          # (N, P)
    u = torch.einsum("npd,pd->np", delta, jcol)              # (N, P)
    G = c_iso @ jcol - 5.0 * torch.einsum("np,npd->nd", base * u, delta)
    out = vec_dot_d_desc(cache.Jc, cache.S, G).reshape(-1)   # (n,)
    return _add_ridge_at(cache, out, col)


def kernel_column_compressed(spec_dim_i: int, cache: KernelCache,
                             col, col_cache: KernelCache | None = None
                             ) -> torch.Tensor:
    """Single column of (K + lam*I) without Jacobian inflation, the large-D
    route of the greedy pivoted Cholesky; ``col`` and ``col_cache`` as in
    ``kernel_column`` (a one-element tensor reads nothing back)."""
    col, j, b, x = _column_index(cache, col, spec_dim_i)
    out = _columns_compressed_chunk(cache, j, b, x, col_cache)[0]
    return _add_ridge_at(cache, out, col)


# ---------------------------------------------------------------------------
# Energy-constraint extension (use_E_cstr)
# ---------------------------------------------------------------------------
#
# With energy constraints the system grows by n_train rows and columns that
# couple force coefficients to per-point energies (reference train.py:212-234
# for assembly, predict.py:210-218 for the matvec).  Every extra kernel value
# is an elementwise function of the cached pairwise weights:
#   cross block  K_fe ~ A_exp1 * delta          (gradient cross-kernel)
#   energy block K_ee ~ (1 + d(1 + d/3)) e^-d   (plain Matern-5/2)
# so every function below needs the pairwise cache, as in the JAX package.


def require_pairwise(cache: KernelCache) -> None:
    """Raise ValueError unless the cache holds the (N, M) pairwise weights,
    from which every energy-constraint block is recovered."""
    if cache.A_exp is None:
        raise ValueError(
            "energy constraints need the pairwise kernel cache "
            "(build_cache(pairwise=True)): the energy blocks are recovered "
            "from its (N, M) weights, and an on-the-fly cache has none")


def _ecstr_mats(cache: KernelCache):
    """(K_ee (N, M), dist) recovered elementwise from the cached matrices."""
    require_pairwise(cache)
    dist = cache.A_exp1 / cache.A_exp - 1.0
    e = cache.A_exp * (3.0 * cache.sig**2 / 5.0)
    K_ee = (1.0 + dist * (1.0 + dist / 3.0)) * e
    return K_ee, dist


def matvec_ref_ecstr(cache: KernelCache, v: torch.Tensor) -> torch.Tensor:
    """Reference-convention matvec of the energy-constrained kernel:
    v = [v_F (n,), v_E (N,)] -> [f_out (n,), -e_out (N,)], the reference's
    ``_K_vec`` composition (iterative_solver.py:416-443: predict with alphas
    (v_F, v_E), stack forces with negated energies)."""
    K_ee, _ = _ecstr_mats(cache)
    N = cache.n_train
    A = cache.S.shape[1]
    v_F, v_E = v[:N * A * 3], v[N * A * 3:]
    w = d_desc_dot_vec(cache.Jc, cache.S, v_F.reshape(N, A, 3))   # (N, D)
    if cache.shard is not None:
        # the rank's part is [its force entries, its energy entries]: one
        # all-gather brings every point's cotangents and energy coefficient
        wE = cache.shard.gather(torch.cat([w, v_E[:, None]], dim=1))
        w, v_E = wE[:, :-1], wE[:, -1]
    wt = perm_expand_w(_at_cache_dtype(cache, w), cache.P_idx)    # (M, D)
    vE_lin = torch.repeat_interleave(v_E, cache.n_perms).to(wt.dtype)  # (M,)
    # e_out starts as sum_m A_exp1 dot / q (predict.py:207)
    F_desc, e_out = energy_coef_terms(
        cache.Xq, cache.Xqt, cache.sig, cache.A_exp1, vE_lin,
        *desc_forces(cache.Xqt, cache.sig, cache.Xq, cache.A_exp,
                     cache.A_exp1, wt), K_ee)
    out_F = vec_dot_d_desc(cache.Jc, cache.S, F_desc.to(cache.Jc.dtype))
    return torch.cat([out_F.reshape(-1), -e_out.to(out_F.dtype)])


def matvec_psd_ecstr(cache: KernelCache, v: torch.Tensor) -> torch.Tensor:
    """(K + lam I) v for the energy-constrained PSD system."""
    return cache.lam * v - matvec_ref_ecstr(cache, v)


def assemble_ecstr_blocks(spec_dim_i: int, cache: KernelCache):
    """Dense energy-constraint blocks in the PSD convention:
    (K_fe (n, N), K_ee_sym (N, N)), the extra columns and rows of the
    extended kernel (reference worker train.py:212-234, negated).

    The cross block goes column point by column point, 64 at a time, so
    that no (N, M, D) array forms: per block three (N, 64 P, D) transients.
    On a row-sharded cache both blocks hold this cache's rows and every
    column.
    """
    K_ee, _ = _ecstr_mats(cache)                      # (N, M)
    N = cache.n_train_global                          # column points
    Nr = cache.n_train                                # row points
    P = cache.n_perms
    q = SQRT5 / cache.sig
    # sum over the perm copies of each column point -> (N, N); the reference
    # writes K[E_i, E_j] = -(...) summed over perms
    K_ee_sym = K_ee.reshape(Nr, N, P).sum(dim=2)
    del K_ee
    # cross block: for column point j (energy) and rows (i, t):
    #   K_ref[F(i,t), E(j)] = sum_p A_exp1[i,(j,p)] (J_i^T delta_i,(j,p))[t]
    # with delta = (Xq_i - Xqt_m) / q, unscaled
    A1 = cache.A_exp1
    cols = []
    for j0 in range(0, N, 64):
        j1 = min(j0 + 64, N)
        mm = slice(j0 * P, j1 * P)
        A1b = A1[:, mm]                                   # (N, Mb)
        g1 = cache.Xq[:, None, :] * A1b[:, :, None]       # (N, Mb, D)
        g2 = A1b[:, :, None] * cache.Xqt[mm][None, :, :]
        g = (g1 - g2) / q
        del g1, g2
        g = g.reshape(Nr, j1 - j0, P, -1).sum(dim=2)      # (N, Cb, D)
        blk = vec_dot_d_desc(cache.Jc[:, None], cache.S, g)   # (N, Cb, A, 3)
        cols.append(blk.reshape(Nr, j1 - j0, -1))
    K_fe_ref = torch.cat(cols, dim=1)                     # (N, N, 3A)
    K_fe_ref = K_fe_ref.permute(0, 2, 1).reshape(Nr * spec_dim_i, N)
    # the row-Jacobian form equals the reference's column-Jacobian form under
    # group closure (the worker's -sum over permuted J~ at train.py:228,
    # relabelled); the PSD convention then negates both blocks
    return -K_fe_ref, K_ee_sym


def assemble_columns_ecstr(
    spec: DescriptorSpec,
    cache: KernelCache,
    col_idxs: np.ndarray,
    chunk: int = 8,
    K_fe: torch.Tensor | None = None,
) -> torch.Tensor:
    """Columns of the energy-constrained PSD kernel restricted to force
    columns (col < n): (n + N, k), the force-block columns with their
    energy-row extension appended.  ``K_fe`` (n, N) from
    ``assemble_ecstr_blocks`` may be passed in, so that a build that takes
    its columns in several calls assembles it once."""
    col_idxs = np.asarray(col_idxs)
    if col_idxs.max() >= cache.n_global:
        raise ValueError("only force columns are supported as inducing points")
    if K_fe is None:
        K_fe, _ = assemble_ecstr_blocks(spec.dim_i, cache)
    top = assemble_columns(spec, cache, col_idxs, chunk=chunk)   # (n, k)
    idx = torch.as_tensor(col_idxs, device=cache.device)
    if cache.shard is None:
        return torch.cat([top, K_fe[idx].T], dim=0)
    # the energy rows of force column c are K_fe's row c (its owner's),
    # restricted to this cache's energy rows
    rows_fe = vector_layout(cache).take(K_fe, idx)
    r = slice(cache.row0, cache.row0 + cache.n_train)
    return torch.cat([top, rows_fe[:, r].T], dim=0)


def kernel_diag_ecstr(spec_dim_i: int, cache: KernelCache) -> torch.Tensor:
    """diag of the energy-constrained PSD kernel (n + N,), no ridge:
    [diag(K_ff), diag(K_ee_sym)] (reference iterative_cholesky.py:351-373
    appends the energy-block diagonal)."""
    K_ee, _ = _ecstr_mats(cache)                      # (N, M = N P)
    N = cache.n_train
    i = torch.arange(N, device=cache.device)
    d_ee = K_ee.reshape(N, cache.n_train_global, cache.n_perms)[
        i, i + cache.row0].sum(dim=1)
    return torch.cat([kernel_diag(spec_dim_i, cache), d_ee])


def assemble_columns_ecstr_any(
    spec: DescriptorSpec,
    cache: KernelCache,
    col_idxs: np.ndarray,
    chunk: int = 8,
    blocks: tuple | None = None,
) -> torch.Tensor:
    """Columns of the energy-constrained PSD kernel for any sorted column
    indices in [0, n + N), force and energy columns mixed (the
    pivoted-Cholesky family pivots over the whole extended diagonal).
    Returns (n + N, k), no ridge.  ``blocks`` = ``assemble_ecstr_blocks``'s
    (K_fe, K_ee_sym) may be passed in, as ``K_fe`` is to
    ``assemble_columns_ecstr``."""
    col_idxs = np.asarray(col_idxs)
    if not np.array_equal(col_idxs, np.sort(col_idxs)):
        raise ValueError("column indices must be sorted")
    n = cache.n_global
    K_fe, K_ee_sym = blocks if blocks is not None else assemble_ecstr_blocks(
        spec.dim_i, cache)
    f_idx = col_idxs[col_idxs < n]
    e_idx = torch.as_tensor(col_idxs[col_idxs >= n] - n, device=cache.device)
    parts = []
    if len(f_idx):
        parts.append(assemble_columns_ecstr(spec, cache, f_idx, chunk=chunk,
                                            K_fe=K_fe))
    if len(e_idx):
        parts.append(torch.cat([K_fe[:, e_idx], K_ee_sym[:, e_idx]], dim=0))
    # sorted input: every force column precedes every energy column
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


def assemble_full_ecstr(spec: DescriptorSpec, cache: KernelCache,
                        tile: int = 32) -> torch.Tensor:
    """Full PSD kernel with the energy-constraint rows and columns appended:
    (n + N, n + N) (reference train.py:1205-1208), written into one array
    (a row-sharded cache is gathered first, as for ``assemble_full``)."""
    cache = _unsharded(cache)
    n, N = cache.n, cache.n_train
    K_fe, K_ee = assemble_ecstr_blocks(spec.dim_i, cache)
    K = torch.empty((n + N, n + N), dtype=cache.X.dtype, device=cache.device)
    _assemble_full_into(spec.dim_i, cache, K[:n, :n], tile)
    K[:n, n:] = K_fe
    K[n:, :n] = K_fe.T
    K[n:, n:] = K_ee
    return K
