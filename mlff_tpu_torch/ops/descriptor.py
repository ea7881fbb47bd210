"""Inverse-pairwise-distance descriptors and their compressed Jacobians.

PyTorch port of ``mlff_tpu.ops.descriptor`` (reference:
src/sGDML/sgdml/utils/desc.py:44-483).  Geometries carry a leading batch
dimension instead of a ``vmap``; everything else keeps the JAX package's
layout so the two agree entry by entry:

  * descriptor ordering = np.tril_indices(A, -1) pairs (row > col),
  * pdiff_q = r[row_q] - r[col_q],  J_comp[q] = pdiff_q / pdist_q**3,
  * the implied full Jacobian is J_full[q, col_q] = +J_comp[q],
    J_full[q, row_q] = -J_comp[q]  (reference desc.py:444-462).

Both compressed-Jacobian contractions are products with the static +/-1
incidence matrix ``S`` (D, A).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class DescriptorSpec(NamedTuple):
    """Static host metadata describing the descriptor layout."""

    n_atoms: int
    rows: np.ndarray  # (D,) first atom of each pair (tril row,  i > j)
    cols: np.ndarray  # (D,) second atom of each pair (tril col)

    @property
    def dim(self) -> int:
        return self.rows.shape[0]

    @property
    def dim_i(self) -> int:
        return 3 * self.n_atoms


def make_spec(n_atoms: int) -> DescriptorSpec:
    rows, cols = np.tril_indices(n_atoms, -1)
    return DescriptorSpec(n_atoms=n_atoms, rows=rows, cols=cols)


def incidence_matrix(spec: DescriptorSpec, device=None) -> torch.Tensor:
    """Static (D, A) f64 matrix with S[q, col_q] = +1, S[q, row_q] = -1."""
    D, A = spec.dim, spec.n_atoms
    S = np.zeros((D, A), dtype=np.float64)
    S[np.arange(D), spec.cols] = 1.0
    S[np.arange(D), spec.rows] = -1.0
    return torch.as_tensor(S, dtype=torch.float64, device=device)


def _min_image(diffs: torch.Tensor, lat: torch.Tensor,
               lat_inv: torch.Tensor) -> torch.Tensor:
    """Minimum-image convention (reference desc.py:44-77).  ``torch.round``
    rounds half to even, like ``jnp.round``."""
    c = diffs @ lat_inv.T
    return diffs - torch.round(c) @ lat.T


def pair_diffs(spec: DescriptorSpec, r: torch.Tensor,
               lat_and_inv=None) -> torch.Tensor:
    """(..., D, 3) pairwise differences r[row_q] - r[col_q] for geometries
    (..., A, 3)."""
    rows = torch.as_tensor(spec.rows, device=r.device)
    cols = torch.as_tensor(spec.cols, device=r.device)
    d = r[..., rows, :] - r[..., cols, :]
    if lat_and_inv is not None:
        d = _min_image(d, lat_and_inv[0], lat_and_inv[1])
    return d


def descriptor(
    spec: DescriptorSpec,
    r: torch.Tensor,
    lat_and_inv=None,
    interact_cut_off: float | None = None,
    cut_off_slope: float = 10.0,
):
    """Descriptors (..., D) and compressed Jacobians (..., D, 3) of
    geometries (..., A, 3).

    With ``interact_cut_off`` set, a sigmoid interaction cutoff multiplies the
    descriptor (reference desc.py:136-144) and the Jacobian is the exact
    derivative of the cutoff descriptor, as in the JAX package.
    """
    diffs = pair_diffs(spec, r, lat_and_inv)
    dist = torch.linalg.norm(diffs, dim=-1)

    if interact_cut_off is None:
        desc = 1.0 / dist
        j_comp = diffs / (dist**3)[..., None]
    else:
        c = 1.0 - torch.sigmoid(cut_off_slope * (dist - interact_cut_off))
        desc = c / dist
        c_prime = -cut_off_slope * c * (1.0 - c)
        dd = (c_prime * dist - c) / dist**2
        j_comp = (-dd / dist)[..., None] * diffs
    return desc, j_comp


def descriptors_from_R(
    spec: DescriptorSpec,
    R: torch.Tensor,
    lat_and_inv=None,
    interact_cut_off: float | None = None,
):
    """Batched descriptors: R (M, A, 3) or (M, 3A) -> (M, D), (M, D, 3)."""
    return descriptor(spec, R.reshape(-1, spec.n_atoms, 3),
                      lat_and_inv=lat_and_inv,
                      interact_cut_off=interact_cut_off)


def d_desc_dot_vec(Jc: torch.Tensor, S: torch.Tensor,
                   vecs: torch.Tensor) -> torch.Tensor:
    """Right-multiply compressed Jacobian(s) by 3A-vector(s).

    Jc (..., D, 3), vecs (..., A, 3) -> (..., D):
        w_q = J_q . (v[col_q] - v[row_q])   (reference desc.py:394-405).
    """
    sv = torch.einsum("qa,...ax->...qx", S, vecs)
    return torch.sum(Jc * sv, dim=-1)


def vec_dot_d_desc(Jc: torch.Tensor, S: torch.Tensor,
                   f: torch.Tensor) -> torch.Tensor:
    """Left-multiply: descriptor-space cotangent f (..., D) back to atoms,
    (..., A, 3): out[b] = sum_q f_q J_q S[q, b]  (reference desc.py:408-428)."""
    jf = Jc * f[..., None]
    return torch.einsum("qa,...qx->...ax", S, jf)


def inflate_jacobian(Jc: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """Full (D, 3A) Jacobian from the compressed (D, 3) form
    (reference desc.py:444-462 ``d_desc_from_comp``)."""
    full = S[:, :, None] * Jc[:, None, :]   # (D, A, 3)
    return full.reshape(Jc.shape[0], -1)


def perm_to_desc_perm(perm: np.ndarray) -> np.ndarray:
    """Atom permutation (A,) -> descriptor permutation (D,)
    (reference desc.py:360-389).  Host NumPy."""
    n = len(perm)
    rest = np.zeros((n, n))
    rest[np.tril_indices(n, -1)] = np.arange((n**2 - n) // 2)
    rest = rest + rest.T
    rest = rest[perm, :][:, perm]
    return rest[np.tril_indices(n, -1)].astype(int)


def desc_perms(perms: np.ndarray) -> np.ndarray:
    """Stack of descriptor permutations (P, D) for atom permutations (P, A):
    desc(permuted geometry p) = desc[desc_perms[p]]."""
    return np.stack([perm_to_desc_perm(p) for p in np.asarray(perms)])
