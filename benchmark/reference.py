"""The plain reference of the sGDML force field: plain PyTorch, no kernel,
no cache, nothing of the program.

A model is training geometries R_j (N, A, 3) with coefficients a_j (N, A, 3)
in the stored-model convention, a permutation group (P, A), the length
scale sigma, the label scale ``std`` and the energy offset ``c``.  For a
query geometry r with inverse-distance descriptor x (D = A (A - 1) / 2;
pairs (i, j) with i > j in ``np.tril_indices`` order):

    x_{j,p} = desc(R_j[perm_p]),   w_{j,p} = J(R_j[perm_p]) a_j[perm_p]
    d = x - x_{j,p},  s = sqrt(5) |d| / sigma
    E(r) = std * sum_{j,p} 5 / (3 sigma^2) exp(-s) (1 + s) (d . w_{j,p}) + c
    F(r) = -grad_r E(r)

with J(R) the Jacobian of the descriptor and J(R) a its product with a
3A-vector.  The gradient is written out: dE/dx = sum 5 exp(-s) / (3
sigma^4) [(sigma^2 + sigma sqrt(5) |d|) w - 5 (d . w) d], then F = -J^T
dE/dx.  The PSD training operator of the same model is K a = -F(R_i; a)
at std 1: the forces the coefficients predict at the training points.

Everything runs in the dtype asked for (float64 for the reference,
float32 for its control), in blocks of queries that keep the (B, N P, D)
differences near 256 MB.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SQRT5 = math.sqrt(5.0)
BLOCK_BYTES = 2**28


def _pairs(n_atoms: int):
    rows, cols = np.tril_indices(n_atoms, -1)
    return torch.as_tensor(rows), torch.as_tensor(cols)


def descriptors(R: torch.Tensor) -> torch.Tensor:
    """(S, A, 3) -> (S, D): 1 / |r_i - r_j| over the pairs i > j."""
    rows, cols = _pairs(R.shape[1])
    rows, cols = rows.to(R.device), cols.to(R.device)
    return 1.0 / torch.linalg.norm(R[:, rows] - R[:, cols], dim=-1)


def _pair_gradients(R: torch.Tensor):
    """(g (S, D, 3), rows, cols): d x_q / d r_{col_q} = g_q and
    d x_q / d r_{row_q} = -g_q for x_q = 1 / |r_row - r_col|."""
    rows, cols = _pairs(R.shape[1])
    rows, cols = rows.to(R.device), cols.to(R.device)
    diff = R[:, rows] - R[:, cols]
    dist = torch.linalg.norm(diff, dim=-1)
    return diff / (dist**3)[..., None], rows, cols


def jacobian_apply(R: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """J(R) a: (S, A, 3) geometries and 3A-vectors -> (S, D)."""
    g, rows, cols = _pair_gradients(R)
    return torch.sum(g * (a[:, cols] - a[:, rows]), dim=-1)


def jacobian_transpose(R: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """J(R)^T f: (S, A, 3) geometries and (S, D) covectors -> (S, A, 3)."""
    g, rows, cols = _pair_gradients(R)
    gf = g * f[..., None]
    out = torch.zeros_like(R)
    out.index_add_(1, cols, gf)
    out.index_add_(1, rows, -gf)
    return out


class Model:
    """A model as the reference sees it: every permuted training descriptor
    and cotangent, on ``device`` in ``dtype``."""

    def __init__(self, R_train, a, perms, sig: float, std: float = 1.0,
                 c: float = 0.0, device="cpu", dtype=torch.float64):
        R = torch.as_tensor(np.asarray(R_train), dtype=dtype, device=device)
        a = torch.as_tensor(np.asarray(a), dtype=dtype,
                            device=device).reshape(R.shape)
        perms = torch.as_tensor(np.asarray(perms), dtype=torch.int64,
                                device=device)
        xs, ws = [], []
        for p in perms:
            xs.append(descriptors(R[:, p]))
            ws.append(jacobian_apply(R[:, p], a[:, p]))
        self.Xt = torch.cat(xs)          # (N P, D)
        self.Wt = torch.cat(ws)          # (N P, D)
        self.sig, self.std, self.c = float(sig), float(std), float(c)
        self.device, self.dtype = device, dtype

    def predict(self, R) -> tuple[np.ndarray, np.ndarray]:
        """(E (S,), F (S, A, 3)) as f64 NumPy arrays, for geometries R."""
        R = torch.as_tensor(np.asarray(R), dtype=self.dtype,
                            device=self.device)
        M, D = self.Xt.shape
        block = max(1, BLOCK_BYTES // (M * D * 8))
        Es, Fs = [], []
        for s in range(0, R.shape[0], block):
            E, F = self._predict_block(R[s:s + block])
            Es.append(E.double().cpu().numpy())
            Fs.append(F.double().cpu().numpy())
        return np.concatenate(Es), np.concatenate(Fs)

    def _predict_block(self, R: torch.Tensor):
        sig = self.sig
        x = descriptors(R)                                  # (B, D)
        d = x[:, None, :] - self.Xt[None]                   # (B, M, D)
        r = torch.linalg.norm(d, dim=-1)                    # (B, M)
        s = (SQRT5 / sig) * r
        ex = torch.exp(-s)
        dw = torch.einsum("bmd,md->bm", d, self.Wt)
        E = (5.0 / (3.0 * sig**2)) * torch.sum(ex * (1.0 + s) * dw, dim=1)
        base = 5.0 * ex / (3.0 * sig**4)
        dE_dx = (torch.einsum("bm,md->bd", base * (sig**2 + sig * SQRT5 * r),
                              self.Wt)
                 - torch.einsum("bm,bmd->bd", 5.0 * base * dw, d))
        F = -jacobian_transpose(R, dE_dx)
        return E * self.std + self.c, F * self.std


def model_arrays(R_train, a, device="cpu", dtype=torch.float64):
    """The stored-model arrays that the reference derives from training
    geometries and coefficients: ``R_desc`` (D, N) and ``R_d_desc_alpha``
    (N, D), as f64 NumPy arrays."""
    R = torch.as_tensor(np.asarray(R_train), dtype=dtype, device=device)
    a = torch.as_tensor(np.asarray(a), dtype=dtype,
                        device=device).reshape(R.shape)
    return (descriptors(R).T.double().cpu().numpy(),
            jacobian_apply(R, a).double().cpu().numpy())
