"""Batched energy/force prediction from a trained model.

PyTorch port of ``mlff_tpu.models.predict`` (reference: sgdml/predict.py:
72-234, 997-1110; sgdml/torchtools.py:172-326): one descriptor-space
contraction batched over query geometries.

``fast=True`` routes the contraction through the fused kernel
(``ops.fused_predict``): on a CUDA device it launches the hand-written kernel
(a kernel that fails to build or launch raises), on the CPU it runs the
kernel's plain PyTorch version.  Both paths are f64: the kernel keeps the
(B, M) exponential weights out of device memory, not digits.

Sign conventions follow the stored-model (reference) convention:
``alphas_F`` as the reference stores them, energies carrying the trained -E
flip fixed up by the integration constant ``c``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..ops import descriptor as dsc
from ..ops import kernel as knl
from ..ops.fused_predict import desc_forces_fused


class Predictor:
    """Evaluate a trained (s)GDML model on query geometries on ``device``
    (cuda by default)."""

    def __init__(self, model: dict, batch_size: int | None = None,
                 fast: bool = False, device=None):
        self.device = dev = resolve_device(device)
        self.model = model
        n_atoms = int(np.asarray(model["z"]).shape[0])
        self.spec = dsc.make_spec(n_atoms)
        self.S = dsc.incidence_matrix(self.spec, device=dev)

        # reference stores R_desc transposed (D, N): train.py:664
        X = torch.as_tensor(np.array(model["R_desc"]).T,
                            dtype=torch.float64, device=dev)
        self.n_train = X.shape[0]
        perms = np.asarray(model["perms"])
        self.P_idx = torch.as_tensor(dsc.desc_perms(perms), device=dev)
        self.sig = float(model["sig"])
        self.std = float(model.get("std", 1.0))
        self.c = float(model.get("c", 0.0))

        q = knl.SQRT5 / self.sig
        self.Xqt = knl.permuted_descriptors(q * X, self.P_idx)   # (M, D)
        # w~: permuted per-point descriptor cotangents J^T alpha
        w = torch.as_tensor(np.array(model["R_d_desc_alpha"]),
                            dtype=torch.float64, device=dev)     # (N, D)
        self.wt = knl.perm_expand_w(w, self.P_idx)               # (M, D)

        # energy-constraint coefficients, tiled per (point, perm)
        # (reference predict.py set_alphas: alphas_E_lin, :437-447)
        self.vE_lin = None
        if "alphas_E" in model and model["alphas_E"] is not None:
            aE = np.asarray(model["alphas_E"]).ravel()
            if aE.size == self.n_train:
                self.vE_lin = torch.as_tensor(
                    np.repeat(aE, perms.shape[0]), dtype=torch.float64,
                    device=dev)                                   # (M,)

        self.lat_and_inv = None
        if "lattice" in model:
            lat = np.asarray(model["lattice"], dtype=np.float64)
            self.lat_and_inv = (
                torch.as_tensor(lat, device=dev),
                torch.as_tensor(np.linalg.inv(lat), device=dev))

        if batch_size is None:
            # keep the (B, M) distance/exponential intermediates ~<= 1 GiB
            M = self.Xqt.shape[0]
            batch_size = max(1, min(512, int(2**27 / max(M, 1))))
        self.batch_size = batch_size

        if fast and self.vE_lin is not None:
            raise NotImplementedError(
                "the fused prediction kernel has no energy-constraint "
                "terms; use fast=False for energy-constrained models")
        self.fast = bool(fast)

    @classmethod
    def from_alphas(cls, task_like: dict, R_desc, R_d_desc, alphas_F,
                    std=1.0, device=None):
        """Build a predictor directly from raw training data + coefficients
        (used by integration-constant recovery before a model dict exists)."""
        spec = dsc.make_spec(np.asarray(task_like["z"]).shape[0])
        S = dsc.incidence_matrix(spec)
        R_d_desc = torch.as_tensor(np.asarray(R_d_desc), dtype=torch.float64)
        w = dsc.d_desc_dot_vec(
            R_d_desc, S,
            torch.as_tensor(np.asarray(alphas_F), dtype=torch.float64
                            ).reshape(len(R_desc), -1, 3))
        model = {
            "z": np.asarray(task_like["z"]),
            "R_desc": np.asarray(R_desc).T,
            "R_d_desc_alpha": w.numpy(),
            "perms": np.asarray(task_like["perms"]),
            "sig": task_like["sig"],
            "std": std,
            "c": 0.0,
        }
        if "lattice" in task_like:
            model["lattice"] = task_like["lattice"]
        return cls(model, device=device)

    def _query_descriptors(self, R_batch: torch.Tensor):
        X_query, Jc_query = dsc.descriptor(self.spec, R_batch,
                                           lat_and_inv=self.lat_and_inv)
        return (knl.SQRT5 / self.sig) * X_query, Jc_query

    def _predict_batch_fast(self, R_batch: torch.Tensor):
        """Fused-kernel contraction (forces/energies, no E constraints)."""
        Xq_query, Jc_query = self._query_descriptors(R_batch)
        F_desc, E = desc_forces_fused(Xq_query.contiguous(), self.Xqt,
                                      self.wt, self.sig)
        F = dsc.vec_dot_d_desc(Jc_query, self.S, F_desc) * self.std
        return E * self.std + self.c, F

    def _predict_batch_impl(self, R_batch: torch.Tensor):
        """(B, A, 3) -> energies (B,), forces (B, A, 3), f64."""
        Xq_query, Jc_query = self._query_descriptors(R_batch)
        q = knl.SQRT5 / self.sig
        dist = knl.pairwise_dist_gram(Xq_query, self.Xqt)
        A_exp = (5.0 / (3.0 * self.sig**2)) * torch.exp(-dist)
        A_exp1 = A_exp * (1.0 + dist)
        F_desc, E = knl._desc_forces_x(self.Xqt, self.sig, Xq_query, A_exp,
                                       A_exp1, self.wt)
        if self.vE_lin is not None:
            # energy-coefficient contributions (reference predict.py:210-218)
            H = A_exp1 * self.vE_lin[None, :]
            F_desc = F_desc + (
                Xq_query * torch.sum(H, dim=1, keepdim=True) - H @ self.Xqt
            ) / q
            K_ee = (1.0 + dist * (1.0 + dist / 3.0)) * torch.exp(-dist)
            E = E + K_ee @ self.vE_lin
        F = dsc.vec_dot_d_desc(Jc_query, self.S, F_desc) * self.std
        return E * self.std + self.c, F

    def predict(self, R):
        """R (M, A, 3) or (M, 3A) -> (E (M,), F (M, A, 3)) as NumPy arrays."""
        R = torch.as_tensor(np.asarray(R), dtype=torch.float64).reshape(
            -1, self.spec.n_atoms, 3)
        run = self._predict_batch_fast if self.fast else self._predict_batch_impl
        Es, Fs = [], []
        for start in range(0, R.shape[0], self.batch_size):
            batch = R[start:start + self.batch_size].to(self.device)
            E, F = run(batch)
            Es.append(E.cpu().numpy())
            Fs.append(F.cpu().numpy())
        if not Es:
            return np.zeros(0), np.zeros((0, self.spec.n_atoms, 3))
        return np.concatenate(Es), np.concatenate(Fs)
