"""Batched energy/force prediction from a trained model.

PyTorch port of ``mlff_tpu.models.predict`` (reference: sgdml/predict.py:
72-234, 997-1110; sgdml/torchtools.py:172-326): one descriptor-space
contraction batched over query geometries.

``fast=True`` routes the contraction through the fused kernel
(``ops.fused_predict``): on a CUDA device it launches the hand-written kernel
(a kernel that fails to build or launch raises), on the CPU it runs the
kernel's plain PyTorch version.  A model with energy-constraint
coefficients predicts through the f64 contraction whatever ``fast`` says,
as in the JAX package.  Both paths are f64: the kernel keeps the
(B, M) exponential weights out of device memory, not digits.

``mesh``: a ``torch.distributed`` DeviceMesh splits each query batch over
its ranks (the reference's multi-GPU DataParallel split, predict.py:336-341),
each rank contracting its geometries against the whole training side, and
gathers the results onto every rank.  The batch size is rounded up to a
multiple of the mesh size and a short batch is padded with its last
geometry to a multiple of the mesh size (the JAX package pads it to the
whole batch, its compiled shape).  ``fast`` is off on a mesh, the JAX
package's routing rule.

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
from ..utils import trace
from ..utils.log import get_logger

log = get_logger(__name__)


class Predictor:
    """Evaluate a trained (s)GDML model on query geometries on ``device``
    (cuda by default), split over ``mesh`` when one is given."""

    def __init__(self, model: dict, batch_size: int | None = None,
                 fast: bool = False, device=None, mesh=None):
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
        # contiguous once, whatever layout the gathers below produce: the
        # fused kernel takes contiguous operands only
        self.Xqt = knl.permuted_descriptors(
            q * X, self.P_idx).contiguous()                      # (M, D)
        # w~: permuted per-point descriptor cotangents J^T alpha
        w = torch.as_tensor(np.array(model["R_d_desc_alpha"]),
                            dtype=torch.float64, device=dev)     # (N, D)
        self.wt = knl.perm_expand_w(w, self.P_idx).contiguous()  # (M, D)

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
        self.shard = None
        if mesh is not None:
            from ..parallel.mesh import row_shard

            self.shard = row_shard(mesh)
            w = self.shard.world
            batch_size = max(w, -(-batch_size // w) * w)
        self.batch_size = batch_size

        # the JAX package's routing rule (models/predict.py:106-109): the
        # fused contraction carries no energy-constraint terms, so a model
        # with them predicts through the f64 contraction, as does a mesh
        self.fast = bool(fast) and self.vE_lin is None and mesh is None
        if fast and self.vE_lin is not None:
            log.info("Predictor(fast=True): the model carries energy "
                     "constraints, which the fused kernel does not; "
                     "predicting through the f64 contraction")
        elif fast and mesh is not None:
            log.info("Predictor(fast=True, mesh=...): a mesh predicts "
                     "through the f64 contraction, as in the JAX package")

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
        with trace.span("predict.descriptors"):
            X_query, Jc_query = dsc.descriptor(self.spec, R_batch,
                                               lat_and_inv=self.lat_and_inv)
            return (knl.SQRT5 / self.sig) * X_query, Jc_query

    def _backproject(self, Jc_query, F_desc, E):
        """Descriptor-space forces back to Cartesian ones, both scaled."""
        with trace.span("predict.backproject"):
            F = dsc.vec_dot_d_desc(Jc_query, self.S, F_desc) * self.std
            return E * self.std + self.c, F

    def _predict_batch_fast(self, R_batch: torch.Tensor):
        """Fused-kernel contraction (forces/energies, no E constraints)."""
        Xq_query, Jc_query = self._query_descriptors(R_batch)
        with trace.span("predict.contract"):
            F_desc, E = desc_forces_fused(Xq_query.contiguous(), self.Xqt,
                                          self.wt, self.sig)
        return self._backproject(Jc_query, F_desc, E)

    def _predict_batch_impl(self, R_batch: torch.Tensor):
        """(B, A, 3) -> energies (B,), forces (B, A, 3), f64."""
        Xq_query, Jc_query = self._query_descriptors(R_batch)
        with trace.span("predict.contract"):
            dist = knl.pairwise_dist_gram(Xq_query, self.Xqt)
            A_exp, A_exp1 = knl.pair_weights(dist, self.sig)
            F_desc, E = knl.desc_forces(self.Xqt, self.sig, Xq_query, A_exp,
                                        A_exp1, self.wt)
            if self.vE_lin is not None:
                # the plain Matern-5/2 energy block of the query rows
                K_ee = (1.0 + dist * (1.0 + dist / 3.0)) * torch.exp(-dist)
                F_desc, E = knl.energy_coef_terms(
                    Xq_query, self.Xqt, self.sig, A_exp1, self.vE_lin,
                    F_desc, E, K_ee)
        return self._backproject(Jc_query, F_desc, E)

    def predict(self, R):
        """R (M, A, 3) or (M, 3A) -> (E (M,), F (M, A, 3)) as NumPy arrays.
        The call is the request root ``predict`` of ``utils.trace``."""
        with trace.request("predict"):
            return self._predict(R)

    def _predict(self, R):
        with trace.span("predict.input"):
            R = torch.as_tensor(np.asarray(R), dtype=torch.float64).reshape(
                -1, self.spec.n_atoms, 3)
        run = self._predict_batch_fast if self.fast else self._predict_batch_impl
        Es, Fs = [], []
        B = self.batch_size
        for start in range(0, R.shape[0], B):
            batch = R[start:start + B]
            if self.shard is None:
                with trace.span("predict.h2d"):
                    batch = batch.to(self.device)
                E, F = run(batch)
            else:
                # pad to an even split with the last geometry (to a
                # multiple of the ranks, not to B: eager torch has no
                # compiled batch shape to keep); each rank predicts its
                # slice, and every rank gathers the batch
                n_real = batch.shape[0]
                batch = torch.cat([batch, batch[-1:].expand(
                    -n_real % self.shard.world, -1, -1)])
                E, F = run(batch[self.shard.rows(batch.shape[0])].to(
                    self.device))
                E = self.shard.gather(E)[:n_real]
                F = self.shard.gather(F)[:n_real]
            with trace.span("predict.d2h"):
                Es.append(E.cpu().numpy())
                Fs.append(F.cpu().numpy())
        if not Es:
            return np.zeros(0), np.zeros((0, self.spec.n_atoms, 3))
        with trace.span("predict.output"):
            return np.concatenate(Es), np.concatenate(Fs)
