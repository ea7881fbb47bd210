"""Traffic of kind ``train``: one request is one whole training of the
seed's task, ``Trainer.train(create_task(...), n_columns=k,
str_preconditioner=...)``, as the configuration states it.

Mix parameters: ``warmup_iters``, the CG iterations of the set-up's one
training (the same task and every shape of the window, capped).  The
traced work is one whole training.  On more than one card every rank
builds the same session with the run's ``mesh``, and each training is
row-sharded over it (``Trainer.train(mesh=)``).

``correct``: every model the window returned is judged by the plain
reference (``reference.py``), which works the descriptors, the kernel
operator and the solve out again from the seed's geometries and labels:

  * ``desc_err``: the model's training descriptors (``R_desc``) against
    the reference's, max abs error over max abs;
  * ``w_err``: its descriptor cotangents J a (``R_d_desc_alpha``) against
    the reference's of the model's coefficients, the same measure;
  * ``resid``: the relative residual of the solve, |(K + lam I) a - y| /
    |y| with the reference's K, a = -``alphas_F`` and y the force labels
    over their standard deviation.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .. import data, reference
from . import worst

SPANS = ("cache_build_s", "total_time_preconditioner", "total_time_cg",
         "solver_iters")
KEPT = ("alphas_F", "R_desc", "R_d_desc_alpha")


class Session:
    def __init__(self, cell, seed: int, device, mesh=None):
        from mlff_tpu_torch.models.gdml import Trainer
        from mlff_tpu_torch.models.task import create_task

        self.cfg, self.mix, self.device = cell.config, cell.mix, device
        self.mesh = mesh
        self.ds, _ = data.dataset(self.cfg, seed)
        self.create_task = create_task
        self.trainer = Trainer(device=device)
        warm = self.task()
        warm["solver_maxiter"] = int(self.mix["warmup_iters"])
        self.train(warm)

    @property
    def shapes(self) -> dict:
        c = self.cfg
        N, P, A = int(c["n_train"]), int(c["n_perms"]), int(c["n_atoms"])
        return {"N": N, "P": P, "M": N * P, "A": A,
                "D": int(c["descriptor_dim"]), "n": 3 * A * N,
                "k": int(c["n_columns"])}

    def task(self) -> dict:
        c = self.cfg
        task = self.create_task(self.ds, int(c["n_train"]), sig=c["sigma"],
                                solver=c["solver"],
                                solver_tol=c["solver_tol"],
                                perms=np.asarray(c["perms"]))
        task.update(apply_impl=c["apply_impl"],
                    matvec_dtype=c["matvec_dtype"])
        return task

    def train(self, task: dict) -> dict:
        return self.trainer.train(task, n_columns=int(self.cfg["n_columns"]),
                                  str_preconditioner=self.cfg["preconditioner"],
                                  mesh=self.mesh)

    def request(self, i: int) -> dict:
        model = self.train(self.task())
        return {"ok": bool(model["is_conv"]),
                "spans": {k: float(model[k]) for k in SPANS},
                "model": {k: np.asarray(model[k]) for k in KEPT}}

    def traced(self) -> None:
        self.train(self.task())

    def release(self) -> None:
        self.trainer = None

    def check(self, records: list) -> dict:
        return judge(self.cfg, self.ds, [r["model"] for r in records],
                     self.device)


def _digest(model: dict) -> bytes:
    h = hashlib.sha256()
    for k in KEPT:
        h.update(np.ascontiguousarray(model[k]).tobytes())
    return h.digest()


def judge(cfg: dict, ds: dict, models: list, device,
          dtype=None) -> dict:
    """The compared numbers, each the worst over ``models`` (models with
    the same bits are judged once)."""
    import torch

    dtype = torch.float64 if dtype is None else dtype
    R = ds["R"]
    y = np.asarray(ds["F"], dtype=np.float64).ravel()
    y = y / np.std(y)
    lam = float(cfg["lambda"])
    X_ref = reference.model_arrays(R, np.zeros_like(R), device, dtype)[0]
    out = {"desc_err": 0.0, "w_err": 0.0, "resid": 0.0}
    seen = set()
    for m in models:
        key = _digest(m)
        if key in seen:
            continue
        seen.add(key)
        aF = np.asarray(m["alphas_F"], dtype=np.float64)
        if aF.size != y.size:
            return {k: float("inf") for k in out}
        _, w_ref = reference.model_arrays(R, aF.reshape(R.shape), device,
                                          dtype)
        ref = reference.Model(R, aF.reshape(R.shape), cfg["perms"],
                              cfg["sigma"], device=device, dtype=dtype)
        _, K_a = ref.predict(R)          # (K a_psd) with a_psd = -alphas_F
        r = K_a.ravel() - lam * aF - y
        out["resid"] = worst(out["resid"],
                           float(np.linalg.norm(r) / np.linalg.norm(y)))
        out["desc_err"] = worst(out["desc_err"], _rel(m["R_desc"], X_ref))
        out["w_err"] = worst(out["w_err"], _rel(m["R_d_desc_alpha"], w_ref))
    return out


def _rel(got, want) -> float:
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want)
    if got.shape != want.shape:
        return float("inf")
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
