"""Traffic of kind ``predict``: one request is one
``Predictor(model, fast=...).predict(R)`` of ``geoms_per_call``
geometries, taken in order from a held-out pool and wrapping at its end;
one client, each call waiting for the one before.

The model is made by the benchmark with its own plain code: the seed's
training geometries, coefficients drawn from the seed, their descriptors
and cotangents J a (``reference.model_arrays``), the mix's ``model_std``
and ``model_c``.  The program and the reference are handed the same
model and the same queries.

Mix parameters: ``geoms_per_call``, ``pool`` (a multiple of it),
``fast``, ``warmup_calls`` (calls of the set-up), ``trace_calls`` (calls
of the traced work), ``keep`` (the answers kept for the check: a uniform
sample of the window's calls drawn from the seed, every call while the
window has no more than ``keep``).

``correct``: every kept answer against the reference's prediction of the
same geometries, ``F_err`` the max abs force error over the max abs
reference force, ``E_err`` the max abs energy error over the max abs
reference energy less ``model_c``.
"""

from __future__ import annotations

import numpy as np

from .. import data, reference
from . import worst


class Reservoir:
    """A uniform sample of at most ``size`` items of a stream (Algorithm
    R), drawn from ``rng``."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng, self.items, self.seen = size, rng, [], 0

    def offer(self, item) -> None:
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.items[j] = item
        self.seen += 1


class Session:
    def __init__(self, cell, seed: int, device, mesh=None):
        if mesh is not None:
            raise ValueError("a prediction cell runs on one card: the "
                             "predict kind takes no mesh (the sharded "
                             "configurations users run are trainings)")
        from mlff_tpu_torch.models.predict import Predictor

        cfg, mix = cell.config, cell.mix
        self.cfg, self.mix, self.device = cfg, mix, device
        self.g, pool = int(mix["geoms_per_call"]), int(mix["pool"])
        if pool % self.g:
            raise ValueError("the pool must hold a whole number of calls")
        ds, self.R_pool = data.dataset(cfg, seed, n_extra=pool)
        self.R_train, self.a = ds["R"], data.coefficients(cfg, seed)
        R_desc, w = reference.model_arrays(self.R_train, self.a)
        self.model = {"z": np.asarray(cfg["z"]), "R_desc": R_desc,
                      "R_d_desc_alpha": w, "perms": np.asarray(cfg["perms"]),
                      "sig": float(cfg["sigma"]),
                      "std": float(mix["model_std"]),
                      "c": float(mix["model_c"])}
        self.predictor = Predictor(self.model, fast=bool(mix["fast"]),
                                   device=device)
        self.kept = Reservoir(int(mix["keep"]), data.seed_rng(seed, 2))
        for i in range(int(mix["warmup_calls"])):
            self.predictor.predict(self.queries(i))

    @property
    def shapes(self) -> dict:
        c = self.cfg
        N, P = int(c["n_train"]), int(c["n_perms"])
        return {"N": N, "P": P, "M": N * P, "A": int(c["n_atoms"]),
                "D": int(c["descriptor_dim"]), "g": self.g,
                "batch": int(self.predictor.batch_size)}

    def queries(self, i: int) -> np.ndarray:
        s = (i * self.g) % self.R_pool.shape[0]
        return self.R_pool[s:s + self.g]

    def request(self, i: int) -> dict:
        E, F = self.predictor.predict(self.queries(i))
        self.kept.offer((i, E, F))
        return {"ok": True, "n": self.g}

    def traced(self) -> None:
        for i in range(int(self.mix["trace_calls"])):
            self.predictor.predict(self.queries(i))

    def release(self) -> None:
        self.predictor = None

    def check(self, records: list) -> dict:
        return judge(self, self.kept.items, self.device)


def judge(session, kept: list, device, dtype=None) -> dict:
    """``F_err`` and ``E_err`` of the kept answers against the reference
    run in ``dtype`` (float64 by default) on the whole pool."""
    import torch

    dtype = torch.float64 if dtype is None else dtype
    mix = session.mix
    ref = reference.Model(session.R_train, session.a, session.cfg["perms"],
                          session.cfg["sigma"], std=mix["model_std"],
                          c=mix["model_c"], device=device, dtype=dtype)
    E_ref, F_ref = ref.predict(session.R_pool)
    f_scale = np.max(np.abs(F_ref))
    e_scale = np.max(np.abs(E_ref - float(mix["model_c"])))
    out = {"F_err": 0.0, "E_err": 0.0}
    pool = session.R_pool.shape[0]
    for i, E, F in kept:
        s = (i * session.g) % pool
        E = np.asarray(E, dtype=np.float64)
        F = np.asarray(F, dtype=np.float64)
        if F.shape != F_ref[s:s + session.g].shape or E.shape != (session.g,):
            return {k: float("inf") for k in out}
        out["F_err"] = worst(out["F_err"], float(
            np.max(np.abs(F - F_ref[s:s + session.g])) / f_scale))
        out["E_err"] = worst(out["E_err"], float(
            np.max(np.abs(E - E_ref[s:s + session.g])) / e_scale))
    return out
