"""The benchmark's data: a frozen copy of the port's calibrated generator
(``mlff_tpu_torch/data/synthetic.py::make_benchmark_dataset``) and of the
stratified draw of training points (``utils/sampling.py::
draw_strat_sample``), NumPy only.

A configuration's training set is the calibrated task of the port's
benchmark tools: ``n_samples`` geometries drawn from the generator's
``seed`` (base geometry, collective modes, their coefficients, jitter;
energies and forces of a pairwise Morse potential, F = -grad E), of which
the stratified draw (seed 0) keeps ``n_train``.  Its PCG iteration counts
are the calibrated ones (285 for ethanol, 1953 for aspirin on the card).

The run's ``--seed`` moves each training geometry by its own rigid
translation, up to ``shift`` in each coordinate.  Descriptors, forces and
so the whole kernel system are invariant under it, so every seed gives the
same work, while every number the program computes starts from other bits.
(Ordering the training points by the seed instead moved the iterations
from 266 to 334 at ethanol, since the preconditioner samples its columns
by index.)  The seed also draws, from the same molecule, the held-out
geometries a prediction queries, and the coefficients of the model it
predicts with.
"""

from __future__ import annotations

import numpy as np


def base_geometry(n_atoms: int, rng: np.random.Generator) -> np.ndarray:
    """Random base geometry with a minimum pair separation of 1 (greedy
    rejection)."""
    pts = [rng.normal(size=3)]
    scale = max(1.5, 0.9 * n_atoms ** (1.0 / 3.0) * 1.6)
    while len(pts) < n_atoms:
        cand = rng.normal(size=3) * scale
        d = np.linalg.norm(np.asarray(pts) - cand, axis=1)
        if np.all(d > 1.0):
            pts.append(cand)
    return np.asarray(pts)


def morse_energy_forces(R: np.ndarray, d0: np.ndarray, De: float, a: float):
    """Energies (S,) and forces (S, A, 3) of a pairwise Morse potential,
    E = sum_{i<j} De (1 - exp(-a (d_ij - d0_ij)))^2, F = -grad E."""
    A = R.shape[1]
    iu, ju = np.triu_indices(A, 1)
    diff = R[:, iu] - R[:, ju]
    dist = np.linalg.norm(diff, axis=-1)
    ex = np.exp(-a * (dist - d0[None, :]))
    E = (De * (1.0 - ex) ** 2).sum(axis=1)
    g = ((2.0 * De * (1.0 - ex) * a * ex) / dist)[..., None] * diff
    F = np.zeros_like(R)
    np.add.at(F, (slice(None), iu), -g)
    np.add.at(F, (slice(None), ju), g)
    return E, F


def draw_strat_sample(T: np.ndarray, n: int, seed: int = 0) -> np.ndarray:
    """``n`` indices into ``T`` that keep its histogram (Freedman-Diaconis
    bins, proportional allocation), sorted."""
    rng = np.random.default_rng(seed)
    T = np.asarray(T).ravel()
    if T.size == n:
        return np.arange(n)
    h = 2 * np.subtract(*np.percentile(T, [75, 25])) / np.cbrt(n)
    n_bins = int(np.ceil((np.max(T) - np.min(T)) / h)) if h > 0 else 1
    n_bins = min(n_bins, int(n / 2))
    bins = np.linspace(np.min(T), np.max(T), n_bins, endpoint=False)
    idxs = np.digitize(T, bins)
    uniq_all, cnts_all = np.unique(idxs, return_counts=True)
    reduced = np.ceil(cnts_all / np.sum(cnts_all, dtype=float) * n).astype(int)
    reduced = np.minimum(reduced, cnts_all)
    delta = n - np.sum(reduced)
    while np.abs(delta) > 0:
        max_bin_reduction = np.min(reduced[np.where(reduced > 1)]) - 1
        outstanding = rng.choice(
            uniq_all, min(max_bin_reduction, np.abs(delta)),
            p=(reduced - 1) / np.sum(reduced - 1, dtype=float), replace=True)
        uniq_out, cnts_out = np.unique(outstanding, return_counts=True)
        at = np.where(np.isin(uniq_all, uniq_out, assume_unique=True))[0]
        reduced[at] += np.sign(delta) * cnts_out
        delta = n - np.sum(reduced)
    out = np.empty((0,), dtype=int)
    for u, cnt in zip(uniq_all, reduced):
        out = np.append(out, rng.choice(np.where(idxs.ravel() == u)[0], cnt,
                                        replace=False))
    out.sort()
    return out


class Molecule:
    """A configuration's molecule and its calibrated samples, drawn from
    the generator's ``seed`` in the original generator's order: base
    geometry, modes, mode coefficients, jitter."""

    def __init__(self, config: dict):
        gen = config["generator"]
        self.z = np.asarray(config["z"], dtype=np.int64)
        self.n_atoms = len(self.z)
        self.n_modes = int(gen["n_modes"])
        self.temperature = float(gen["temperature"])
        self.jitter = float(gen["jitter"])
        self.De, self.a = float(gen["morse_De"]), float(gen["morse_a"])
        rng = np.random.default_rng(int(gen["seed"]))
        self.base = base_geometry(self.n_atoms, rng)
        iu, ju = np.triu_indices(self.n_atoms, 1)
        self.d0 = np.linalg.norm(self.base[iu] - self.base[ju], axis=1)
        modes = rng.normal(size=(self.n_modes, self.n_atoms, 3))
        modes /= np.linalg.norm(modes.reshape(self.n_modes, -1),
                                axis=1)[:, None, None]
        self.modes = modes
        self.samples = self.geometries(int(gen["n_samples"]), rng)

    def geometries(self, n: int, rng: np.random.Generator) -> np.ndarray:
        """(n, A, 3) geometries: displacements along the modes plus jitter."""
        white = rng.normal(size=(n, self.n_modes))
        coeff = white * np.sqrt(self.temperature * 3 * self.n_atoms
                                / self.n_modes)
        disp = np.einsum("sm,max->sax", coeff, self.modes)
        return (self.base[None] + disp
                + rng.normal(size=(n, self.n_atoms, 3)) * self.jitter)

    def labels(self, R: np.ndarray):
        """(E (n,), F (n, A, 3)) of geometries R."""
        return morse_energy_forces(R, self.d0, self.De, self.a)


def seed_rng(seed: int, stream: int = 0) -> np.random.Generator:
    """The run's generator of stream ``stream``: any whole number, negative
    and past 2**63 included, seeds it (NumPy takes non-negative words)."""
    seed = int(seed)
    words = [seed & 0xFFFFFFFFFFFFFFFF, (seed >> 64) & 0xFFFFFFFFFFFFFFFF,
             1 if seed < 0 else 0, stream]
    return np.random.default_rng(words)


def dataset(config: dict, seed: int, n_extra: int = 0):
    """(dataset dict in the sGDML npz schema holding the ``n_train``
    training geometries, each translated by the seed, with their labels;
    (n_extra, A, 3) held-out geometries drawn from the seed)."""
    mol = Molecule(config)
    E, F = mol.labels(mol.samples)
    keep = draw_strat_sample(E, int(config["n_train"]), seed=0)
    rng = seed_rng(seed)
    shift = float(config["generator"]["shift"])
    R = mol.samples[keep] + rng.uniform(-shift, shift,
                                        size=(keep.size, 1, 3))
    R_pool = mol.geometries(n_extra, rng)
    ds = {
        "type": "d",
        "name": np.asarray(f"benchmark_{config['molecule']}"),
        "theory": np.asarray("morse_pairwise"),
        "z": mol.z.copy(),
        "R": R,
        "E": E[keep],
        "F": F[keep],
        "r_unit": np.asarray("Ang"),
        "e_unit": np.asarray("kcal/mol"),
    }
    return ds, R_pool


def coefficients(config: dict, seed: int) -> np.ndarray:
    """(n_train, A, 3) model coefficients of a prediction cell, standard
    normal, drawn from the seed's own stream."""
    return seed_rng(seed, stream=1).normal(
        size=(int(config["n_train"]), len(config["z"]), 3))
