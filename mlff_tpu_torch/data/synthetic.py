"""Synthetic molecular datasets with consistent energies and forces.

The reference downloads benchmark npz datasets (ethanol, aspirin, ...) from
quantum-machine.org (reference: sgdml/get.py:45-69).  This environment has no
network egress, so we generate MD-like samples from an analytic pairwise Morse
potential instead: energies and forces are exactly consistent (F = -grad E),
which exercises integration-constant recovery, cosine force errors and
learning-curve sanity the same way real data does.  Atom counts for the named
molecules match the reference benchmark systems
(reference: src/tools/create_data.py:55-72).

A verbatim copy of ``mlff_tpu.data.synthetic`` (host NumPy only), so that the port
imports nothing of the JAX package; equal seeds give bitwise-equal arrays.
"""

from __future__ import annotations

import numpy as np

from ..utils.io import dataset_md5

# name -> number of atoms, as in the reference benchmark set.
MOLECULES = {
    "ethanol": 9,
    "uracil": 12,
    "malonaldehyde": 9,
    "naphthalene": 18,
    "salicylic": 16,
    "toluene": 15,
    "aspirin": 21,
    "azobenzene": 24,
    "paracetamol": 20,
    "catcher": 88,
    "nanotube": 370,
}


def _base_geometry(n_atoms: int, rng: np.random.Generator) -> np.ndarray:
    """Random base geometry with a minimum pair separation (greedy rejection)."""
    pts = [rng.normal(size=3)]
    scale = max(1.5, 0.9 * n_atoms ** (1.0 / 3.0) * 1.6)
    while len(pts) < n_atoms:
        cand = rng.normal(size=3) * scale
        d = np.linalg.norm(np.asarray(pts) - cand, axis=1)
        if np.all(d > 1.0):
            pts.append(cand)
    return np.asarray(pts)


def _tube_geometry(n_atoms: int, rng: np.random.Generator) -> np.ndarray:
    """Quasi-1D helical tube lattice (the nanotube's geometry class).

    The random-cluster base geometry produces a compact 3D blob whose
    inverse-distance descriptor spectrum is measurably FAR harder than a
    real nanotube's at the archived sample counts (round 4: every
    difficulty axis left iteration counts >= 2.2x the archived curve —
    see RESULTS.md).  A real (n, 0) tube is a regular quasi-1D lattice:
    most pairwise distances follow the smooth axial progression, giving
    the banded, fast-decaying distance structure the archived curves
    reflect.  This helix puts ~MERIDIAN atoms per turn at bond-length
    chord spacing with a matching per-turn rise, plus a small frozen
    jitter so no two pair distances are exactly degenerate.
    """
    m = 12                       # atoms per turn
    bond = 1.42                  # C-C bond length scale
    r = bond / (2.0 * np.sin(np.pi / m))
    rise = 2.13                  # per-turn axial rise (graphene-row-like)
    i = np.arange(n_atoms)
    theta = 2.0 * np.pi * i / m
    pts = np.stack([r * np.cos(theta), r * np.sin(theta), i * (rise / m)],
                   axis=1)
    return pts + 0.03 * rng.normal(size=pts.shape)


def _morse_energy_forces(R: np.ndarray, d0: np.ndarray, De: float, a: float):
    """Energy and forces of a pairwise Morse potential, batched over (M, A, 3).

    E = sum_{i<j} De * (1 - exp(-a (d_ij - d0_ij)))**2,  F = -grad E.
    """
    M, A, _ = R.shape
    iu, ju = np.triu_indices(A, 1)
    diff = R[:, iu] - R[:, ju]  # (M, npair, 3)
    dist = np.linalg.norm(diff, axis=-1)  # (M, npair)
    ex = np.exp(-a * (dist - d0[None, :]))
    E = (De * (1.0 - ex) ** 2).sum(axis=1)
    # dE/dd = 2 De (1 - ex) * a * ex ; dd/dr_i = diff/dist.
    dEdd = 2.0 * De * (1.0 - ex) * a * ex
    g = (dEdd / dist)[..., None] * diff  # grad wrt r_i per pair
    F = np.zeros_like(R)
    np.add.at(F, (slice(None), iu), -g)
    np.add.at(F, (slice(None), ju), g)
    return E, F


def make_dataset(
    name: str = "ethanol",
    n_samples: int = 1500,
    seed: int = 1,
    temperature: float = 0.02,
    n_atoms: int | None = None,
    n_modes: int = 4,
    jitter: float = 0.005,
    geometry: str = "cluster",
    correlation: float = 0.0,
) -> dict:
    """Generate a synthetic dataset dict in the reference npz schema.

    Displacements are drawn along ``n_modes`` random collective modes (plus
    ``jitter`` of full-dimensional noise), mimicking thermal MD trajectories
    that live on a low-dimensional manifold — i.i.d. per-coordinate noise
    would make the regression problem hopeless at realistic training sizes.

    ``correlation``: AR(1)/Ornstein-Uhlenbeck autocorrelation of the mode
    coefficients along the sample axis (0 = i.i.d. draws, the default).
    Real MD datasets are TRAJECTORIES: consecutive snapshots traverse the
    mode manifold slowly, so a small training draw sees a quasi-1D path —
    far more kernel-redundant than the same number of i.i.d. points in a
    21-dimensional mode ball.  At the nanotube's archived operating points
    (n_train = 14-455, A = 370) this sampling-geometry difference is the
    round-4 structural residual: every i.i.d. difficulty axis left
    iteration counts >= 2.2x the archived curves.  The AR(1) process keeps
    the stationary marginal N(0, 1), so ``temperature`` retains its
    meaning; only the path geometry changes.

    Difficulty calibration: the kernel systems these defaults produce are
    considerably better conditioned than the real MD17 sets (CG at the
    archived ethanol n = 15,741 / sig 10 / k/n = 0.105 point needs ~10
    iterations vs the archived 196).  ``make_benchmark_dataset`` provides
    per-molecule settings calibrated so PCG iteration counts match the
    reference's archived curves — use it for anything that benchmarks
    solver time against the paper's numbers.
    """
    if n_atoms is None:
        n_atoms = MOLECULES.get(name)
        if n_atoms is None:
            raise ValueError(f"unknown molecule {name!r}; pass n_atoms explicitly")
    rng = np.random.default_rng(seed)
    base = (_tube_geometry(n_atoms, rng) if geometry == "tube"
            else _base_geometry(n_atoms, rng))

    iu, ju = np.triu_indices(n_atoms, 1)
    d0 = np.linalg.norm(base[iu] - base[ju], axis=1)

    modes = rng.normal(size=(n_modes, n_atoms, 3))
    modes /= np.linalg.norm(modes.reshape(n_modes, -1), axis=1)[:, None, None]
    white = rng.normal(size=(n_samples, n_modes))
    if correlation > 0.0:
        rho = float(correlation)
        innov = np.sqrt(1.0 - rho * rho)
        c = np.empty_like(white)
        c[0] = white[0]
        for t_ in range(1, n_samples):
            c[t_] = rho * c[t_ - 1] + innov * white[t_]
        white = c
    coeff = white * np.sqrt(temperature * 3 * n_atoms / n_modes)
    disp = np.einsum("sm,max->sax", coeff, modes)
    R = base[None] + disp + rng.normal(size=(n_samples, n_atoms, 3)) * jitter
    E, F = _morse_energy_forces(R, d0, De=5.0, a=1.2)

    # a few light species repeated, like organic molecules
    z = rng.choice([1, 6, 7, 8], size=n_atoms, p=[0.5, 0.35, 0.075, 0.075])

    dataset = {
        "type": "d",
        "name": np.asarray(f"synthetic_{name}"),
        "theory": np.asarray("morse_pairwise"),
        "z": z.astype(np.int64),
        "R": R.astype(np.float64),
        "E": E.astype(np.float64),
        "F": F.astype(np.float64),
        "r_unit": np.asarray("Ang"),
        "e_unit": np.asarray("kcal/mol"),
    }
    dataset["md5"] = np.asarray(dataset_md5(dataset))
    return dataset


# ---------------------------------------------------------------------------
# Benchmark datasets: difficulty-calibrated, with the molecules' permutation
# groups imposed (VERDICT round 1 items 4/5 — equal-footing workloads)
# ---------------------------------------------------------------------------

def _perm_group(n_atoms: int, generators: list[list[int]]) -> np.ndarray:
    """Closure of the given generator permutations (tiny groups; the closure
    cap mirrors models.symmetry.complete_sym_group semantics)."""
    ident = tuple(range(n_atoms))
    gens = [tuple(g) for g in generators]
    group = {ident}
    frontier = [ident]
    while frontier:
        new = []
        for p in frontier:
            for g in gens:
                q = tuple(p[g[i]] for i in range(n_atoms))
                if q not in group:
                    group.add(q)
                    new.append(q)
        frontier = new
        assert len(group) <= 100
    return np.asarray(sorted(group))


def _cycle(n_atoms: int, *orbits: tuple) -> list[int]:
    """Permutation cycling each orbit tuple by one position."""
    p = list(range(n_atoms))
    for orbit in orbits:
        for a, b in zip(orbit, orbit[1:] + orbit[:1]):
            p[a] = b
    return p


# Real atomic composition + physical permutation group per benchmark
# molecule.  Group orders follow the sGDML symmetry counts for the MD17
# benchmark set (Chmiela et al. 2018, recovered by sgdml/utils/perm.py):
# ethanol 6 (S3 on the methyl hydrogens x CH2 swap gives 6 after closure
# with the realized generators), toluene 12 (methyl S3 x ring flip),
# aspirin 6 (methyl S3 realized as 3-cycle x one H-pair swap), azobenzene 4
# (two independent phenyl flips), uracil 1 (planar, no permutable atoms).
# The synthetic geometries do NOT possess these symmetries; imposing the
# group anyway is mathematically sound (the symmetrized kernel stays PSD)
# and reproduces the reference's per-iteration workload M = N * P
# (reference predict.py:420-447).
_BENCH_MOLECULES: dict = {
    # name: (z, generators)
    "ethanol": (
        np.array([6, 6, 8, 1, 1, 1, 1, 1, 1]),
        [_cycle(9, (3, 4, 5)), _cycle(9, (6, 7))],            # P = 6
    ),
    "uracil": (
        np.array([6, 6, 6, 6, 7, 7, 8, 8, 1, 1, 1, 1]),
        [],                                                    # P = 1
    ),
    "toluene": (
        np.array([6] * 7 + [1] * 8),
        [_cycle(15, (7, 8, 9)), _cycle(15, (7, 8)),
         _cycle(15, (10, 11), (12, 13))],                      # P = 12
    ),
    "aspirin": (
        np.array([6] * 9 + [8] * 4 + [1] * 8),
        [_cycle(21, (13, 14, 15)), _cycle(21, (16, 17))],      # P = 6
    ),
    "azobenzene": (
        np.array([6] * 12 + [7, 7] + [1] * 10),
        [_cycle(24, (14, 15), (16, 17)), _cycle(24, (18, 19), (20, 21))],  # P = 4
    ),
    "catcher": (np.array([6] * 60 + [1] * 28), []),            # P = 1
    "nanotube": (np.array([6] * 366 + [1] * 4), []),           # P = 1
}

# Difficulty calibration: (n_modes, temperature[, jitter]) tuned so
# lev_random PCG iteration counts at the reference's archived operating
# points (data/data/cg_performance_n=15750, estimate_slope sweeps; sig = 10,
# tol 1e-4) land within ~30% of the archived curves.  The default
# make_dataset settings produce kernels ~20x easier than MD17
# (tests/test_golden_archived.py documents the protocol).
#
# The generator's difficulty does NOT scale with n the way MD17's does
# (the fixed low-dimensional mode manifold saturates: at fixed settings,
# doubling n_train roughly squares the preconditioned iteration count
# while MD17's archived curves grow far slower), so entries calibrated at
# one kernel size do not transfer.  ``by_n_train`` carries per-scale
# calibrations against per-scale archived curves (estimate_slope sweeps);
# make_benchmark_dataset overlays the entry nearest the requested size.
_BENCH_DIFFICULTY: dict = {
    # calibration runs: tools/calibrate_difficulty.py -> calibration_log.json
    # (ours vs archived lev_random CG steps at k/n ~= 0.049 / 0.105).
    # by_n_train: per-scale overlays calibrated against the archived
    # per-scale curves (rule_of_thumb/n = 75000|157500|500000 sweeps) —
    # the fixed-manifold generator hardens faster with n than MD17, so T
    # drifts down with scale (round-5 calibrations, calibration_log.json).
    "ethanol": dict(n_modes=21, temperature=0.25,         # 386/379, 171/196
                    by_n_train={
                        583: {},                          # 15.7k/31.4k base
                        2777: dict(temperature=0.232),    # 75k: 0.79/0.86
                        5833: dict(temperature=0.188),    # 157.5k (r5 cal)
                        # 504k: extrapolated from the (583, 2777, 5833)
                        # ln T-vs-ln n trend (slope steepens with scale);
                        # validated by the capped decay probe before the
                        # full run (tools/run_500k.py)
                        18666: dict(temperature=0.108),
                    }),
    "uracil": dict(n_modes=33, temperature=0.0840),       # 727/587, 309/291
    "toluene": dict(n_modes=21, temperature=0.0971),      # 1001/1059, 390/512
    "aspirin": dict(n_modes=33, temperature=0.1501,
                    jitter=0.0025,                        # 4226/5732, 1826/1584
                    by_n_train={
                        250: {},                          # 15.7k/31.4k base
                        # 157.5k: UNCALIBRATED after THREE measured
                        # negatives (2026-08-21, k=4096 vs the archived
                        # 3,902-step row): T=0.113 plateaued at 3,600
                        # capped iters; T=0.085 decayed ~5e-4/iter at
                        # it=3,400 (~4.5x projection); T=0.113 with
                        # jitter=0.001 plateaued at ~0.95 ||b|| by
                        # it=1,500 — neither the T nor the jitter axis
                        # alone reaches aspirin's archived tail at this
                        # scale (same structural class as the nanotube
                        # negative, milder).  Entry kept at the closest
                        # attempt so large-n runs are not silently easy.
                        2500: dict(temperature=0.113, jitter=0.001),
                    }),
    "azobenzene": dict(n_modes=21, temperature=0.0377),   # 1437/1312, 525/642
    # catcher@119 probes (round 5): T=0.234 -> ratio 2.10 and
    # T=0.28 -> >=2.20 (capped) at the archived k/n=0.0589 point — BOTH
    # worse than base T=0.25's 1.31: the base temperature is a local
    # optimum of a non-monotone (or draw-noise-dominated) response; the
    # base entry stands, no by_n_train overlay, and 1.31 is the measured
    # state of the calibration-band question (inside the [0.6, 1.6]
    # parity band, 0.01 outside the +-30% calibration band).
    "catcher": dict(n_modes=21, temperature=0.25),        # 6338/7980, 3576/3512
}


_BENCH_GEOMETRY: dict = {"nanotube": "tube"}


def benchmark_perms(name: str) -> np.ndarray:
    """The molecule's permutation group (P, A), identity first."""
    z, gens = _BENCH_MOLECULES[name]
    return _perm_group(len(z), gens)


def make_benchmark_dataset(name: str, n_samples: int, seed: int = 11,
                           n_train: int | None = None,
                           **overrides) -> tuple[dict, np.ndarray]:
    """Difficulty-calibrated dataset + the molecule's permutation group.

    Returns (dataset, perms); pass ``perms`` to ``create_task(...,
    perms=perms)`` so the benchmark workload carries the reference's
    M = N * P matvec multiplier.  Use this (not plain make_dataset) for
    anything that quotes speedups against the paper's numbers.

    ``n_train``: the training-set size the caller will actually use, for
    matching per-scale ``by_n_train`` calibration entries exactly (callers
    pass n_samples = n_train + a validation margin; for small molecules the
    margin is a large relative perturbation and would select the wrong
    per-scale entry).
    """
    z, _ = _BENCH_MOLECULES[name]
    if name not in _BENCH_DIFFICULTY:
        # LOUD fallback: an uncalibrated molecule silently inheriting
        # ethanol's settings would mislabel an easy workload as benchmark
        # data (VERDICT r3 weak 7)
        from ..utils.log import get_logger

        get_logger(__name__).warning(
            "make_benchmark_dataset(%r): molecule has NO calibrated "
            "difficulty entry (_BENCH_DIFFICULTY); falling back to "
            "ethanol's settings — iteration counts will NOT be comparable "
            "to the reference's archived curves for this molecule.", name)
    settings = dict(_BENCH_DIFFICULTY.get(name, dict(n_modes=21,
                                                     temperature=0.25)))
    # geometry class per molecule: the nanotube is a quasi-1D tube lattice
    # (the random cluster's spectrum is structurally too hard — round 4)
    settings.setdefault("geometry", _BENCH_GEOMETRY.get(name, "cluster"))
    by_n = settings.pop("by_n_train", None)
    if by_n:
        # overlay the calibration nearest the caller's n_train (preferred)
        # or, lacking it, n_samples minus the standard validation margin.
        # Nearest in LOG distance: the calibrated scales are geometric
        # (583/2777/5833/18666 for ethanol) and a midpoint like 1166 must
        # resolve to its verified neighbor (583-base), which a relative-
        # distance metric mis-picks toward the larger scale.
        import math

        nt_query = n_train if n_train is not None else max(1, n_samples - 60)
        nearest = min(by_n, key=lambda nt: abs(math.log(nt / nt_query)))
        settings.update(by_n[nearest])
    settings.update(overrides)
    ds = make_dataset(name, n_samples=n_samples, seed=seed,
                      n_atoms=len(z), **settings)
    ds["z"] = np.asarray(z, dtype=np.int64)
    from ..utils.io import dataset_md5

    ds["md5"] = np.asarray(dataset_md5(ds))
    return ds, benchmark_perms(name)
