"""Task creation: the canonical experiment record.

Rebuild of ``GDMLTrain.create_task`` / ``create_task_from_model``
(reference: sgdml/train.py:296-594).  A task is a plain dict (npz-
serializable) carrying hyperparameters, sampled train/valid indices, dataset
fingerprints, recovered permutations and solver configuration — sufficient to
reproduce a model.

A verbatim copy of ``mlff_tpu.models.task`` (host NumPy only), so that the port
imports nothing of the JAX package; equal seeds give bitwise-equal arrays.
"""

from __future__ import annotations

import numpy as np

from .. import __version__
from ..utils import io
from ..utils.log import get_logger
from ..utils.sampling import draw_strat_sample
from .symmetry import find_perms

log = get_logger(__name__)


def create_task(
    train_dataset: dict,
    n_train: int,
    valid_dataset: dict | None = None,
    n_valid: int = 0,
    sig: float = 10.0,
    lam: float = 1e-15,
    use_sym: bool = True,
    use_E: bool = True,
    use_E_cstr: bool = False,
    use_cprsn: bool = False,
    solver: str = "analytic",
    solver_tol: float = 1e-4,
    n_inducing_pts_init: int = 25,
    interact_cut_off: float | None = None,
    seed_idxs_train: int = 0,
    perms: "np.ndarray | None" = None,
) -> dict:
    """Sample train/valid subsets and assemble a task dict
    (reference train.py:296-535; sampling seeded identically, train.py:280)."""
    if valid_dataset is None:
        valid_dataset = train_dataset

    if use_E and "E" not in train_dataset:
        raise ValueError(
            "No energy labels found in dataset (pass use_E=False to train "
            "forces only)."
        )
    use_E_cstr = use_E and use_E_cstr

    md5_train = io.dataset_md5(train_dataset)
    md5_valid = io.dataset_md5(valid_dataset)

    if "E" in train_dataset:
        idxs_train = draw_strat_sample(
            train_dataset["E"], n_train, seed=seed_idxs_train
        )
    else:
        rng = np.random.default_rng(seed_idxs_train)
        idxs_train = np.sort(
            rng.choice(train_dataset["F"].shape[0], n_train, replace=False)
        )

    excl_idxs = idxs_train if md5_train == md5_valid else np.array([], dtype=np.int64)

    if n_valid > 0:
        if "E" in valid_dataset:
            idxs_valid = draw_strat_sample(
                valid_dataset["E"], n_valid, excl_idxs=excl_idxs, seed=seed_idxs_train
            )
        else:
            rng = np.random.default_rng(seed_idxs_train + 1)
            cands = np.setdiff1d(
                np.arange(valid_dataset["F"].shape[0]), excl_idxs, assume_unique=True
            )
            idxs_valid = np.sort(rng.choice(cands, n_valid, replace=False))
    else:
        idxs_valid = np.array([], dtype=np.int64)

    R_train = train_dataset["R"][idxs_train]
    task = {
        "type": "t",
        "code_version": __version__,
        "dataset_name": np.asarray(train_dataset["name"]).astype(str)[()],
        "dataset_theory": np.asarray(train_dataset["theory"]).astype(str)[()],
        "z": np.asarray(train_dataset["z"]),
        "R_train": R_train,
        "F_train": train_dataset["F"][idxs_train],
        "idxs_train": idxs_train,
        "md5_train": md5_train,
        "idxs_valid": idxs_valid,
        "md5_valid": md5_valid,
        "sig": sig,
        "lam": lam,
        "use_E": use_E,
        "use_E_cstr": use_E_cstr,
        "use_sym": use_sym,
        "use_cprsn": use_cprsn,
        "solver_name": solver,
        "solver_tol": solver_tol,
        "n_inducing_pts_init": n_inducing_pts_init,
        "interact_cut_off": interact_cut_off,
    }
    if use_E:
        task["E_train"] = train_dataset["E"][idxs_train]

    if "lattice" in train_dataset:
        task["lattice"] = train_dataset["lattice"]
        try:
            np.linalg.inv(task["lattice"])
        except np.linalg.LinAlgError:
            raise ValueError("Dataset lattice vectors are not invertible.")

    if "r_unit" in train_dataset and "e_unit" in train_dataset:
        task["r_unit"] = train_dataset["r_unit"]
        task["e_unit"] = train_dataset["e_unit"]

    if perms is not None:
        # explicit permutation group (benchmark workloads impose the real
        # molecules' groups on synthetic geometries; data.synthetic
        # .make_benchmark_dataset) — every perm must map same-z atoms
        perms = np.asarray(perms, dtype=np.int64).reshape(-1, R_train.shape[1])
        z = np.asarray(train_dataset["z"])
        assert all((z[p] == z).all() for p in perms), \
            "perms must permute same-species atoms"
        task["perms"] = perms
    elif use_sym:
        n_sym_geo = min(len(R_train), 1000)
        task["perms"] = find_perms(
            R_train[:n_sym_geo], np.asarray(train_dataset["z"])
        )
    else:
        task["perms"] = np.arange(R_train.shape[1])[None, :]

    # symmetry compression bookkeeping (reference train.py:525-533)
    n_perms = task["perms"].shape[0]
    if use_cprsn and n_perms > 1:
        _, cprsn_keep_idxs = np.unique(
            np.sort(task["perms"], axis=0), axis=1, return_index=True
        )
        task["cprsn_keep_atoms_idxs"] = cprsn_keep_idxs

    return task


def create_task_from_model(model: dict, dataset: dict) -> dict:
    """Rebuild a resumable task from a stored model
    (reference train.py:537-594): carries warm-start alphas, iteration count
    and the inducing set."""
    idxs_train = np.asarray(model["idxs_train"])
    # the reference keys off 'e_err' presence (train.py:543); our npz
    # round-trip drops dict-valued fields, so use the explicit flag
    use_E = bool(np.asarray(model.get("use_E", "e_err" in model)))
    use_E_cstr = "alphas_E" in model

    task = {
        "type": "t",
        "code_version": __version__,
        "dataset_name": model["dataset_name"],
        "dataset_theory": model["dataset_theory"],
        "z": np.asarray(model["z"]),
        "R_train": dataset["R"][idxs_train],
        "F_train": dataset["F"][idxs_train],
        "idxs_train": idxs_train,
        "md5_train": str(np.asarray(model["md5_train"]).astype(str)),
        "idxs_valid": np.asarray(model["idxs_valid"]),
        "md5_valid": str(np.asarray(model["md5_valid"]).astype(str)),
        "sig": float(model["sig"]),
        "lam": float(model["lam"]),
        "use_E": bool(np.asarray(model["use_E"])),
        "use_E_cstr": use_E_cstr,
        "use_sym": np.asarray(model["perms"]).shape[0] > 1,
        "perms": np.asarray(model["perms"]),
        "use_cprsn": bool(np.asarray(model["use_cprsn"])),
        "solver_name": str(np.asarray(model["solver_name"]).astype(str)),
        "solver_tol": float(model["solver_tol"]),
        "n_inducing_pts_init": int(model["n_inducing_pts_init"]),
        "interact_cut_off": None,
    }
    if use_E:
        task["E_train"] = dataset["E"][idxs_train]
    if "lattice" in model:
        task["lattice"] = model["lattice"]
    if "r_unit" in model and "e_unit" in model:
        task["r_unit"] = model["r_unit"]
        task["e_unit"] = model["e_unit"]
    if "alphas_F" in model:
        task["alphas0_F"] = np.asarray(model["alphas_F"])
    if "alphas_E" in model:
        task["alphas0_E"] = np.asarray(model["alphas_E"])
    if "solver_iters" in model:
        task["solver_iters"] = int(model["solver_iters"])
    if "inducing_pts_idxs" in model:
        task["inducing_pts_idxs"] = np.asarray(model["inducing_pts_idxs"])
    return task
