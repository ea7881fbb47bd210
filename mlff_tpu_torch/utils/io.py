"""Dataset / task / model IO: npz containers, MD5 fingerprints, file naming.

Rebuild of the reference's L0 data layer
(reference: src/sGDML/sgdml/utils/io.py:162-231).  Datasets are flat dicts of
numpy arrays with keys ``R`` (M, A, 3), ``F`` (M, A, 3), ``E`` (M,) or
(M, 1), ``z`` (A,), ``name``, ``theory``, ``md5`` and optionally ``lattice``
(3, 3) plus unit strings ``r_unit`` / ``e_unit``.

A verbatim copy of ``mlff_tpu.utils.io``: the port imports nothing of the
JAX package, and the npz files both packages write stay interchangeable.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np

# Keys that enter the dataset fingerprint, in this order
# (reference: sgdml/utils/io.py:210-231 hashes z, R, E, F).
_FINGERPRINT_KEYS = ("z", "R", "E", "F")


def dataset_md5(dataset: dict) -> str:
    """MD5 fingerprint over the physically meaningful dataset contents."""
    md5 = hashlib.md5()
    for key in _FINGERPRINT_KEYS:
        if key in dataset and dataset[key] is not None:
            arr = np.ascontiguousarray(dataset[key])
            md5.update(arr.tobytes())
    return md5.hexdigest()


def load_dataset(path: str | Path) -> dict:
    """Load an npz dataset into a plain dict and verify its fingerprint."""
    with np.load(path, allow_pickle=True) as handle:
        data = {k: handle[k] for k in handle.files}
    for key in ("name", "theory", "md5", "r_unit", "e_unit"):
        if key in data and data[key].ndim == 0:
            data[key] = data[key][()]
    if "md5" in data:
        stored = str(np.asarray(data["md5"]).astype(str))
        actual = dataset_md5(data)
        if stored and stored != actual:
            raise ValueError(
                f"Dataset fingerprint mismatch for {path}: "
                f"stored {stored} != computed {actual}"
            )
    return data


def save_dataset(path: str | Path, dataset: dict) -> None:
    dataset = dict(dataset)
    dataset["md5"] = dataset_md5(dataset)
    np.savez_compressed(path, **dataset)


def train_dir_name(task: dict) -> str:
    """Canonical directory name for a training run (mirrors the semantics of
    reference sgdml/utils/io.py:162-207)."""
    n_train = int(np.asarray(task["idxs_train"]).size)
    n_perms = int(np.asarray(task["perms"]).shape[0]) if "perms" in task else 1
    sig = task["sig"]
    return "{}-train{}-sym{}-sig{:04g}".format(
        str(task["dataset_name"]), n_train, n_perms, sig
    )


def model_file_name(task_or_model: dict, is_extended: bool = False) -> str:
    base = train_dir_name(task_or_model)
    suffix = "-model" if is_extended else ""
    return f"{base}{suffix}.npz"


def save_model(path: str | Path, model: dict) -> None:
    np.savez_compressed(path, **model)


def load_model(path: str | Path) -> dict:
    with np.load(path, allow_pickle=True) as handle:
        model = {k: handle[k] for k in handle.files}
    for key in ("dataset_name", "dataset_theory", "solver_name"):
        if key in model and model[key].ndim == 0:
            model[key] = model[key][()]
    return model


def is_task(d: dict) -> bool:
    return str(np.asarray(d.get("type", ""))) == "t"


def is_model(d: dict) -> bool:
    return str(np.asarray(d.get("type", ""))) == "m"
