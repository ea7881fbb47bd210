"""Carry state between the JAX package and the port as NumPy arrays.

``kernel_cache_from_numpy`` builds the port's ``KernelCache`` from the fields
of a JAX ``KernelCache`` (each leaf as a NumPy array), and
``model_from_numpy`` validates a model dict that the JAX package wrote
(an npz path or an in-memory dict) and returns it as the port's model.
Neither imports the JAX package: the exchange format is NumPy.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from . import resolve_device
from .ops.kernel import KernelCache
from .utils import io

_CACHE_FIELDS = ("X", "Jc", "S", "P_idx", "Xq", "Xqt", "A_exp", "A_exp1",
                 "sig", "lam")

# keys the Predictor reads, and the training record's identity
_MODEL_KEYS = ("type", "z", "R_desc", "R_d_desc_alpha", "alphas_F", "perms",
               "sig", "lam", "std", "c", "use_E")


def kernel_cache_from_numpy(fields: dict, device=None) -> KernelCache:
    """Port ``KernelCache`` on ``device`` from NumPy copies of a JAX cache's
    leaves (``{name: np.asarray(getattr(cache, name))}``).  The pairwise
    fields must be present: the port has no on-the-fly matvec yet."""
    missing = [k for k in _CACHE_FIELDS if fields.get(k) is None]
    if missing:
        raise ValueError(f"kernel cache fields missing: {missing}")
    dev = resolve_device(device)

    def f64(name):
        return torch.as_tensor(np.array(fields[name], dtype=np.float64),
                               device=dev)

    return KernelCache(
        X=f64("X"), Jc=f64("Jc"), S=f64("S"),
        P_idx=torch.as_tensor(np.array(fields["P_idx"], dtype=np.int64),
                              device=dev),
        Xq=f64("Xq"), Xqt=f64("Xqt"), A_exp=f64("A_exp"),
        A_exp1=f64("A_exp1"), sig=float(fields["sig"]),
        lam=float(fields["lam"]))


def model_from_numpy(model) -> dict:
    """Validate a JAX-written model (npz path or dict of NumPy values) and
    return the port's model dict.  0-d arrays from an npz round trip become
    Python scalars; array shapes are checked against each other."""
    if isinstance(model, (str, Path)):
        model = io.load_model(model)
    model = dict(model)
    missing = [k for k in _MODEL_KEYS if k not in model]
    if missing:
        raise ValueError(f"model is missing keys {missing}")
    if not io.is_model(model):
        raise ValueError("not a model record (type != 'm')")
    for key, value in list(model.items()):
        if isinstance(value, np.ndarray) and value.ndim == 0:
            model[key] = value[()]
    n_atoms = np.asarray(model["z"]).shape[0]
    D = n_atoms * (n_atoms - 1) // 2
    R_desc = np.asarray(model["R_desc"])
    n_train = R_desc.shape[1]
    checks = {
        "R_desc": (R_desc.shape, (D, n_train)),
        "R_d_desc_alpha": (np.asarray(model["R_d_desc_alpha"]).shape,
                           (n_train, D)),
        "perms": (np.asarray(model["perms"]).shape[1:], (n_atoms,)),
    }
    for key, (got, want) in checks.items():
        if tuple(got) != tuple(want):
            raise ValueError(f"model[{key!r}] has shape {got}, expected {want}")
    return model
