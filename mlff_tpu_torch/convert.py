"""Carry state between the JAX package and the port as NumPy arrays.

``kernel_cache_from_numpy`` builds the port's ``KernelCache`` from the fields
of a JAX ``KernelCache`` (each leaf as a NumPy array), and
``square_cache_from_numpy`` the port's ``SquareCache`` from a JAX one;
``model_from_numpy``
validates a model dict that the JAX package wrote (an npz path or an
in-memory dict) and returns it as the port's model, and the
``*_preconditioner_from_numpy`` functions rebuild a preconditioner from the
factors a JAX preconditioner holds.  None imports the JAX package: the
exchange format is NumPy.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from . import resolve_device
from .ops.kernel import KernelCache, SquareCache
from .solvers import preconditioners as pc
from .utils import io

_CACHE_FIELDS = ("X", "Jc", "S", "P_idx", "Xq", "Xqt", "sig", "lam")
# None in an on-the-fly cache (pairwise=False) / a cache built without R
_CACHE_OPTIONAL = ("A_exp", "A_exp1", "Xsq", "Gsq", "Usq", "Zsq", "C1sq")
_SQUARE_FIELDS = ("Gs", "Gst", "Xs", "Xst", "perms", "A_exp", "A_exp1",
                  "sig", "lam")

# keys the Predictor reads, and the training record's identity
_MODEL_KEYS = ("type", "z", "R_desc", "R_d_desc_alpha", "alphas_F", "perms",
               "sig", "lam", "std", "c", "use_E")


def kernel_cache_from_numpy(fields: dict, device=None) -> KernelCache:
    """Port ``KernelCache`` on ``device`` from NumPy copies of a JAX cache's
    leaves (``{name: np.asarray(getattr(cache, name))}``).  The pairwise
    weights and the square fields may be None (or absent), as in a JAX
    cache built with ``pairwise=False`` or without ``R``."""
    missing = [k for k in _CACHE_FIELDS if fields.get(k) is None]
    if missing:
        raise ValueError(f"kernel cache fields missing: {missing}")
    dev = resolve_device(device)

    def f64(name):
        if fields.get(name) is None:
            return None
        return _tensor(fields[name], np.float64, dev)

    return KernelCache(
        X=f64("X"), Jc=f64("Jc"), S=f64("S"),
        P_idx=_tensor(fields["P_idx"], np.int64, dev),
        Xq=f64("Xq"), Xqt=f64("Xqt"), sig=float(fields["sig"]),
        lam=float(fields["lam"]), **{k: f64(k) for k in _CACHE_OPTIONAL})


def square_cache_from_numpy(fields: dict, device=None) -> SquareCache:
    """Port ``SquareCache`` on ``device`` from NumPy copies of a JAX
    ``SquareCache``'s leaves."""
    missing = [k for k in _SQUARE_FIELDS if fields.get(k) is None]
    if missing:
        raise ValueError(f"square cache fields missing: {missing}")
    dev = resolve_device(device)
    arrays = {k: _tensor(fields[k], np.float64, dev)
              for k in _SQUARE_FIELDS if k not in ("perms", "sig", "lam")}
    return SquareCache(perms=_tensor(fields["perms"], np.int64, dev),
                       sig=float(fields["sig"]), lam=float(fields["lam"]),
                       **arrays)


def _tensor(a, dtype, dev) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=dtype), device=dev)


def split_preconditioner_from_numpy(B, W2, lam, device=None
                                    ) -> pc.WoodburySplitPreconditioner:
    """Port split Woodbury preconditioner from the f64 factors (B, W2)."""
    dev = resolve_device(device)
    return pc.WoodburySplitPreconditioner(
        B=_tensor(B, np.float64, dev), W2=_tensor(W2, np.float64, dev),
        lam=float(lam), info={})


def factor_preconditioner_from_numpy(L, lam, device=None
                                     ) -> pc.WoodburySplitPreconditioner:
    """Port preconditioner P = L L^T + lam I from a low-rank factor L (n, k)
    as a JAX factorization returns it (``res.L`` of the pivoted-Cholesky
    family): the port's ``woodbury_from_factor`` of the same factor."""
    dev = resolve_device(device)
    return pc.woodbury_from_factor(_tensor(L, np.float64, dev), float(lam))


def woodbury_preconditioner_from_numpy(T, lam, device=None
                                       ) -> pc.WoodburyPreconditioner:
    """Port fused Woodbury preconditioner from the (k, n) factor T that a
    JAX ``WoodburyPreconditioner`` holds (its row padding included)."""
    dev = resolve_device(device)
    return pc.WoodburyPreconditioner(T=_tensor(T, np.float64, dev),
                                     lam=float(lam), info={})


def df64_preconditioner_from_numpy(Bh, Bl, W2, lam, Bm=None, device=None
                                   ) -> pc.DF64WoodburyPreconditioner:
    """Port df64 preconditioner from the f32 words of B (hi, lo and the
    optional third component) and W2, as a JAX ``DF64WoodburyPreconditioner``
    holds them (its tile padding included)."""
    dev = resolve_device(device)
    return pc.DF64WoodburyPreconditioner(
        Bh=_tensor(Bh, np.float32, dev), Bl=_tensor(Bl, np.float32, dev),
        W2=_tensor(W2, np.float64, dev), lam=float(lam),
        Bm=None if Bm is None else _tensor(Bm, np.float32, dev),
        info={"apply_impl": "df64", "components": 2 if Bm is None else 3})


def colblock_preconditioner_from_numpy(Bs, W2, lam, device=None
                                       ) -> pc.WoodburyColBlockPreconditioner:
    """Port column-blocked preconditioner from the f64 blocks and W2."""
    dev = resolve_device(device)
    return pc.WoodburyColBlockPreconditioner(
        Bs=tuple(_tensor(B, np.float64, dev) for B in Bs),
        W2=_tensor(W2, np.float64, dev), lam=float(lam), info={})


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
    if model.get("alphas_E") is not None:
        checks["alphas_E"] = (np.asarray(model["alphas_E"]).shape, (n_train,))
    for key, (got, want) in checks.items():
        if tuple(got) != tuple(want):
            raise ValueError(f"model[{key!r}] has shape {got}, expected {want}")
    return model
