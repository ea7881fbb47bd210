"""Experiment harness: CG-step sweeps over preconditioner strategies/sizes.

PyTorch port of ``mlff_tpu.experiments.harness`` (reference:
src/tools/create_data.py): fixed hyperparameters (sig=10, lam=1e-15,
solver='cg', create_data.py:88-97), aspirin-normalized kernel sizes
(create_data.py:75-79), the per-(strategy, k) measurement loop ``cg_steps``
(create_data.py:100-170) and the k-sweep ``minimum_preconditioner_size``
(create_data.py:206-288).  Results are pickled in the reference schema, key
for key the JAX package's (``<precon>_percentage``, ``<precon>_cgsteps``,
``K.shape``, ``total_time_*`` ...), so the reference's analysis code reads
them unchanged.  Every training runs on ``device`` (cuda by default).
"""

from __future__ import annotations

import pickle
import platform as platform_mod
import time
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..data.synthetic import MOLECULES
from ..models.gdml import Trainer
from ..models.task import create_task
from ..utils.log import get_logger

log = get_logger(__name__)

ASPIRIN_ATOMS = MOLECULES["aspirin"]


def device_kind(device=None) -> str:
    """Accelerator model string for result provenance (reference
    cluster_information.py:17-66 maps SGE nodes to GPU/CPU models; here the
    runtime reports it directly): ``cuda:<card name>`` or ``cpu``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return dev.type


def normalize_to_aspirin(n_datapoints_aspirin: int, name: str) -> int:
    """Training-set size giving the same kernel dimension n as aspirin would
    have with ``n_datapoints_aspirin`` points (reference create_data.py:75-79)."""
    d = MOLECULES[str(name).replace("synthetic_", "")]
    return int(n_datapoints_aspirin * ASPIRIN_ATOMS / d)


def harness_task(
    dataset: dict,
    n_datapoints: int,
    sig: float = 10.0,
    lam: float = 1e-15,
    n_valid: int = 1000,
    use_sym: bool = True,
) -> dict:
    """Task with the paper's fixed hyperparameters (create_data.py:88-97)."""
    n_valid = min(n_valid, dataset["R"].shape[0] - n_datapoints - 1)
    return create_task(
        dataset, n_datapoints, dataset, n_valid,
        sig=sig, lam=lam, solver="cg", use_sym=use_sym,
    )


def cg_steps(
    task: dict,
    str_preconditioner: str,
    break_percentage: float,
    flag_eigvals: bool = False,
    out_dir: str | Path | None = None,
    svd_cache: dict | None = None,
    raise_on_nonconv: bool = True,
    device=None,
) -> dict:
    """One (preconditioner, k) training measurement
    (reference create_data.py:100-170)."""
    task = dict(task, str_preconditioner=str_preconditioner)
    trainer = Trainer(device=device)
    t0 = time.perf_counter()
    model = trainer.train(
        task,
        break_percentage=break_percentage,
        str_preconditioner=str_preconditioner,
        flag_eigvals=flag_eigvals,
        svd_cache=svd_cache,
    )
    wall = time.perf_counter() - t0

    n = int(np.asarray(task["F_train"]).size)
    k = len(np.asarray(model.get("inducing_pts_idxs", np.arange(0))))
    num_iters = int(model.get("solver_iters", 0))
    is_conv = bool(model.get("is_conv", True))
    if raise_on_nonconv and not flag_eigvals and not is_conv:
        raise RuntimeError("training did not converge")  # create_data.py:138-139

    total_time_cg = float(model.get("total_time_cg", np.nan))
    result = {
        "dataset_name": str(task["dataset_name"]),
        "n_datapoints": len(np.asarray(task["idxs_train"])),
        "n_kernel": n,
        "K.shape": (n, n),
        "k": k,
        f"{str_preconditioner}_percentage": np.array([k / n]),
        f"{str_preconditioner}_cgsteps": np.array([num_iters]),
        f"{str_preconditioner}_total_time_solve": np.array(
            [float(model.get("total_time_solve", wall))]
        ),
        f"{str_preconditioner}_total_time_preconditioner": np.array(
            [float(model.get("total_time_preconditioner", np.nan))]
        ),
        f"{str_preconditioner}_total_time_cg": np.array([total_time_cg]),
        "time_cg_step": total_time_cg / max(num_iters, 1),
        "sig": float(task["sig"]),
        "lam": float(model["lam"]),
        "solver_tol": float(task["solver_tol"]),
        "is_conv": is_conv,
        "platform": platform_mod.uname(),
        # accelerator provenance (reference src/tools/cluster_information.py)
        "device": device_kind(trainer.device),
        "solver_runtime_s": wall,
    }
    if flag_eigvals:
        result["eigvals"] = np.asarray(model.get("eigvals", []))
        result["eigvals_K"] = np.asarray(model.get("eigvals_K", []))
    if "total_time_cholesky" in model:
        result["t_cholesky"] = float(model["total_time_cholesky"])
    if "time_cholesky" in model:
        result["chol_time_per_pivot"] = np.asarray(model["time_cholesky"])

    if out_dir is not None:
        out_dir = Path(out_dir) / str(task["dataset_name"]) / str_preconditioner / f"n = {n}"
        out_dir.mkdir(parents=True, exist_ok=True)
        stamp = datetime.now().strftime("%Y-%m-%d_%H%M")
        path = out_dir / f"{stamp}_k = {k}.pickle"
        with open(path, "wb") as f:
            pickle.dump(result, f)
        log.info("pickled %s", path)
    return result


def minimum_preconditioner_size(
    task: dict,
    str_preconditioner: str = "lev_random",
    percentages: np.ndarray | None = None,
    n_measurements: int = 8,
    min_columns: int = 50,
    max_percentage: float = 0.5,
    log_spacing: bool = True,
    out_dir: str | Path | None = None,
    device=None,
) -> dict:
    """k-sweep for one molecule/strategy (reference create_data.py:206-288 +
    cluster_main.create_list_percentage).  Merges the per-k results into a
    single dict with array-valued keys like the archived pickles."""
    n = int(np.asarray(task["F_train"]).size)
    if percentages is None:
        lo = min_columns / n
        percentages = (
            np.geomspace(lo, max_percentage, n_measurements)
            if log_spacing
            else np.linspace(lo, max_percentage, n_measurements)
        )

    merged: dict = {}
    svd_cache: dict = {}
    for p in percentages:
        res = cg_steps(
            task, str_preconditioner, float(p),
            out_dir=out_dir, svd_cache=svd_cache, raise_on_nonconv=False,
            device=device,
        )
        for key, val in res.items():
            if isinstance(val, np.ndarray) and key.startswith(str_preconditioner):
                merged.setdefault(key, []).append(val[0])
            elif key not in merged:
                merged[key] = val
    for key in list(merged):
        if isinstance(merged[key], list):
            merged[key] = np.asarray(merged[key])
    return merged


def spectra(task: dict, str_preconditioner: str, break_percentage: float,
            device=None) -> dict:
    """Preconditioned-spectrum measurement (reference create_data.py:173-203)."""
    return cg_steps(
        task, str_preconditioner, break_percentage,
        flag_eigvals=True, raise_on_nonconv=False, device=device,
    )


def merge_sweeps(sweeps: list[dict]) -> dict:
    """Merge per-strategy sweep dicts (minimum_preconditioner_size outputs)
    into one archive-schema dict carrying every strategy's
    ``<label>_percentage`` / ``<label>_cgsteps`` arrays — the layout the
    reference's multi-strategy pickles use
    (data/data/cg_performance_n=15750/*) and the comparison plots consume."""
    merged: dict = {}
    for sweep in sweeps:
        for key, val in sweep.items():
            if key not in merged:
                merged[key] = val
    return merged


def spectra_sweep(
    task: dict,
    strategies: tuple[str, ...],
    percentages: tuple[float, ...],
    device=None,
) -> dict:
    """Preconditioned spectra over a (strategy x percentage) grid, in the
    reference pickle layout: ``eigvals_<label>_<p:.2f>`` with p in PERCENT
    (plot_data.py:206-370 parses percentages out of these key names) plus
    ``eigvals_<label>_0`` for the raw kernel spectrum."""
    merged: dict = {}
    svd_cache: dict = {}
    for label in strategies:
        percentage_arr = []
        for p in percentages:
            res = cg_steps(
                task, label, float(p), flag_eigvals=True,
                raise_on_nonconv=False, svd_cache=svd_cache, device=device,
            )
            merged.setdefault(f"eigvals_{label}_0", res["eigvals_K"])
            merged[f"eigvals_{label}_{100 * p:.2f}"] = res["eigvals"]
            percentage_arr.append(res[f"{label}_percentage"][0])
            for key in ("dataset_name", "K.shape", "n_kernel", "n_datapoints"):
                merged.setdefault(key, res[key])
        merged[f"{label}_percentage"] = np.asarray(percentage_arr)
    return merged
