"""Model benchmark runner: analytic vs PCG-at-rule-of-thumb-k, runtimes and
accuracy summary.

PyTorch port of ``mlff_tpu.experiments.benchmark_models`` (reference:
src/train_models.py:68-169 ``train_model``/``store_model`` and
src/summarize_accuracy.py:31-174): trains an analytic and a CG model per
molecule at the rule-of-thumb preconditioner rank, records
``solver_runtime_s``, stores models, and emits a speedup/accuracy table
(runtime_analytic / runtime_cg, force MAE deltas).  Trainings and
evaluations run on ``device`` (cuda by default); the ``hardware`` label of
the model directory defaults to ``"gpu"``.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

from ..data.synthetic import make_dataset
from ..models.evaluate import evaluate
from ..models.gdml import Trainer
from ..models.task import create_task
from ..utils import io
from ..utils.log import get_logger
from .rule_of_thumb import get_params, rule_of_thumb

log = get_logger(__name__)


def train_model(
    dataset: dict,
    n_train: int,
    solver: str,
    sig: float = 10.0,
    out_dir: str | Path | None = None,
    hardware: str = "gpu",
    device=None,
) -> dict:
    """Train one benchmark model; for CG the preconditioner rank is the
    rule-of-thumb optimum (reference train_models.py:94-97)."""
    trainer = Trainer(device=device)
    task = create_task(
        dataset, n_train, dataset,
        n_valid=min(200, dataset["R"].shape[0] - n_train - 1),
        sig=sig, solver=solver,
    )
    n = int(np.asarray(task["F_train"]).size)

    kwargs = {}
    if solver == "cg":
        m, k_unity, _ = get_params(str(task["dataset_name"]))
        k_rot = rule_of_thumb(n, k_unity, m)
        kwargs = dict(
            break_percentage=min(float(k_rot) / n, 0.99),
            str_preconditioner="lev_random",
        )
        log.info("rule-of-thumb k = %d (%.1f%% of n=%d)", k_rot, 100 * k_rot / n, n)

    t0 = time.perf_counter()
    model = trainer.train(task, **kwargs)
    model["solver_runtime_s"] = time.perf_counter() - t0

    if out_dir is not None:
        store_model(model, out_dir, hardware, solver)
    return model


def store_model(model: dict, out_dir, hardware: str, solver: str) -> Path:
    """data_new/models/<hw>/<dataset>/<solver>/... layout
    (reference train_models.py:127-154)."""
    d = Path(out_dir) / "models" / hardware / str(model["dataset_name"]) / solver
    d.mkdir(parents=True, exist_ok=True)
    n_train = len(np.asarray(model["idxs_train"]))
    path = d / f"model_ntrain{n_train}_sig{float(model['sig']):g}.npz"
    io.save_model(path, {k: v for k, v in model.items() if not isinstance(v, dict)})
    return path


def speedup_table(
    molecules: list[str],
    n_train: int = 50,
    sig: float = 10.0,
    out_dir: str | Path | None = None,
    device=None,
) -> list[dict]:
    """Analytic-vs-CG runtimes and force-MAE per molecule
    (reference summarize_accuracy.py:111-174)."""
    rows = []
    for name in molecules:
        ds = make_dataset(name, n_samples=max(4 * n_train, 300))
        model_an = train_model(ds, n_train, "analytic", sig=sig,
                               out_dir=out_dir, device=device)
        model_cg = train_model(ds, n_train, "cg", sig=sig, out_dir=out_dir,
                               device=device)
        err_an = evaluate(model_an, ds, n_points=100, device=device)
        err_cg = evaluate(model_cg, ds, n_points=100, device=device)
        row = {
            "molecule": name,
            "n_kernel": int(np.asarray(model_an["R_d_desc_alpha"]).shape[0])
            * len(np.asarray(model_an["z"])) * 3,
            "runtime_analytic_s": model_an["solver_runtime_s"],
            "runtime_cg_s": model_cg["solver_runtime_s"],
            "speedup": model_an["solver_runtime_s"] / model_cg["solver_runtime_s"],
            "f_mae_analytic": err_an.f_mae,
            "f_mae_cg": err_cg.f_mae,
            "cg_iters": int(model_cg.get("solver_iters", 0)),
        }
        rows.append(row)
        log.info("%s", row)
    return rows


def to_latex(rows: list[dict]) -> str:
    """LaTeX accuracy/speedup table (reference summarize_accuracy.py emits
    a pandas-to-latex table)."""
    header = (
        "\\begin{tabular}{lrrrrr}\n"
        "molecule & $t_{analytic}$ [s] & $t_{cg}$ [s] & speedup & "
        "MAE$_{analytic}$ & MAE$_{cg}$ \\\\\n\\hline\n"
    )
    body = "".join(
        f"{r['molecule']} & {r['runtime_analytic_s']:.1f} & {r['runtime_cg_s']:.1f} & "
        f"{r['speedup']:.1f} & {r['f_mae_analytic']:.4f} & {r['f_mae_cg']:.4f} \\\\\n"
        for r in rows
    )
    return header + body + "\\end{tabular}\n"
