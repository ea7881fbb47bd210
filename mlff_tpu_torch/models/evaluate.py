"""Model validation/testing: online MAE/RMSE for energies, force components,
force magnitudes, and normalized cosine errors.

PyTorch port of ``mlff_tpu.models.evaluate`` (reference: sgdml/cli.py:855-866
`_online_err`, cli.py:1214-1260 the test/validate metric loop, cli.py:1443+
sigma model selection).  Predictions come from the f64 ``Predictor`` with
``fast=False``, as in the JAX package; the metrics are host NumPy.  With
a ``mesh`` the query batches are split over its ranks (``Predictor(mesh=)``)
and every rank computes the same metrics.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

import numpy as np

from ..utils.log import get_logger
from ..utils.sampling import draw_strat_sample
from .predict import Predictor

log = get_logger(__name__)


def _online_err(err, size, n, mae_n_sum, rmse_n_sum):
    """Numerically-stable online MAE/RMSE accumulation
    (identical semantics to reference cli.py:855-866)."""
    err = np.abs(err)
    mae_n_sum += np.sum(err) / size
    mae = mae_n_sum / n
    rmse_n_sum += np.sum(err**2) / size
    rmse = np.sqrt(rmse_n_sum / n)
    return mae, mae_n_sum, rmse, rmse_n_sum


@dataclass
class EvalResult:
    n_points: int
    f_mae: float
    f_rmse: float
    mag_mae: float
    mag_rmse: float
    cos_mae: float
    cos_rmse: float
    e_mae: float = float("nan")
    e_rmse: float = float("nan")

    def as_dict(self):
        return asdict(self)


def evaluate(
    model: dict,
    dataset: dict,
    idxs: np.ndarray | None = None,
    n_points: int = -1,
    batch_size: int = 250,
    seed: int = 0,
    device=None,
    mesh=None,
) -> EvalResult:
    """Compute prediction errors of ``model`` on ``dataset``, predicting on
    ``device`` (cuda by default), the batches split over ``mesh``'s ranks
    when one is given.

    ``idxs`` selects the evaluation subset; if absent, a stratified sample of
    ``n_points`` (all points for -1) drawn away from the model's train/valid
    indices (reference cli.py test-set sampling semantics).
    """
    pred = Predictor(model, device=device, mesh=mesh)
    use_E = bool(np.asarray(model.get("use_E", False))) and "E" in dataset

    if idxs is None:
        excl = np.concatenate(
            [np.asarray(model["idxs_train"]).ravel(),
             np.asarray(model["idxs_valid"]).ravel()]
        ).astype(np.int64)
        n_avail = dataset["F"].shape[0] - len(set(excl.tolist()))
        if n_points == -1 or n_points >= n_avail:
            idxs = np.setdiff1d(
                np.arange(dataset["F"].shape[0]), excl, assume_unique=False
            )
        elif "E" in dataset:
            idxs = draw_strat_sample(dataset["E"], n_points, excl_idxs=excl,
                                     seed=seed)
        else:
            rng = np.random.default_rng(seed)
            cands = np.setdiff1d(np.arange(dataset["F"].shape[0]), excl)
            idxs = np.sort(rng.choice(cands, n_points, replace=False))

    n_atoms = np.asarray(model["z"]).shape[0]

    e_mae = e_rmse = float("nan")
    e_mae_sum = e_rmse_sum = 0.0
    f_mae_sum = f_rmse_sum = 0.0
    mag_mae_sum = mag_rmse_sum = 0.0
    cos_mae_sum = cos_rmse_sum = 0.0
    n_done = 0

    for start in range(0, len(idxs), batch_size):
        b = idxs[start : start + batch_size]
        n_done += len(b)
        e_pred, f_pred = pred.predict(dataset["R"][b])
        f_pred = f_pred.reshape(len(b), -1)

        if use_E:
            e = np.squeeze(dataset["E"][b])
            e_mae, e_mae_sum, e_rmse, e_rmse_sum = _online_err(
                e - e_pred, 1, n_done, e_mae_sum, e_rmse_sum
            )

        f = dataset["F"][b].reshape(len(b), -1)
        f_mae, f_mae_sum, f_rmse, f_rmse_sum = _online_err(
            f - f_pred, 3 * n_atoms, n_done, f_mae_sum, f_rmse_sum
        )

        f_pred_mags = np.linalg.norm(f_pred.reshape(-1, 3), axis=1)
        f_mags = np.linalg.norm(f.reshape(-1, 3), axis=1)
        mag_mae, mag_mae_sum, mag_rmse, mag_rmse_sum = _online_err(
            f_pred_mags - f_mags, n_atoms, n_done, mag_mae_sum, mag_rmse_sum
        )

        cos_err = (
            np.arccos(
                np.clip(
                    np.einsum(
                        "ij,ij->i",
                        f_pred.reshape(-1, 3) / f_pred_mags[:, None],
                        f.reshape(-1, 3) / f_mags[:, None],
                    ),
                    -1,
                    1,
                )
            )
            / np.pi
        )
        cos_mae, cos_mae_sum, cos_rmse, cos_rmse_sum = _online_err(
            cos_err, n_atoms, n_done, cos_mae_sum, cos_rmse_sum
        )

    return EvalResult(
        n_points=n_done,
        f_mae=float(f_mae), f_rmse=float(f_rmse),
        mag_mae=float(mag_mae), mag_rmse=float(mag_rmse),
        cos_mae=float(cos_mae), cos_rmse=float(cos_rmse),
        e_mae=float(e_mae), e_rmse=float(e_rmse),
    )


def validate(model: dict, valid_dataset: dict, batch_size: int = 250,
             device=None, mesh=None) -> EvalResult:
    """Errors on the task's validation split (reference cli.validate)."""
    return evaluate(
        model, valid_dataset, idxs=np.asarray(model["idxs_valid"]),
        batch_size=batch_size, device=device, mesh=mesh,
    )


def select_model(models: list[dict], valid_dataset: dict,
                 device=None) -> tuple[int, list[EvalResult]]:
    """Pick the model (e.g. across a sigma sweep) with the lowest validation
    force MAE (reference cli.select, cli.py:1443+)."""
    results = [validate(m, valid_dataset, device=device) for m in models]
    crit = [r.f_mae for r in results]
    best = int(np.argmin(crit))
    log.info(
        "model selection: best sig=%s (f_mae=%.5f)",
        models[best].get("sig"), crit[best],
    )
    return best, results
