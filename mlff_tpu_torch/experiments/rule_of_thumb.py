"""Rule-of-thumb engine: preconditioner-size cost model, slope fitting,
closed-form optimum.

Rebuild of the reference analysis (reference: src/tools/plot_data.py:629-674
`rule_of_thumb_fn`/`measure_slope`, 677-734 `get_params`, 737-826
`calculate_optimal_precon_k`, 1254-1258 `rule_of_thumb`).  A verbatim copy
of ``mlff_tpu.experiments.rule_of_thumb`` (NumPy/SciPy only), so that the
port imports nothing of the JAX package.

Cost model:  cost(k) = prefactor * (k / k_unity)^(-m) + (k / n)^2
  — the first term models CG iterations shrinking with preconditioner rank k,
  the second the quadratic preconditioner construction cost.  Minimizing
  gives the closed-form optimal rank  k*(n) = (k_unity^m * m * n^2 / 2)^(1/(2+m)).
"""

from __future__ import annotations

from typing import Union

import numpy as np
from scipy.interpolate import interp1d
from scipy.optimize import curve_fit

# Fitted (slope m, k_unity) per molecule from the reference's cluster runs
# (reference plot_data.py:677-734; data/rule_of_thumb.csv rows 0-6).
FITTED_PARAMS = {
    "default": (1.0, 100),
    "ethanol": (0.87, 10),
    "uracil": (1.07, 32),
    "toluene": (1.01, 44),
    "C6H5CH3": (1.01, 44),
    "aspirin": (1.14, 236),
    "azobenzene": (1.02, 62),
    "azobenzene_new": (1.02, 62),
    "catcher": (1.02, 316),
    "aims_catcher": (1.02, 316),
    "nanotube": (0.73, 89),
    "aims_nanotube": (0.73, 89),
}


def get_params(dataset_name: str) -> tuple[float, int, float]:
    """(slope, k_unity, prefactor) for a molecule (reference plot_data.py:677)."""
    name = str(dataset_name).replace("synthetic_", "")
    slope, k_unity = FITTED_PARAMS.get(name, FITTED_PARAMS["default"])
    return slope, k_unity, 1.0


def rule_of_thumb_fn(k_column, slope, prefactor, k_unity, n_kernel_rule):
    """Relative-cost model over preconditioner rank k (plot_data.py:629-631)."""
    return prefactor * (k_column / k_unity) ** (-slope) + (k_column / n_kernel_rule) ** 2


def rule_of_thumb(n: Union[np.ndarray, int], k_min: int, m: float):
    """Closed-form optimal preconditioner rank k*(n) (plot_data.py:1254-1258).

    ``k_min`` is the fitted k_unity, ``m`` the fitted slope."""
    res = (k_min**m * m * n**2 / 2) ** (1 / (2 + m))
    if isinstance(n, (int, np.integer)):
        res = int(np.floor(res))
    return res


def jackknife(measurements: np.ndarray) -> tuple[float, float]:
    """Leave-one-out mean and spread (reference plot_data.py:612-626)."""
    measurements = np.asarray(measurements, dtype=float)
    n = len(measurements)
    mask = np.zeros(n, dtype=bool)
    means = []
    for i in range(n):
        mask[i] = True
        means.append(measurements[~mask].mean())
        mask[i] = False
    means = np.array(means)
    return float(means.mean()), float(means.std())


def fit_slope(
    k_columns: np.ndarray,
    cg_steps: np.ndarray,
    n_kernel: int,
    mask_fraction: float = 0.7,
) -> tuple[float, float]:
    """Fit (slope, k_unity) of cg_steps/n ~ (k/k_unity)^(-slope) on the sweep
    (reference `measure_slope`, plot_data.py:634-674)."""
    cg_norm = np.asarray(cg_steps, dtype=float) / n_kernel
    k = np.asarray(k_columns, dtype=float)
    mask = k / n_kernel < mask_fraction

    def fn(k_col, slope, k_unity):
        return (k_col / k_unity) ** (-slope)

    params, _ = curve_fit(
        fn, k[mask], cg_norm[mask], sigma=cg_norm[mask] * 0.05,
        bounds=(0.0001, np.inf),
    )
    return float(params[0]), float(params[1])


def optimal_precon_k(
    k_columns: np.ndarray,
    time_solve: np.ndarray,
    time_preconditioner: np.ndarray,
    time_cg: np.ndarray,
    n_kernel: int,
    dataset_name: str = "default",
) -> dict:
    """Empirical and model-predicted optimal k from a k-sweep
    (reference `calculate_optimal_precon_k`, plot_data.py:737-826)."""
    k = np.asarray(k_columns, dtype=float)
    ki = np.linspace(k.min() * 1.01, k.max() * 0.999, 10000)

    t_solve = interp1d(k, time_solve)(ki)
    t_pre = interp1d(k, time_preconditioner)(ki)
    t_cg = interp1d(k, time_cg)(ki)

    out = {
        "optimal_experimental_k": float(k[np.argmin(time_solve)]),
        "minimal_time_solve": float(np.min(time_solve)),
    }
    near = t_solve < 1.25 * t_solve.min()
    out["upper_bound_k"] = float(ki[near].max())
    out["lower_bound_k"] = float(ki[near].min())

    # heuristic: grow k until preconditioner construction costs half the CG time
    rel = t_cg / t_pre
    i2 = int(np.abs(rel - 2).argmin())
    out["ratio2_k"] = float(ki[i2])
    out["ratio2_factor"] = float(t_solve[i2] / t_solve.min())

    for name, tag in ((dataset_name, "specific"), ("default", "default")):
        slope, k_unity, prefactor = get_params(name)
        cost = rule_of_thumb_fn(ki, slope, prefactor, k_unity, n_kernel)
        iopt = int(np.argmin(cost))
        out[f"rule_of_thumb_k_{tag}"] = float(ki[iopt])
        out[f"rule_of_thumb_factor_{tag}"] = float(t_solve[iopt] / t_solve.min())

    # smallest measured k baseline (plot_data.py:792-794)
    out["smallest_k"] = float(k.min())
    out["smallest_factor"] = float(
        np.asarray(time_solve)[np.argmin(k)] / np.min(time_solve)
    )

    # naive 1%-of-n baseline
    inaive = int(np.abs(ki / n_kernel - 0.01).argmin())
    out["naive_k"] = float(ki[inaive])
    out["naive_factor"] = float(t_solve[inaive] / t_solve.min())
    return out
