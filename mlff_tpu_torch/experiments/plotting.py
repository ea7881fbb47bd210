"""Paper-figure plotting: CG-steps-vs-k curves, preconditioned spectra,
rule-of-thumb comparisons.

PyTorch port of ``mlff_tpu.experiments.plotting`` (reference:
src/tools/plot_data.py:105-185 sweep curves, :206-370 spectrum plots,
:1029-1253 rule-of-thumb bar charts; figure entry point
scripts/main_plot.py:67-175; shared rcParams src/tools/init_plt.py).  Host
code: it takes NumPy arrays or tensors and the sweep dicts of
``experiments.harness``, and reads the cost model of the port's own
``experiments.rule_of_thumb``.  Figures are saved, never shown (headless
``Agg``); matplotlib is imported when a figure is drawn, and without it a
drawing call raises ImportError.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch

from .rule_of_thumb import get_params, rule_of_thumb, rule_of_thumb_fn
from .visualize import pyplot


def _np(x, dtype=None) -> np.ndarray:
    x = x.detach().cpu().numpy() if torch.is_tensor(x) else x
    return np.asarray(x, dtype=dtype)


def init_style():
    """Shared figure style (reference src/tools/init_plt.py semantics);
    returns matplotlib.pyplot."""
    plt = pyplot()
    plt.rcParams.update({
        "figure.figsize": (6, 4),
        "font.size": 11,
        "axes.grid": True,
        "grid.alpha": 0.3,
        "savefig.dpi": 150,
        "savefig.bbox": "tight",
    })
    return plt


def plot_cg_steps_vs_k(
    sweeps: dict[str, dict],
    n_kernel: int,
    out: str | Path,
    normalized: bool = True,
):
    """CG iterations vs preconditioner strength for several strategies
    (reference plot_data.py:105-185).  ``sweeps`` maps strategy name to the
    merged sweep dict from experiments.harness.minimum_preconditioner_size.
    """
    plt = init_style()
    fig, ax = plt.subplots()
    for strategy, data in sweeps.items():
        k = _np(data[f"{strategy}_percentage"]) * n_kernel
        steps = _np(data[f"{strategy}_cgsteps"], dtype=float)
        if normalized:
            steps = steps / n_kernel
        ax.plot(k, steps, "o-", label=strategy)
    ax.set_xlabel("preconditioner rank k")
    ax.set_ylabel("CG steps" + (" / n" if normalized else ""))
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.legend()
    fig.savefig(out)
    plt.close(fig)
    return Path(out)


def plot_spectrum(
    eigvals_precon: np.ndarray,
    eigvals_raw: np.ndarray | None,
    out: str | Path,
    title: str = "",
):
    """Spectrum of P^-1 (K + lam I) vs the raw kernel spectrum
    (reference plot_data.py:206-370)."""
    plt = init_style()
    fig, ax = plt.subplots()
    sp = np.sort(np.abs(_np(eigvals_precon)))[::-1]
    ax.plot(sp, label="preconditioned")
    if eigvals_raw is not None:
        sr = np.sort(np.abs(_np(eigvals_raw)))[::-1]
        ax.plot(sr, label="raw kernel")
    ax.set_yscale("log")
    ax.set_xlabel("eigenvalue index")
    ax.set_ylabel("|eigenvalue|")
    if title:
        ax.set_title(title)
    ax.legend()
    fig.savefig(out)
    plt.close(fig)
    return Path(out)


def plot_rule_of_thumb_bars(
    molecule_results: dict[str, dict],
    out: str | Path,
):
    """Relative time-to-solution of k-selection policies per molecule
    (reference plot_data.py:1029-1253 bar chart semantics).  Each value in
    ``molecule_results`` is the dict from rule_of_thumb.optimal_precon_k.
    """
    plt = init_style()
    policies = [
        ("smallest_factor", "minimal k"),
        ("naive_factor", "naive 1% of n"),
        ("rule_of_thumb_factor_default", "RoT default"),
        ("rule_of_thumb_factor_specific", "RoT specific"),
        ("ratio2_factor", "precon/cg = 2"),
    ]
    mols = list(molecule_results)
    x = np.arange(len(mols))
    width = 0.8 / len(policies)
    fig, ax = plt.subplots(figsize=(1.5 * len(mols) + 2, 4))
    for i, (key, label) in enumerate(policies):
        vals = [molecule_results[m].get(key, np.nan) for m in mols]
        ax.bar(x + i * width, vals, width, label=label)
    ax.axhline(1.0, color="k", lw=0.8)
    ax.set_xticks(x + 0.4)
    ax.set_xticklabels(mols, rotation=0)
    ax.set_ylabel("time / optimal time")
    ax.legend()
    fig.savefig(out)
    plt.close(fig)
    return Path(out)


def plot_rule_of_thumb_prediction(
    n_kernel: int, dataset_name: str, out: str | Path,
):
    """Cost-model curve with the closed-form optimum marked
    (reference plot_data.py:629-631, 1254-1258)."""
    plt = init_style()
    slope, k_unity, prefactor = get_params(dataset_name)
    k = np.geomspace(max(k_unity, 2), n_kernel, 400)
    cost = rule_of_thumb_fn(k, slope, prefactor, k_unity, n_kernel)
    k_star = rule_of_thumb(int(n_kernel), k_unity, slope)
    fig, ax = plt.subplots()
    ax.plot(k, cost)
    ax.axvline(k_star, ls="--", color="C1", label=f"k* = {k_star}")
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("preconditioner rank k")
    ax.set_ylabel("modeled relative cost")
    ax.set_title(f"{dataset_name}, n = {n_kernel}")
    ax.legend()
    fig.savefig(out)
    plt.close(fig)
    return Path(out)


# consistent strategy colors across every figure (reference
# plot_data.py map_dict_label_to_color semantics, our own palette)
_STRATEGY_COLORS = {
    "eigvec_precon": "#4053d3",
    "cholesky": "#ddb310",
    "cholesky_panel": "#b51d14",
    "rpcholesky": "#00beff",
    "lev_random": "#fb49b0",
    "lev_scores": "#00b25d",
    "inverse_lev": "#cacaca",
    "random_scores": "#878500",
    "truncated_cholesky": "#00c6f8",
    "rank_k_lev_scores": "#d163e6",
}


def _strategy_color(label: str):
    return _STRATEGY_COLORS.get(label.removesuffix("_custom"))


def _normalized_spectrum(eigvals: np.ndarray, n_eigvals: int | None = None):
    """|lambda| / |lambda|_min, sorted descending (reference
    plot_data.py:206-209 preprocess_eigvals)."""
    e = np.abs(_np(eigvals, dtype=float))
    e = np.sort(e / e.min())[::-1]
    return e[:n_eigvals]


def plot_spectrum_grid(
    dict_data: dict,
    out: str | Path,
    n_eigvals: int = 150,
    labels: tuple[str, ...] | None = None,
):
    """Preconditioned-spectrum panel figure (reference plot_data.py:206-370).

    One subplot per preconditioning percentage (descending left to right),
    each showing the normalized spectrum of P^-1 K_lambda per strategy on a
    log axis, with the raw kernel spectrum in grey and its condition number
    annotated on the first panel.  ``dict_data`` uses the archive schema of
    harness.spectra_sweep: ``eigvals_<label>_<p:.2f>`` keys, p in percent.
    """
    plt = init_style()
    if labels is None:
        labels = sorted({
            key[len("eigvals_"):key.rfind("_")] for key in dict_data
            if key.startswith("eigvals_") and not key.endswith("_K")
        })
    # percentages present for the first strategy (reference parses key names).
    # Match the numeric tail strictly: one strategy label may be a proper
    # prefix of another in the same sweep ('cholesky' vs 'cholesky_panel'),
    # so a bare startswith() would try float('panel_15.00') and crash.
    pat = re.compile(r"^eigvals_" + re.escape(labels[0]) + r"_(\d+(?:\.\d+)?)$")
    percentages = sorted(
        {p for key in dict_data
         for m in [pat.match(key)] if m
         for p in [float(m.group(1))] if p > 0},
        reverse=True,
    )
    if not percentages:
        raise ValueError("no spectrum measurements in dict_data")

    n_kernel = int(dict_data["K.shape"][0])
    n_panels = len(percentages)
    fig, axes = plt.subplots(
        1, n_panels, sharex=True, sharey=True,
        figsize=(1.9 * n_panels + 1.6, 2.6), squeeze=False,
    )
    raw = _normalized_spectrum(dict_data[f"eigvals_{labels[0]}_0"], n_eigvals)
    for i, (ax, p) in enumerate(zip(axes[0], percentages)):
        ax.plot(raw, c="grey", alpha=0.5, label="raw kernel" if i == 0 else None)
        for label in labels:
            key = f"eigvals_{label}_{p:.2f}"
            if key not in dict_data:
                continue
            ax.plot(_normalized_spectrum(dict_data[key], n_eigvals),
                    c=_strategy_color(label), label=label if i == n_panels - 1 else None)
        ax.set_yscale("log")
        ax.set_title(f"k = {int(p / 100.0 * n_kernel)}", fontsize=10)
        if i == 0:
            ax.set_ylabel(r"spectrum of $P^{-1} K_\lambda$")
            ax.annotate(f"$\\kappa$ = {raw.max():.1e}", (0.05, 0.05),
                        xycoords="axes fraction", fontsize=8, color="grey")
        ax.set_xlabel("# eigenvalues")
    axes[0, -1].legend(fontsize=8, loc="upper right")
    fig.suptitle(
        f"{dict_data.get('dataset_name', '')}, n = {n_kernel}", fontsize=10)
    fig.savefig(out)
    plt.close(fig)
    return Path(out)


def plot_cg_steps_difference(
    dict_datas: dict | list,
    reference_label: str,
    out: str | Path,
    labels: tuple[str, ...] | None = None,
):
    """Difference-to-baseline CG-step curves (reference
    plot_data.py:1289-1361): for each strategy, the interpolated
    iterations-vs-k/n curve minus the baseline strategy's (usually the
    truncated-SVD 'eigvec_precon'), i.e. the suboptimality gap
    #_method(k) - #_baseline(k), log scale.  Pass one archive-schema dict
    (single molecule) or a list (stacked panels, one molecule each)."""
    from scipy.interpolate import interp1d

    plt = init_style()
    if isinstance(dict_datas, dict):
        dict_datas = [dict_datas]
    dict_datas = sorted(dict_datas,
                        key=lambda d: d.get("n_datapoints", 0), reverse=True)
    n_rows = len(dict_datas)
    fig, axes = plt.subplots(
        n_rows, 1, sharex=True, figsize=(7, 1.8 * n_rows + 1), squeeze=False)

    for row, (ax, data) in enumerate(zip(axes[:, 0], dict_datas)):
        if f"{reference_label}_percentage" not in data:
            raise ValueError(f"baseline {reference_label!r} missing")
        x_ref = _np(data[f"{reference_label}_percentage"], dtype=float)
        y_ref = _np(data[f"{reference_label}_cgsteps"], dtype=float)
        f_ref = interp1d(x_ref, y_ref, kind="linear")
        row_labels = labels or sorted(
            key[: -len("_cgsteps")] for key in data if key.endswith("_cgsteps"))
        for label in row_labels:
            if label == reference_label or f"{label}_percentage" not in data:
                continue
            x = _np(data[f"{label}_percentage"], dtype=float)
            y = _np(data[f"{label}_cgsteps"], dtype=float)
            f = interp1d(x, y, kind="linear")
            lo = max(x.min(), x_ref.min())
            hi = min(x.max(), x_ref.max())
            if hi <= lo:
                continue
            grid = np.linspace(lo, hi, 500)
            ax.plot(grid, f(grid) - f_ref(grid), c=_strategy_color(label),
                    label=label if row == 0 else None)
        ax.set_yscale("log")
        ax.annotate(str(data.get("dataset_name", "")), (0.98, 0.9),
                    xycoords="axes fraction", ha="right", fontsize=9)
        if row == n_rows // 2:
            ax.set_ylabel(
                f"extra steps vs {reference_label}")
    axes[0, 0].legend(fontsize=8, ncol=2)
    axes[-1, 0].set_xlabel(r"fraction of columns $k/n$")
    fig.savefig(out)
    plt.close(fig)
    return Path(out)
