"""The port's figure modules (``experiments.plotting``, ``visualize``): the
counterparts of ``tests/test_experiments.py::test_plotting_smoke`` and
``::test_visualize_smoke``, the remaining figures on small archive-schema
dicts, tensors taken where arrays are, and the two numeric helpers against
the JAX package's modules (equal to rounding).  matplotlib is imported
only when a figure is drawn: without it a drawing call raises ImportError
naming it."""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("matplotlib")

from mlff_tpu.experiments import plotting as jplotting  # noqa: E402
from mlff_tpu.experiments import visualize as jvisualize  # noqa: E402
from mlff_tpu_torch.experiments import plotting, visualize  # noqa: E402


def test_plotting_smoke(tmp_path):
    sweeps = {
        "random_scores": {
            "random_scores_percentage": np.array([0.05, 0.1, 0.3]),
            "random_scores_cgsteps": torch.tensor([300, 150, 60]),
        }
    }
    p1 = plotting.plot_cg_steps_vs_k(sweeps, 1000, tmp_path / "curves.png")
    p2 = plotting.plot_spectrum(
        torch.as_tensor(np.geomspace(1, 1e-10, 50)),
        np.geomspace(10, 1e-12, 50), tmp_path / "spec.png")
    p3 = plotting.plot_rule_of_thumb_prediction(15741, "ethanol",
                                                tmp_path / "rot.png")
    p4 = plotting.plot_rule_of_thumb_bars(
        {"ethanol": {"smallest_factor": 1.0, "naive_factor": 1.7,
                     "rule_of_thumb_factor_default": 1.1}},
        tmp_path / "bars.png")
    for p in (p1, p2, p3, p4):
        assert p.exists() and p.stat().st_size > 0


def test_visualize_smoke(tmp_path, ethanol_ds):
    contrib = visualize.calculate_atomic_contributions(
        torch.as_tensor(np.random.default_rng(0).normal(size=(5 * 9 * 3))), 9)
    assert contrib.shape == (9,)
    out = visualize.plot_atomic_contributions(
        ethanol_ds["R"][0], ethanol_ds["z"], contrib, tmp_path / "mol.png")
    assert out.exists()
    assert visualize.plot_single_molecule(
        ethanol_ds["R"][0], ethanol_ds["z"], tmp_path / "plain.png").exists()


def _archive(rng, n=60):
    """A harness-schema dict: spectra of two strategies at two sizes, and
    sweep curves of three ('cholesky' a prefix of 'cholesky_panel')."""
    d = {"K.shape": np.array([n, n]), "dataset_name": "ethanol",
         "n_datapoints": 5}
    for label in ("cholesky", "cholesky_panel"):
        d[f"eigvals_{label}_0"] = np.geomspace(1e6, 1e-4, n)
        for p in (10.0, 30.0):
            d[f"eigvals_{label}_{p:.2f}"] = np.abs(rng.normal(size=n)) + 1.0
    for label in ("eigvec_precon", "cholesky", "lev_random"):
        d[f"{label}_percentage"] = np.array([0.05, 0.1, 0.2, 0.4])
        d[f"{label}_cgsteps"] = np.array([400.0, 200, 90, 30]) * (
            1.0 if label == "eigvec_precon" else 1.3)
    return d


def test_spectrum_grid_and_difference(tmp_path):
    d = _archive(np.random.default_rng(1))
    out = plotting.plot_spectrum_grid(d, tmp_path / "grid.png")
    assert out.exists() and out.stat().st_size > 10_000
    out2 = plotting.plot_cg_steps_difference(d, "eigvec_precon",
                                             tmp_path / "diff.png")
    assert out2.exists()


def test_numeric_helpers_match_jax():
    rng = np.random.default_rng(3)
    v = rng.normal(size=4 * 7 * 3)
    np.testing.assert_allclose(
        visualize.calculate_atomic_contributions(torch.as_tensor(v), 7),
        jvisualize.calculate_atomic_contributions(v, 7), rtol=1e-15)
    e = rng.normal(size=40) * 1e3
    np.testing.assert_allclose(
        plotting._normalized_spectrum(torch.as_tensor(e), 25),
        jplotting._normalized_spectrum(e, 25), rtol=1e-15)


def test_drawing_without_matplotlib_raises(tmp_path, monkeypatch):
    """A missing matplotlib is an ImportError that names it, at the
    drawing call: importing the modules never needed it."""
    for name in list(sys.modules):
        if name.split(".")[0] == "matplotlib":
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        plotting.plot_spectrum(np.ones(3), None, tmp_path / "s.png")
    with pytest.raises(ImportError, match="matplotlib"):
        visualize.plot_single_molecule(np.zeros((3, 3)), [1, 1, 1],
                                       tmp_path / "m.png")
