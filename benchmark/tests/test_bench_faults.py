"""The check catches a broken timed path: each cell's run on the CPU at a
cut size, with the program broken underneath it, comes out not correct,
once for each fault the cell can have.  (A cell here runs on one chip, so
it has no exchange between chips to leave out.)"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from benchmark.tests import tiny


def test_unbroken_runs_are_correct():
    for name in ("ethanol-n31k.train", "aspirin-n15k.predict"):
        assert tiny.run(tiny.cell(name))["correct"] is True


# -- training ------------------------------------------------------------

def solve_returns_its_start(monkeypatch):
    """The solve hands back its starting iterate (zeros) unchanged."""
    from mlff_tpu_torch.models import gdml

    real = gdml.solve_iterative

    def broken(*args, **kwargs):
        res = real(*args, **kwargs)
        return dataclasses.replace(res, alphas=np.zeros_like(res.alphas))

    monkeypatch.setattr(gdml, "solve_iterative", broken)


def half_the_points_left_out(monkeypatch):
    """The labels of the second half of the training points are dropped:
    the solve fits the first half only."""
    from mlff_tpu_torch.models.gdml import Trainer

    real = Trainer.labels

    def broken(self, task):
        y, y_std, e = real(self, task)
        y = y.copy()
        y[y.size // 2:] = 0.0
        return y, y_std, e

    monkeypatch.setattr(Trainer, "labels", broken)


def descriptor_altered(monkeypatch):
    """One stored training descriptor altered by a part in 1e9."""
    from mlff_tpu_torch.models.gdml import Trainer

    real = Trainer.create_model

    def broken(self, *args, **kwargs):
        model = real(self, *args, **kwargs)
        model["R_desc"] = model["R_desc"].copy()
        model["R_desc"][0, 0] *= 1 + 1e-9
        return model

    monkeypatch.setattr(Trainer, "create_model", broken)


def coefficient_altered(monkeypatch):
    """One coefficient of the solution altered by a part in 1e3."""
    from mlff_tpu_torch.models.gdml import Trainer

    real = Trainer.create_model

    def broken(self, task, solver, X, Jc, std, alphas_F, **kwargs):
        alphas_F = np.array(alphas_F)
        alphas_F[0] *= 1 + 1e-3
        return real(self, task, solver, X, Jc, std, alphas_F, **kwargs)

    monkeypatch.setattr(Trainer, "create_model", broken)


@pytest.mark.parametrize("cell", ["ethanol-n31k.train", "aspirin-n15k.train"])
@pytest.mark.parametrize("fault", [solve_returns_its_start,
                                   half_the_points_left_out,
                                   descriptor_altered, coefficient_altered])
def test_training_fault_is_caught(monkeypatch, cell, fault):
    fault(monkeypatch)
    out = tiny.run(tiny.cell(cell))
    assert out["correct"] is False, out["checks"]


# -- prediction ----------------------------------------------------------

def answer_never_changes(monkeypatch):
    """Every call returns the first call's answer."""
    from mlff_tpu_torch.models.predict import Predictor

    real, first = Predictor.predict, {}

    def broken(self, R):
        if "out" not in first:
            first["out"] = real(self, R)
        return first["out"]

    monkeypatch.setattr(Predictor, "predict", broken)


def half_the_batch_left_out(monkeypatch):
    """Only the first half of each call's geometries is predicted; the
    rest get copies of those answers."""
    from mlff_tpu_torch.models.predict import Predictor

    real = Predictor.predict

    def broken(self, R):
        R = np.asarray(R)
        h = max(1, R.shape[0] // 2)
        E, F = real(self, R[:h])
        idx = np.arange(R.shape[0]) % h
        return E[idx], F[idx]

    monkeypatch.setattr(Predictor, "predict", broken)


def force_altered(monkeypatch):
    """The last geometry's force of each call altered by a part in 1e7."""
    from mlff_tpu_torch.models.predict import Predictor

    real = Predictor.predict

    def broken(self, R):
        E, F = real(self, R)
        F = F.copy()
        F[-1] *= 1 + 1e-7
        return E, F

    monkeypatch.setattr(Predictor, "predict", broken)


@pytest.mark.parametrize("cell", ["aspirin-n15k.predict", "ethanol-n31k.md"])
@pytest.mark.parametrize("fault", [answer_never_changes,
                                   half_the_batch_left_out, force_altered])
def test_prediction_fault_is_caught(monkeypatch, cell, fault):
    if cell.endswith(".md") and fault is half_the_batch_left_out:
        pytest.skip("a call of one geometry has no half to leave out")
    fault(monkeypatch)
    out = tiny.run(tiny.cell(cell))
    assert out["correct"] is False, out["checks"]
