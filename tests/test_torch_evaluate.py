"""The port's evaluate / validate / select_model against the JAX package's
on the same model dicts: two analytic models (sig = 3 and 5) of synthetic
ethanol at N_train = 20, trained once by the JAX package.  The two f64
Predictors differ by summation order only.  The force, magnitude and cosine
fields of ``EvalResult`` agree within 1e-10 relative (~1e-12 measured).
The energy fields are held to 1e-10 of the model's integration constant
|c| instead: a predicted energy is c (3e4-1e5 here) plus a contraction
that cancels it to within the label spread, so summation order moves
e_mae by ~1e-13 of |c|, which is 2e-9 of e_mae itself.  The test sets are
the same stratified indices, and the same model is selected."""

import numpy as np
import pytest

pytest.importorskip("torch")

from mlff_tpu.models import evaluate as jev  # noqa: E402
from mlff_tpu.models.gdml import Trainer as JaxTrainer  # noqa: E402
from mlff_tpu.models.task import create_task  # noqa: E402
from mlff_tpu_torch.models import evaluate as tev  # noqa: E402
from .torch_threads import one_torch_thread  # noqa: E402,F401

RTOL = 1e-10
FIELDS = ("f_mae", "f_rmse", "mag_mae", "mag_rmse", "cos_mae", "cos_rmse",
          "e_mae", "e_rmse")


@pytest.fixture(scope="module")
def models(ethanol_ds):
    out = []
    for sig in (3.0, 5.0):
        task = create_task(ethanol_ds, 20, ethanol_ds, n_valid=30, sig=sig,
                           solver="analytic")
        out.append(JaxTrainer().train(task))
    return out


def _assert_same_result(got, want, n_points, c):
    assert got.n_points == want.n_points == n_points
    for field in FIELDS:
        g, w = getattr(got, field), getattr(want, field)
        scale = abs(c) if field.startswith("e_") else abs(w)
        if np.isnan(w):
            assert np.isnan(g), field
        else:
            assert abs(g - w) <= RTOL * scale, (field, g, w)
    assert got.as_dict().keys() == want.as_dict().keys()


def _recording(monkeypatch, module, calls):
    real = module.draw_strat_sample

    def draw(*args, **kw):
        idxs = real(*args, **kw)
        calls.append(idxs)
        return idxs

    monkeypatch.setattr(module, "draw_strat_sample", draw)


@pytest.mark.parametrize("n_points", [-1, 50, 349])
def test_evaluate_matches_jax(models, ethanol_ds, monkeypatch, n_points):
    """All held-out points (-1), a stratified sample of 50, and 349 (one
    short of all: still the stratified draw), the same indices drawn."""
    drawn_j, drawn_t = [], []
    _recording(monkeypatch, jev, drawn_j)
    _recording(monkeypatch, tev, drawn_t)
    m = models[1]
    want = jev.evaluate(m, ethanol_ds, n_points=n_points, batch_size=64)
    got = tev.evaluate(m, ethanol_ds, n_points=n_points, batch_size=64,
                       device="cpu")
    n_free = 400 - len(set(np.concatenate([m["idxs_train"],
                                           m["idxs_valid"]]).tolist()))
    _assert_same_result(got, want, n_free if n_points == -1 else n_points,
                        m["c"])
    assert len(drawn_t) == len(drawn_j) == (0 if n_points == -1 else 1)
    for a, b in zip(drawn_t, drawn_j):
        np.testing.assert_array_equal(a, b)


def test_evaluate_without_energies_matches_jax(models, ethanol_ds):
    """A dataset without E: the test set is a seeded uniform draw and the
    energy errors stay NaN."""
    ds = {k: v for k, v in ethanol_ds.items() if k != "E"}
    want = jev.evaluate(models[0], ds, n_points=40, seed=4)
    got = tev.evaluate(models[0], ds, n_points=40, seed=4, device="cpu")
    _assert_same_result(got, want, 40, models[0]["c"])
    assert np.isnan(got.e_mae)


def test_evaluate_given_indices_matches_jax(models, ethanol_ds):
    idxs = np.arange(100, 180, 3)
    want = jev.evaluate(models[0], ethanol_ds, idxs=idxs)
    got = tev.evaluate(models[0], ethanol_ds, idxs=idxs, device="cpu")
    _assert_same_result(got, want, len(idxs), models[0]["c"])


def test_validate_and_select_model_match_jax(models, ethanol_ds):
    for m in models:
        _assert_same_result(tev.validate(m, ethanol_ds, device="cpu"),
                            jev.validate(m, ethanol_ds), 30, m["c"])
    best_t, res_t = tev.select_model(models, ethanol_ds, device="cpu")
    best_j, res_j = jev.select_model(models, ethanol_ds)
    assert best_t == best_j
    assert res_t[best_t].f_mae == min(r.f_mae for r in res_t)
    for m, got, want in zip(models, res_t, res_j):
        _assert_same_result(got, want, 30, m["c"])


def test_online_err_matches_jax():
    err = np.random.default_rng(2).normal(size=(7, 27))
    assert tev._online_err(err, 27, 7, 1.5, 2.5) == jev._online_err(
        err, 27, 7, 1.5, 2.5)
