"""Checkpoint and resume in the port against the JAX package (the port's
counterpart of tests/test_checkpoint.py, and more).

* ``pcg``'s ``checkpoint_callback`` fires once per chunk with the same
  ``(num_iters, resid)`` sequence as JAX's ``pcg``.  The system is
  well-conditioned (n = 200, cond 10): on ill-conditioned ones two f64 CG
  runs part after ~25 iterations (loss of orthogonality amplifies the last
  bit), so only a system that converges before that can be held to 1e-12.
* ``Trainer._wrap_ckpt`` turns the same raw snapshot into the same model
  dict as the JAX package's.
* A model saved mid-solve by ``Trainer.train(save_progr_callback=...)``
  predicts like the JAX package's model at the same iteration.
* A task from ``create_task_from_model`` warm-starts ``solve_iterative``:
  ``solver_iters`` carries over (``it0``), and the resumed solve's
  iterations and coefficients match JAX's resume.

Tolerances are stated in each test; the trainings are calibrated or plain
synthetic ethanol at N_train = 30 with the P = 6 permutation group.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mlff_tpu.data.synthetic import (  # noqa: E402
    benchmark_perms, make_benchmark_dataset, make_dataset)
from mlff_tpu.models import task as jtask  # noqa: E402
from mlff_tpu.models.gdml import Trainer as JaxTrainer  # noqa: E402
from mlff_tpu.models.predict import Predictor as JaxPredictor  # noqa: E402
from mlff_tpu.solvers.cg import pcg as jax_pcg  # noqa: E402
from mlff_tpu_torch.models import task as ttask  # noqa: E402
from mlff_tpu_torch.models.gdml import Trainer  # noqa: E402
from mlff_tpu_torch.models.predict import Predictor  # noqa: E402
from mlff_tpu_torch.solvers.cg import pcg  # noqa: E402
from .torch_threads import one_torch_thread  # noqa: E402,F401

N_TRAIN, N_SAMPLES, N_COLUMNS, SIG = 30, 40, 200, 10.0
TRAIN_KW = dict(n_columns=N_COLUMNS, str_preconditioner="lev_random")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _task(kind):
    if kind == "calibrated":
        ds, perms = make_benchmark_dataset("ethanol", n_samples=N_SAMPLES,
                                           seed=11, n_train=N_TRAIN)
    else:
        ds = make_dataset("ethanol", n_samples=N_SAMPLES, seed=3)
        ds["z"] = np.asarray([6, 6, 8, 1, 1, 1, 1, 1, 1])
        perms = benchmark_perms("ethanol")
    task = jtask.create_task(ds, N_TRAIN, ds, n_valid=5, sig=SIG,
                             solver="cg", perms=perms)
    held = np.setdiff1d(np.arange(N_SAMPLES), task["idxs_train"])
    return ds, task, held


def test_pcg_checkpoint_callback_matches_jax():
    """One snapshot per chunk of 5 (checkpoint_every_s = 0): the same
    iteration counts, residuals within 1e-12 relative."""
    rng = np.random.default_rng(0)
    n = 200
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    A = (Q * np.geomspace(1, 10, n)) @ Q.T
    b = rng.normal(size=n)
    kw = dict(tol=1e-10, maxiter=300, chunk=5, checkpoint_every_s=0.0)
    snaps_j, snaps_t = [], []
    res_j = jax_pcg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                    checkpoint_callback=lambda x, it, r: snaps_j.append((it, r)),
                    **kw)
    A_t = torch.as_tensor(A)
    res_t = pcg(lambda v: A_t @ v, torch.as_tensor(b),
                checkpoint_callback=lambda x, it, r: snaps_t.append((it, r)),
                **kw)
    assert res_t.converged and res_j.converged
    its = [it for it, _ in snaps_t]
    assert its == [it for it, _ in snaps_j] == sorted(its)
    assert len(its) >= 5 and its[-1] == res_t.num_iters == res_j.num_iters
    for (_, r_t), (_, r_j) in zip(snaps_t, snaps_j):
        assert abs(r_t - r_j) <= 1e-12 * r_j


def test_wrap_ckpt_model_matches_jax(ethanol_ds):
    """The same raw snapshot (seeded coefficients, 7 iterations) becomes the
    same model dict: equal keys, solver_iters = num_iters + 1 as in the
    reference, coefficients equal, the integration constant and the
    contracted cotangents within 1e-10 relative, predictions within 1e-8."""
    task = jtask.create_task(ethanol_ds, n_train=15, valid_dataset=ethanol_ds,
                             n_valid=10, sig=5.0, solver="cg", use_sym=False)
    alphas = np.random.default_rng(1).normal(size=15 * 9 * 3)
    snap = dict(alphas_psd=alphas, num_iters=7, resid=1.0,
                inducing_pts_idxs=np.arange(5))

    jt = JaxTrainer()
    spec, S, X, Jc, _ = jt.build_kernel_inputs(task)
    y, y_std, _ = jt.labels(task)
    saved_j = []
    jt._wrap_ckpt(saved_j.append, task, spec, S, X, Jc, y, y_std)(**snap)

    tt = Trainer(device="cpu")
    _, _, Xt, Jct, _ = tt.build_kernel_inputs(task)
    yt, yt_std, _ = tt.labels(task)
    saved_t = []
    tt._wrap_ckpt(saved_t.append, task, Xt, Jct, yt, yt_std)(**snap)

    (m_j,), (m_t,) = saved_j, saved_t
    assert set(m_t) == set(m_j)
    assert int(m_t["solver_iters"]) == int(m_j["solver_iters"]) == 8
    np.testing.assert_array_equal(m_t["alphas_F"], m_j["alphas_F"])
    np.testing.assert_array_equal(m_t["inducing_pts_idxs"], np.arange(5))
    assert _rel(m_t["R_d_desc_alpha"], m_j["R_d_desc_alpha"]) <= 1e-10
    assert abs(m_t["c"] - m_j["c"]) <= 1e-10 * abs(m_j["c"])
    R = np.asarray(task["R_train"][:3])
    E_j, F_j = JaxPredictor(m_j).predict(R)
    E_t, F_t = Predictor(m_t, device="cpu").predict(R)
    assert np.all(np.isfinite(F_t))
    assert _rel(F_t, F_j) <= 1e-8
    assert _rel(E_t, E_j) <= 1e-8


def test_checkpoint_mid_solve_predicts_like_jax(monkeypatch):
    """Calibrated ethanol capped at 50 iterations, a snapshot after every
    chunk of 25: both packages save models at iterations 26 and 51
    (num_iters + 1).  The first, saved mid-solve, predicts the held-out
    forces of the JAX package's within 1e-5 * max|F| (two f64 CG runs of a
    lam = 1e-10 system part by ~1e-8 of the coefficients after 25
    iterations, and the contraction cancels ~1e6: 4e-7 measured)."""
    monkeypatch.setenv("MLFF_CKPT_EVERY_S", "0")
    ds, task, held = _task("calibrated")
    task = dict(task, solver_maxiter=50)
    saved_j, saved_t = [], []
    JaxTrainer().train(task, save_progr_callback=saved_j.append, **TRAIN_KW)
    Trainer(device="cpu").train(task, save_progr_callback=saved_t.append,
                                **TRAIN_KW)
    assert [int(m["solver_iters"]) for m in saved_t] == [26, 51]
    assert [int(m["solver_iters"]) for m in saved_j] == [26, 51]
    m_j, m_t = saved_j[0], saved_t[0]
    assert set(m_t) == set(m_j)
    assert _rel(m_t["alphas_F"], m_j["alphas_F"]) <= 1e-6
    _, F_j = JaxPredictor(m_j).predict(ds["R"][held])
    _, F_t = Predictor(m_t, device="cpu").predict(ds["R"][held])
    assert _rel(F_t, F_j) <= 1e-5


@pytest.mark.parametrize("kind, cap", [("calibrated", 10), ("plain", None)],
                         ids=["capped", "converged"])
def test_resume_warm_start_matches_jax(kind, cap):
    """One JAX model stopped after 10 iterations, resumed by both packages
    through their own create_task_from_model (equal tasks).  ``capped``:
    10 more iterations on the calibrated task, solver_iters 20 in both and
    coefficients within 1e-8 relative (1.1e-10 measured), like the capped
    solves of tests/test_torch_large_molecule.py.  ``converged``: the plain
    task resumed to tol 1e-4, new iterations within +-2 of JAX's and
    coefficients within 1e-6 (1.2e-9 measured)."""
    ds, task, _ = _task(kind)
    m0 = JaxTrainer().train(dict(task, solver_maxiter=10), **TRAIN_KW)
    assert int(m0["solver_iters"]) == 10 and not m0["is_conv"]
    task_j = jtask.create_task_from_model(m0, ds)
    task_t = ttask.create_task_from_model(m0, ds)
    assert set(task_t) == set(task_j)
    for key in task_j:
        np.testing.assert_array_equal(np.asarray(task_t[key]),
                                      np.asarray(task_j[key]), err_msg=key)
    if cap is not None:
        task_j["solver_maxiter"] = task_t["solver_maxiter"] = cap
    r_j = JaxTrainer().train(task_j, **TRAIN_KW)
    r_t = Trainer(device="cpu").train(task_t, **TRAIN_KW)
    new_j, new_t = int(r_j["solver_iters"]) - 10, int(r_t["solver_iters"]) - 10
    if cap is not None:
        assert new_t == new_j == cap
        assert _rel(r_t["alphas_F"], r_j["alphas_F"]) <= 1e-8
    else:
        assert r_t["is_conv"] and r_j["is_conv"]
        assert 0 < new_t and abs(new_t - new_j) <= 2
        assert _rel(r_t["alphas_F"], r_j["alphas_F"]) <= 1e-6
