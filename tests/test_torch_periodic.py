"""Periodic systems and the interaction cutoff in the port against the JAX
package: ``lattice`` and ``interact_cut_off`` in ``Trainer`` and the lattice
in ``Predictor``.

The dataset goes through the port's extended-XYZ writer and reader
(``Lattice=``), so the reader is on the path: 24 synthetic ethanol
geometries in a 5.0 x 5.5 x 6.0 Angstrom cell, small enough that minimum
images wrap some atom pairs.  Both packages train it with the ``analytic``
solver, a closed form, so the tolerances are tight: 1e-8 relative on the
predicted forces (5.5e-10 measured) and 1e-7 on the coefficients, which
are ~5e7 against labels of unit spread: the Cholesky solves of one matrix
of cond ~1e12 in two LAPACKs part by 2.5e-8 to 4.8e-8 of them along
directions the kernel hardly sees, which move the forces by less than
1e-9.

Also here: ``solve_analytic`` adds the ridge to the diagonal of one copy of
K instead of forming K + reg * I with a dense identity; the coefficients
keep their bits.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mlff_tpu.data.synthetic import make_dataset  # noqa: E402
from mlff_tpu.data import xyz as jxyz  # noqa: E402
from mlff_tpu.models.gdml import Trainer as JaxTrainer  # noqa: E402
from mlff_tpu.models.predict import Predictor as JaxPredictor  # noqa: E402
from mlff_tpu.models.task import create_task  # noqa: E402
from mlff_tpu_torch.data import xyz  # noqa: E402
from mlff_tpu_torch.models.gdml import Trainer  # noqa: E402
from mlff_tpu_torch.models.predict import Predictor  # noqa: E402
from mlff_tpu_torch.ops import kernel as tk  # noqa: E402
from mlff_tpu_torch.solvers import analytic as tan  # noqa: E402
from .torch_threads import one_torch_thread  # noqa: E402,F401

N_TRAIN, N_SAMPLES, SIG = 20, 24, 10.0
LATTICE = np.array([[5.0, 0.0, 0.0], [0.0, 5.5, 0.0], [0.3, 0.0, 6.0]])
RTOL_F, RTOL_ALPHAS = 1e-8, 1e-7


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def periodic_ds(tmp_path_factory):
    """Synthetic ethanol written with a lattice and read back by the port's
    extended-XYZ reader; the JAX reader gives the same arrays."""
    ds = make_dataset("ethanol", n_samples=N_SAMPLES, seed=3)
    path = tmp_path_factory.mktemp("periodic") / "ethanol_cell.xyz"
    xyz.dataset_to_extxyz(dict(ds, lattice=LATTICE), path)
    back = xyz.dataset_from_extxyz(path, name="ethanol_cell")
    ref = jxyz.dataset_from_extxyz(path, name="ethanol_cell")
    for key in ("R", "F", "E", "z", "lattice"):
        np.testing.assert_array_equal(back[key], ref[key])
    np.testing.assert_allclose(back["lattice"], LATTICE, rtol=1e-12)
    return back


@pytest.fixture(scope="module", params=[None, 3.0], ids=["lattice", "cutoff"])
def trained(request, periodic_ds):
    task = create_task(periodic_ds, N_TRAIN, periodic_ds, n_valid=2,
                       sig=SIG, use_sym=False, solver="analytic",
                       interact_cut_off=request.param)
    m_jax = JaxTrainer().train(task)
    m_port = Trainer(device="cpu").train(task)
    held = np.setdiff1d(np.arange(N_SAMPLES), task["idxs_train"])
    return task, held, m_jax, m_port


def test_minimum_images_change_the_descriptor(periodic_ds):
    """The cell is small enough to matter: the periodic descriptors differ
    from the free-space ones."""
    task = create_task(periodic_ds, N_TRAIN, periodic_ds, n_valid=2,
                       sig=SIG, use_sym=False, solver="analytic")
    tr = Trainer(device="cpu")
    _, _, X_cell, _, _ = tr.build_kernel_inputs(task)
    free = {k: v for k, v in task.items() if k != "lattice"}
    _, _, X_free, _, _ = tr.build_kernel_inputs(free)
    assert not torch.allclose(X_cell, X_free)


def test_periodic_analytic_training_matches_jax(trained):
    task, _, m_jax, m_port = trained
    np.testing.assert_array_equal(m_port["lattice"], task["lattice"])
    assert m_port["interact_cut_off"] == task["interact_cut_off"]
    assert set(m_port) == set(m_jax)
    assert _rel(m_port["R_desc"], m_jax["R_desc"]) <= 1e-12
    assert _rel(m_port["alphas_F"], m_jax["alphas_F"]) <= RTOL_ALPHAS
    assert m_port["use_E"] == m_jax["use_E"]


def test_periodic_predictor_matches_jax(trained, periodic_ds):
    """Held-out geometries through both Predictors, each with the model's
    lattice; and the port's Predictor on the JAX model, so that the lattice
    path alone is compared."""
    _, held, m_jax, m_port = trained
    R = periodic_ds["R"][held]
    E_j, F_j = JaxPredictor(m_jax).predict(R)
    E_t, F_t = Predictor(m_port, device="cpu").predict(R)
    assert F_t.shape == (len(held), 9, 3) and np.all(np.isfinite(F_t))
    assert _rel(F_t, F_j) <= RTOL_F
    pred = Predictor(m_jax, device="cpu")
    assert pred.lat_and_inv is not None
    E_x, F_x = pred.predict(R)
    assert _rel(F_x, F_j) <= 1e-10
    assert np.abs(E_x - E_j).max() <= 1e-10 * np.abs(E_j - m_jax["c"]).max()


@pytest.mark.parametrize("return_K", [False, True])
def test_ridge_on_the_diagonal_keeps_the_alphas(periodic_ds, return_K):
    """solve_analytic's coefficients equal, bit for bit, those of the
    Cholesky solve of K + reg * I formed with a dense identity (adding 0.0
    off the diagonal changes no bit); with return_K the returned K carries
    no ridge."""
    task = create_task(periodic_ds, N_TRAIN, periodic_ds, n_valid=2,
                       sig=SIG, use_sym=False, solver="analytic")
    tr = Trainer(device="cpu")
    spec, S, X, Jc, P_idx = tr.build_kernel_inputs(task)
    y, _, _ = tr.labels(task)
    cache = tk.build_cache(X, Jc, S, P_idx, SIG, 1e-15, device="cpu")
    K = tk.assemble_full(spec, cache)
    A = K + tan.ANALYTIC_REG * torch.eye(K.shape[0], dtype=K.dtype)
    L, info = torch.linalg.cholesky_ex(A)
    assert int(info) == 0
    want = torch.cholesky_solve(torch.as_tensor(y)[:, None], L)[:, 0].numpy()
    out = tan.solve_analytic(spec, cache, y, return_K=return_K)
    got = out[0] if return_K else out
    np.testing.assert_array_equal(got, want)
    if return_K:
        np.testing.assert_array_equal(out[1], K.numpy())
