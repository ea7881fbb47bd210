"""End to end: a small lev_random CG training in both packages.

Two tasks of N = 30 ethanol geometries with the real P = 6 permutation
group: ``plain`` (``make_dataset``, a well-conditioned kernel that takes
~15 PCG iterations) and ``calibrated`` (``make_benchmark_dataset``, the
benchmark's hard kernel, ~150 iterations).  The port must draw the same
inducing columns and converge in the same number of iterations (+-2).
Held-out forces agree within 1e-4 * max|F|, the solve's own tolerance; on
the plain task energies do too.  On the calibrated task the two f64 solves
land on different points of the same 1e-4 residual ball along directions
the residual hardly sees, and the energies (a sum over all coefficients)
differ by ~3e-4 * max|F|, so only the forces are held to the tolerance
there.

Model files are interchangeable: a model either package writes predicts
the same in the other.  The tolerance, 1e-8 relative, is f64 summation
order: the prediction contraction's terms cancel by ~1e6 on these models
(max_b sum_m a_bm |w~_m| over max |F_desc|), which leaves ~1e-9.
Energies are held to it on the scale of the contraction's own output,
before the integration constant c is added: on the plain model c cancels
all but ~5e-5 of that output.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mlff_tpu.data.synthetic import (  # noqa: E402
    benchmark_perms, make_benchmark_dataset, make_dataset)
from mlff_tpu.models.gdml import Trainer as JaxTrainer  # noqa: E402
from mlff_tpu.models.predict import Predictor as JaxPredictor  # noqa: E402
from mlff_tpu.models.task import create_task  # noqa: E402
from mlff_tpu.ops import descriptor as jd  # noqa: E402
from mlff_tpu.ops import kernel as jk  # noqa: E402
from mlff_tpu.ops.pallas_predict import desc_forces_pallas  # noqa: E402
from mlff_tpu.utils import io as jio  # noqa: E402
from mlff_tpu_torch.convert import model_from_numpy  # noqa: E402
from mlff_tpu_torch.models.gdml import Trainer  # noqa: E402
from mlff_tpu_torch.models.predict import Predictor  # noqa: E402
from mlff_tpu_torch.ops.fused_predict import desc_forces_fused_ref  # noqa: E402
from mlff_tpu_torch.utils import io as tio  # noqa: E402

N_TRAIN, N_SAMPLES, N_COLUMNS, SIG = 30, 40, 200, 10.0
SOLVE_TOL = 1e-4
F64_RTOL = 1e-8


def _dataset(kind):
    if kind == "calibrated":
        return make_benchmark_dataset("ethanol", n_samples=N_SAMPLES, seed=11,
                                      n_train=N_TRAIN)
    ds = make_dataset("ethanol", n_samples=N_SAMPLES, seed=3)
    ds["z"] = np.asarray([6, 6, 8, 1, 1, 1, 1, 1, 1])
    return ds, benchmark_perms("ethanol")


def _assert_f64_close(E, F, E_want, F_want, c):
    assert np.abs(F - F_want).max() <= F64_RTOL * np.abs(F_want).max()
    assert np.abs(E - E_want).max() <= F64_RTOL * np.abs(E_want - c).max()


@pytest.fixture(scope="module", params=["plain", "calibrated"])
def trained(request):
    ds, perms = _dataset(request.param)
    task = create_task(ds, N_TRAIN, ds, n_valid=5, sig=SIG, solver="cg",
                       perms=perms)
    kw = dict(n_columns=N_COLUMNS, str_preconditioner="lev_random")
    m_jax = JaxTrainer().train(task, **kw)
    m_port = Trainer(device="cpu").train(task, **kw)
    held = np.setdiff1d(np.arange(N_SAMPLES), task["idxs_train"])
    return request.param, ds, held, m_jax, m_port


def test_training_draws_same_columns_and_iterations(trained):
    _, _, _, m_jax, m_port = trained
    assert m_jax["is_conv"] and m_port["is_conv"]
    np.testing.assert_array_equal(m_port["inducing_pts_idxs"],
                                  m_jax["inducing_pts_idxs"])
    assert abs(int(m_port["solver_iters"]) - int(m_jax["solver_iters"])) <= 2


def test_held_out_predictions_agree(trained):
    kind, ds, held, m_jax, m_port = trained
    E_j, F_j = JaxPredictor(m_jax).predict(ds["R"][held])
    E_t, F_t = Predictor(m_port, device="cpu").predict(ds["R"][held])
    scale = np.abs(F_j).max()
    assert F_t.shape == F_j.shape == (len(held), 9, 3)
    assert np.abs(F_t - F_j).max() <= SOLVE_TOL * scale
    assert m_port["use_E"] == m_jax["use_E"]
    if kind == "plain":
        assert m_port["use_E"]
        assert np.abs(E_t - E_j).max() <= SOLVE_TOL * scale


def test_model_dicts_have_same_keys(trained):
    _, _, _, m_jax, m_port = trained
    assert set(m_port) == set(m_jax)
    for key in ("R_desc", "R_d_desc_alpha", "alphas_F", "perms",
                "tril_perms_lin"):
        assert np.shape(m_port[key]) == np.shape(m_jax[key]), key


def test_port_model_file_loads_in_jax_predictor(trained, tmp_path):
    _, ds, held, _, m_port = trained
    path = tmp_path / "port_model.npz"
    tio.save_model(path, m_port)
    E_j, F_j = JaxPredictor(jio.load_model(path)).predict(ds["R"][held])
    E_t, F_t = Predictor(m_port, device="cpu").predict(ds["R"][held])
    _assert_f64_close(E_t, F_t, E_j, F_j, m_port["c"])


@pytest.mark.parametrize("form", ["npz", "dict"])
def test_jax_model_reproduced_by_port_predictor(trained, tmp_path, form):
    """convert.model_from_numpy on a JAX-written model: the port predicts
    what the JAX package predicts."""
    _, ds, held, m_jax, _ = trained
    if form == "npz":
        src = tmp_path / "jax_model.npz"
        jio.save_model(src, m_jax)
    else:
        src = {k: (np.asarray(v) if isinstance(v, jnp.ndarray) else v)
               for k, v in m_jax.items()}
    model = model_from_numpy(src)
    E_j, F_j = JaxPredictor(m_jax).predict(ds["R"][held])
    E_t, F_t = Predictor(model, device="cpu").predict(ds["R"][held])
    _assert_f64_close(E_t, F_t, E_j, F_j, m_jax["c"])


def test_fast_predictor_on_cpu_matches_f64_predictor(trained):
    _, ds, held, _, m_port = trained
    E_f, F_f = Predictor(m_port, fast=True, device="cpu").predict(
        ds["R"][held])
    E_x, F_x = Predictor(m_port, device="cpu").predict(ds["R"][held])
    _assert_f64_close(E_f, F_f, E_x, F_x, m_port["c"])


@pytest.mark.parametrize("trained", ["calibrated"], indirect=True)
def test_f32_contraction_misses_a_trained_model(trained):
    """Why the port's fused contraction is f64: on a trained model the JAX
    package's f32 Pallas kernel misses its own f64 contraction by more than
    its tolerance (atol 2e-5 * max|F|), while the port's f64 version stays
    within the f64 tolerance."""
    _, ds, held, m_jax, _ = trained
    p = JaxPredictor(m_jax)
    X, _ = jd.descriptors_from_R(p.spec, jnp.asarray(ds["R"][held]))
    Xq = (jk.SQRT5 / SIG) * X
    dist = jk.pairwise_dist_gram(Xq, p.Xqt)
    A_exp = (5.0 / (3.0 * SIG**2)) * jnp.exp(-dist)
    F64, _ = jk._desc_forces_x(p.Xqt, SIG, Xq, A_exp, A_exp * (1 + dist),
                               p.wt)
    F64 = np.asarray(F64)
    scale = np.abs(F64).max()
    F32, _ = desc_forces_pallas(Xq, p.Xqt, p.wt, sig=SIG, interpret=True)
    assert np.abs(np.asarray(F32) - F64).max() > 2e-5 * scale
    F_port, _ = desc_forces_fused_ref(
        *(torch.as_tensor(np.array(a)) for a in (Xq, p.Xqt, p.wt)), SIG)
    assert np.abs(F_port.numpy() - F64).max() <= F64_RTOL * scale
