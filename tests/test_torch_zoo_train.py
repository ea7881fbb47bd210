"""The port's solvers end to end against the JAX package's: every
preconditioner strategy through ``solve_iterative``, restarts, the
preconditioned spectrum, and the ``analytic`` and ``cg_cholesky`` solvers
through ``Trainer.train``.

The strategy comparison runs ``solve_iterative`` of both packages on one
random geometry (numpy, seeded) at lam = 1e-6 and k = 15% of n.  Both draw
from ``numpy.random.default_rng(seed)`` in the same order, so the inducing
indices must be identical, and on this well-conditioned system the PCG
iteration counts agree within +-1.  At the production lam = 1e-10 a small
system is so ill-conditioned that f64 rounding alone moves either package's
own trajectory by several iterations (see ``tests/test_torch_solvers.py``).
k = 31 stays below the rank at which translation ties appear in the greedy
pivot order (``tests/test_torch_zoo.py``).

The trainings use synthetic ethanol with its P = 6 permutations at
N = 14-30; tolerances are stated in each test.
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
from mlff_tpu.solvers import analytic as jan  # noqa: E402
from mlff_tpu.solvers import iterative as jit_  # noqa: E402
from mlff_tpu.utils import io as jio  # noqa: E402
from mlff_tpu_torch.models.gdml import Trainer  # noqa: E402
from mlff_tpu_torch.models.predict import Predictor  # noqa: E402
from mlff_tpu_torch.ops import descriptor as td  # noqa: E402
from mlff_tpu_torch.ops import kernel as tk  # noqa: E402
from mlff_tpu_torch.solvers import analytic as tan  # noqa: E402
from mlff_tpu_torch.solvers import cg as tcg  # noqa: E402
from mlff_tpu_torch.solvers import iterative as tit  # noqa: E402
from mlff_tpu_torch.solvers import preconditioners as tpc  # noqa: E402
from mlff_tpu_torch.utils import io as tio  # noqa: E402

SIG, LAM_WELL = 10.0, 1e-6
N_ATOMS, N_TRAIN, FRACTION = 5, 14, 0.15


@pytest.fixture(scope="module")
def system():
    """(spec_j, cache_j, spec_t, cache_t, y): a random geometry at
    lam = 1e-6 and a seeded right-hand side of unit variance."""
    rng = np.random.default_rng(0)
    R = rng.normal(size=(N_TRAIN, N_ATOMS, 3)) * 1.5
    perms = np.arange(N_ATOMS)[None, :]
    spec_j = jd.make_spec(N_ATOMS)
    X, Jc = jd.descriptors_from_R(spec_j, jnp.asarray(R))
    cj = jk.build_cache(X, Jc, jd.incidence_matrix(spec_j),
                        jnp.asarray(jd.desc_perms(perms)), SIG, LAM_WELL)
    spec_t = td.make_spec(N_ATOMS)
    Xt, Jct = td.descriptors_from_R(spec_t, torch.as_tensor(R))
    ct = tk.build_cache(Xt, Jct, td.incidence_matrix(spec_t),
                        td.desc_perms(perms), SIG, LAM_WELL, device="cpu")
    y = rng.normal(size=ct.n)
    return spec_j, cj, spec_t, ct, y / np.std(y)


@pytest.mark.parametrize("strategy", jit_.ALL_STRATEGIES)
def test_strategy_matches_jax(system, strategy):
    spec_j, cj, spec_t, ct, y = system
    # the *_custom hybrid keeps 20 greedy pivots and draws the rest
    task = {"solver_tol": 1e-4, "solver_maxiter": 400}
    if strategy == "truncated_cholesky_custom":
        task["truncated_cholesky"] = 20
    kw = dict(break_percentage=FRACTION, str_preconditioner=strategy, seed=5)
    res_j = jit_.solve_iterative(spec_j, cj, task, y, 1.0, **kw)
    res_t = tit.solve_iterative(spec_t, ct, task, y, 1.0, **kw)
    assert res_t.inducing_pts_idxs.shape == (int(FRACTION * ct.n),)
    np.testing.assert_array_equal(res_t.inducing_pts_idxs,
                                  res_j.inducing_pts_idxs)
    assert res_t.is_conv == res_j.is_conv
    assert abs(res_t.num_iters - res_j.num_iters) <= 1
    assert res_t.info["num_restarts"] == 0
    if res_j.is_conv:
        # two solves of one system to tol 1e-4
        assert (np.abs(res_t.alphas - res_j.alphas).max()
                <= 1e-3 * np.abs(res_j.alphas).max())


def test_flag_eigvals_spectra_match_jax(system):
    """Eigenvalues of P^-1 (K + lam I) and of K + lam I, 1e-8 of the
    largest; the solve stops at the diagnostic's 10-iteration cap."""
    spec_j, cj, spec_t, ct, y = system
    kw = dict(break_percentage=FRACTION, str_preconditioner="lev_random",
              flag_eigvals=True, seed=5)
    res_j = jit_.solve_iterative(spec_j, cj, {}, y, 1.0, **kw)
    res_t = tit.solve_iterative(spec_t, ct, {}, y, 1.0, **kw)
    for key in ("eigvals", "eigvals_K"):
        got, want = res_t.info[key], res_j.info[key]
        assert got.shape == (ct.n,)
        assert np.abs(got - want).max() <= 1e-8 * np.abs(want).max()
    assert res_t.info["eigvals"].min() > 0.99       # P <= K + lam I
    assert res_t.num_iters == res_j.num_iters == 10
    capped = tit.solve_iterative(spec_t, ct, {"solver_maxiter": 4}, y, 1.0,
                                 **kw)
    assert capped.num_iters == 4


def test_restart_rebuild_preserves_config(system, monkeypatch):
    """A stagnation restart rebuilds the Nystrom preconditioner with the
    task's method, rank_tol and apply_impl, and warm-starts from the last
    iterate (the port's counterpart of
    tests/test_solvers.py::test_restart_rebuild_preserves_config)."""
    _, _, spec_t, ct, y = system
    calls, x0s = [], []
    real_nystrom = tpc.nystrom_preconditioner

    def recording_nystrom(spec_, cache_, idxs, lam, **kw):
        calls.append(dict(kw, m=len(idxs)))
        return real_nystrom(spec_, cache_, idxs, lam, **kw)

    def fake_pcg(matvec, b, precon=None, x0=None, **kw):
        x0s.append(x0)
        stag = len(x0s) == 1
        return tcg.CGResult(
            x=np.full(ct.n, 7.0), converged=not stag,
            num_iters=kw.get("it0", 0) + 5, resid=0.0, resid_hist=np.zeros(5),
            eff=10 if stag else 100, time_s=0.0, stagnated=stag)

    monkeypatch.setattr(tit.pc, "nystrom_preconditioner", recording_nystrom)
    monkeypatch.setattr(tit, "pcg", fake_pcg)
    task = {"nystrom_method": "eigh", "rank_tol": 1e-9, "apply_impl": "xla",
            "n_inducing_pts_init": 2}
    res = tit.solve_iterative(spec_t, ct, task, y, 1.0, break_percentage=None,
                              str_preconditioner="random_scores",
                              allow_restarts=True)
    assert len(x0s) == 2 and res.info["num_restarts"] == 1
    assert x0s[0] is None and float(x0s[1][0]) == 7.0
    first, rebuild = calls[0], calls[-1]
    for key in ("method", "rank_tol", "apply_impl"):
        assert rebuild[key] == first[key] == task[key if key != "method"
                                                  else "nystrom_method"], key
    # 2 inducing points grow by 5 (eff <= 50)
    assert first["m"] == 2 * spec_t.dim_i and rebuild["m"] == 7 * spec_t.dim_i
    assert len(res.inducing_pts_idxs) == 7 * spec_t.dim_i


def test_maxiter_budgets_the_total_over_restarts(system, monkeypatch):
    _, _, spec_t, ct, y = system
    budgets = []

    def fake_pcg(matvec, b, precon=None, x0=None, maxiter=None, it0=0, **kw):
        budgets.append(maxiter)
        return tcg.CGResult(
            x=np.zeros(ct.n), converged=False, num_iters=it0 + 6, resid=1.0,
            resid_hist=np.zeros(6), eff=0, time_s=0.0, stagnated=True)

    monkeypatch.setattr(tit, "pcg", fake_pcg)
    res = tit.solve_iterative(
        spec_t, ct, {"solver_maxiter": 15, "n_inducing_pts_init": 1}, y, 1.0,
        break_percentage=None, allow_restarts=True)
    assert budgets == [15, 9, 3] and res.num_iters == 18
    assert res.info["num_restarts"] == 2


# -- trainings -----------------------------------------------------------------


def _plain_task(n_train, **kw):
    ds = make_dataset("ethanol", n_samples=n_train + 10, seed=3)
    ds["z"] = np.asarray([6, 6, 8, 1, 1, 1, 1, 1, 1])
    task = create_task(ds, n_train, ds, n_valid=5, sig=SIG,
                       perms=benchmark_perms("ethanol"), **kw)
    held = np.setdiff1d(np.arange(n_train + 10), task["idxs_train"])
    return ds, task, held


def test_restarts_match_jax():
    """Calibrated ethanol from one inducing point: the solve stagnates and
    restarts with a grown inducing set.  Equal restart counts and final
    inducing sets; both converge."""
    ds, perms = make_benchmark_dataset("ethanol", n_samples=40, seed=11,
                                       n_train=30)
    task = create_task(ds, 30, ds, n_valid=5, sig=SIG, solver="cg",
                       perms=perms)
    task["n_inducing_pts_init"] = 1
    kw = dict(break_percentage=None, str_preconditioner="lev_random",
              allow_restarts=True)
    m_jax = JaxTrainer().train(task, **kw)
    m_port = Trainer(device="cpu").train(task, **kw)
    assert m_port["num_restarts"] == m_jax["num_restarts"] >= 1
    np.testing.assert_array_equal(m_port["inducing_pts_idxs"],
                                  m_jax["inducing_pts_idxs"])
    assert len(m_port["inducing_pts_idxs"]) > 27
    assert m_port["is_conv"] and m_jax["is_conv"]


@pytest.fixture(scope="module")
def analytic_pair():
    ds, task, held = _plain_task(14, solver="analytic")
    m_jax, K_jax, a_jax = JaxTrainer(return_K=True).train(task)
    m_port, K_port, a_port = Trainer(device="cpu", return_K=True).train(task)
    return ds, task, held, (m_jax, K_jax, a_jax), (m_port, K_port, a_port)


def test_analytic_alphas_match_jax(analytic_pair):
    """Cholesky solves of one matrix with cond ~ 1e12 in two LAPACKs: the
    coefficients agree to 1e-8 relative, the kernel to 1e-12."""
    _, task, _, (m_jax, K_jax, a_jax), (m_port, K_port, a_port) = analytic_pair
    assert np.abs(K_port - np.asarray(K_jax)).max() <= 1e-12 * np.abs(K_jax).max()
    assert np.abs(a_port - a_jax).max() <= 1e-8 * np.abs(a_jax).max()
    assert (np.abs(m_port["alphas_F"] - m_jax["alphas_F"]).max()
            <= 1e-8 * np.abs(m_jax["alphas_F"]).max())
    assert set(m_port) == set(m_jax)
    assert m_port["solver_name"] == "analytic"
    assert m_port["lam"] == task["lam"] and "solver_iters" not in m_port
    assert "inducing_pts_idxs" not in m_port


def test_analytic_model_is_npz_interchangeable(analytic_pair, tmp_path):
    ds, _, held, (m_jax, _, _), (m_port, _, _) = analytic_pair
    tio.save_model(tmp_path / "port.npz", m_port)
    jio.save_model(tmp_path / "jax.npz", m_jax)
    E_a, F_a = JaxPredictor(jio.load_model(tmp_path / "port.npz")).predict(
        ds["R"][held])
    E_b, F_b = Predictor(tio.load_model(tmp_path / "jax.npz"),
                         device="cpu").predict(ds["R"][held])
    E_j, F_j = JaxPredictor(m_jax).predict(ds["R"][held])
    # alphas equal to 1e-8, forces a sum over them
    for F in (F_a, F_b):
        assert np.abs(F - F_j).max() <= 1e-6 * np.abs(F_j).max()
    assert m_port["use_E"] == m_jax["use_E"]


@pytest.mark.parametrize("A, y, want", [
    ([[1.0, 2.0], [2.0, 1.0]], [1.0, 0.0], [-1 / 3, 2 / 3]),   # indefinite
    ([[1.0, 1.0], [1.0, 1.0]], [2.0, 2.0], [1.0, 1.0]),        # singular
], ids=["lu", "lstsq"])
def test_analytic_fallback_chain(monkeypatch, A, y, want):
    """Cholesky -> LU -> least squares on matrices the first stages refuse:
    an indefinite system goes to LU, a singular one to least squares (its
    minimum-norm solution)."""
    import types

    monkeypatch.setattr(tan.knl, "assemble_full",
                        lambda spec, cache: torch.as_tensor(A, dtype=torch.float64))
    cache = types.SimpleNamespace(device=torch.device("cpu"))
    got = tan.solve_analytic(None, cache, np.asarray(y), reg=0.0)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_cprsn_least_squares_path_matches_jax():
    """``cprsn_keep_atoms_idxs``: only the kept atoms' partials form columns
    and the (n, m) system is solved by least squares.  Its singular values
    span ~1e8, so two SVD solvers agree to 1e-6 relative."""
    ds, task, held = _plain_task(14, solver="analytic", use_sym=False,
                                 use_cprsn=True)
    keep = np.array([0, 1, 2, 3, 6])
    task["cprsn_keep_atoms_idxs"] = keep
    m_jax, K_jax, a_jax = JaxTrainer(return_K=True).train(task)
    m_port, K_port, a_port = Trainer(device="cpu", return_K=True).train(task)
    assert K_port.shape == np.asarray(K_jax).shape == (14 * 27, 14 * 15)
    assert np.abs(K_port - np.asarray(K_jax)).max() <= 1e-12 * np.abs(K_jax).max()
    assert a_port.shape == (14 * 15,)
    assert np.abs(a_port - a_jax).max() <= 1e-6 * np.abs(a_jax).max()
    assert (np.abs(m_port["R_d_desc_alpha"] - m_jax["R_d_desc_alpha"]).max()
            <= 1e-6 * np.abs(m_jax["R_d_desc_alpha"]).max())
    _, F_j = JaxPredictor(m_jax).predict(ds["R"][held])
    _, F_t = Predictor(m_port, device="cpu").predict(ds["R"][held])
    assert np.abs(F_t - F_j).max() <= 1e-6 * np.abs(F_j).max()


@pytest.fixture(scope="module")
def cg_cholesky_pair():
    ds, task, held = _plain_task(14, solver="cg_cholesky")
    m_jax = JaxTrainer().train(task, break_percentage=0.3)
    m_port = Trainer(device="cpu").train(task, break_percentage=0.3)
    return ds, task, held, m_jax, m_port


def test_cg_cholesky_matches_jax(cg_cholesky_pair):
    """Held-out forces within 1e-4 * max|F|, the solve's tolerance."""
    ds, task, held, m_jax, m_port = cg_cholesky_pair
    assert m_port["is_conv"] and m_port["solver_name"] == "cg_cholesky"
    assert abs(int(m_port["solver_iters"]) - int(m_jax["solver_iters"])) <= 1
    assert m_port["lam"] == m_jax["lam"] == 1e-10
    _, F_j = JaxPredictor(m_jax).predict(ds["R"][held])
    _, F_t = Predictor(m_port, device="cpu").predict(ds["R"][held])
    assert np.abs(F_t - F_j).max() <= 1e-4 * np.abs(F_j).max()
    # inducing_pts_idxs is the cg solver's alone; min_pivot is the port's
    # own addition to the factorization's record
    assert "inducing_pts_idxs" not in m_port
    assert set(m_port) - set(m_jax) == {"min_pivot"}
    assert set(m_jax) <= set(m_port)
    np.testing.assert_allclose(m_port["remaining_diag_error"],
                               m_jax["remaining_diag_error"], rtol=1e-6)


def test_cg_cholesky_model_file_loads_in_jax(cg_cholesky_pair, tmp_path):
    ds, _, held, _, m_port = cg_cholesky_pair
    tio.save_model(tmp_path / "port.npz", m_port)
    _, F_j = JaxPredictor(jio.load_model(tmp_path / "port.npz")).predict(
        ds["R"][held])
    _, F_t = Predictor(m_port, device="cpu").predict(ds["R"][held])
    assert np.abs(F_t - F_j).max() <= 1e-8 * np.abs(F_j).max()


def test_cg_cholesky_raises_when_not_converged(monkeypatch):
    from mlff_tpu_torch.models import gdml

    _, task, _ = _plain_task(14, solver="cg_cholesky")
    monkeypatch.setattr(gdml, "pcg", lambda *a, **kw: tcg.CGResult(
        x=np.zeros(14 * 27), converged=False, num_iters=3, resid=1.0,
        resid_hist=np.zeros(3)))
    with pytest.raises(RuntimeError, match="did not converge"):
        Trainer(device="cpu").train(task, break_percentage=0.1)


@pytest.mark.parametrize("strategy", ["cholesky", "eigvec_precon"])
def test_cg_matches_analytic(analytic_pair, strategy):
    """The tolerance of tests/test_train_e2e.py::test_cg_matches_analytic;
    the eigenvector strategy shares one SVD between two trainings."""
    ds, task, _, _, (m_an, _, _) = analytic_pair
    svd_cache: dict = {}
    tr = Trainer(device="cpu")
    for fraction in (0.25, 0.3):
        model = tr.train(dict(task, solver_name="cg"),
                         break_percentage=fraction,
                         str_preconditioner=strategy, svd_cache=svd_cache)
        assert model["is_conv"] and model["solver_iters"] > 0
    assert len(svd_cache) == (1 if strategy == "eigvec_precon" else 0)
    R = np.asarray(task["R_train"])[:10]
    _, F_cg = Predictor(model, device="cpu").predict(R)
    _, F_an = Predictor(m_an, device="cpu").predict(R)
    np.testing.assert_allclose(F_cg, F_an, atol=5e-3 * np.abs(F_an).max())


def test_unknown_solver_raises():
    _, task, _ = _plain_task(14)
    with pytest.raises(ValueError, match="unknown solver"):
        Trainer(device="cpu").train(dict(task, solver_name="lu"))
    # energy constraints train with every solver but cg_cholesky, which the
    # JAX package runs without them and the port refuses
    with pytest.raises(ValueError, match="cg_cholesky"):
        Trainer(device="cpu").train(dict(task, solver_name="cg_cholesky",
                                         use_E_cstr=True))
    assert tan.ANALYTIC_REG == jan.ANALYTIC_REG
