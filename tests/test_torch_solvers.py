"""The port's solvers against the JAX package's: the split Woodbury apply,
leverage-score column selection and PCG.

Inputs are made with numpy from seeds and handed to both packages.  The
Woodbury apply is f64 products on both sides (~1e-12 relative).  Column
selection draws from the same ``numpy.random.Generator`` stream, so the
inducing indices must be identical.  PCG on the same operator and
preconditioner follows the same recurrence, so the iteration counts are
equal and the residual histories agree to 1e-6 relative.  That comparison
runs at lam = 1e-6: at the production lam = 1e-10 this small system is so
ill-conditioned that f64 rounding alone moves either package's own
trajectory by ~10% within 30 iterations.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mlff_tpu.data.synthetic import make_benchmark_dataset  # noqa: E402
from mlff_tpu.ops import descriptor as jd  # noqa: E402
from mlff_tpu.ops import kernel as jk  # noqa: E402
from mlff_tpu.solvers import cg as jcg  # noqa: E402
from mlff_tpu.solvers import iterative as jit_  # noqa: E402
from mlff_tpu.solvers import preconditioners as jpc  # noqa: E402
from mlff_tpu_torch.ops import descriptor as td  # noqa: E402
from mlff_tpu_torch.ops import kernel as tk  # noqa: E402
from mlff_tpu_torch.solvers import cg as tcg  # noqa: E402
from mlff_tpu_torch.solvers import iterative as tit  # noqa: E402
from mlff_tpu_torch.solvers import preconditioners as tpc  # noqa: E402

SIG, LAM, LAM_PCG = 10.0, 1e-10, 1e-6


def _caches(lam):
    ds, perms = make_benchmark_dataset("ethanol", n_samples=16, seed=11,
                                       n_train=16)
    y = ds["F"].ravel() / np.std(ds["F"])
    spec_j = jd.make_spec(9)
    X, Jc = jd.descriptors_from_R(spec_j, jnp.asarray(ds["R"]))
    cj = jk.build_cache(X, Jc, jd.incidence_matrix(spec_j),
                        jnp.asarray(jd.desc_perms(perms), dtype=jnp.int32),
                        SIG, lam)
    spec_t = td.make_spec(9)
    Xt, Jct = td.descriptors_from_R(spec_t, torch.as_tensor(ds["R"]))
    ct = tk.build_cache(Xt, Jct, td.incidence_matrix(spec_t),
                        td.desc_perms(perms), SIG, lam, device="cpu")
    return spec_j, cj, spec_t, ct, y


@pytest.fixture(scope="module")
def caches():
    return _caches(LAM)


def test_woodbury_split_apply_matches_jax():
    rng = np.random.default_rng(0)
    n, m, lam = 300, 40, 1e-3
    B = rng.normal(size=(n, m))
    W2 = np.triu(rng.normal(size=(m, m)))
    v = rng.normal(size=n)
    want = np.asarray(jpc.woodbury_split_apply(
        jpc.WoodburySplitPreconditioner(B=jnp.asarray(B), W2=jnp.asarray(W2),
                                        lam=jnp.asarray(lam)),
        jnp.asarray(v)))
    P = tpc.WoodburySplitPreconditioner(B=torch.as_tensor(B),
                                        W2=torch.as_tensor(W2), lam=lam,
                                        info={})
    got = P(torch.as_tensor(v)).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("strategy", ["lev_random", "lev_scores",
                                      "inverse_lev", "random_scores"])
def test_column_selection_draws_identical_indices(caches, strategy):
    spec_j, cj, spec_t, ct, _ = caches
    k, n_ind = 2 * spec_t.dim_i, 8
    _, idx_j, _ = jit_.build_preconditioner(
        spec_j, cj, strategy, k, LAM, np.random.default_rng(7),
        n_inducing_pts=n_ind)
    _, idx_t, _ = tit.build_preconditioner(
        spec_t, ct, strategy, k, LAM, np.random.default_rng(7),
        n_inducing_pts=n_ind)
    assert idx_t.shape == (k,)
    np.testing.assert_array_equal(idx_t, idx_j)


def test_leverage_scores_match_jax(caches):
    spec_j, cj, spec_t, ct, _ = caches
    lev_j, order_j = jpc.leverage_scores(spec_j, cj, LAM, 8,
                                         np.random.default_rng(3))
    lev_t, order_t = tpc.leverage_scores(spec_t, ct, LAM, 8,
                                         np.random.default_rng(3))
    # f64 factorizations of the same lam-floored matrices: ~1e-8 relative
    np.testing.assert_allclose(lev_t, lev_j, rtol=1e-6,
                               atol=1e-8 * lev_j.max())
    top = len(order_j) // 10
    assert set(order_t[-top:]) == set(order_j[-top:])


def test_pcg_matches_jax():
    """Same operator (the kernel matvec), same preconditioner (JAX-built
    split Nystrom factors handed to both), same right-hand side; chunks of
    4 iterations, so the driver's host loop runs several times."""
    spec_j, cj, spec_t, ct, y = _caches(LAM_PCG)
    idx = np.sort(np.random.default_rng(5).choice(ct.n, 2 * spec_t.dim_i,
                                                  replace=False))
    Pj = jpc.nystrom_preconditioner(spec_j, cj, idx, LAM_PCG)
    Pt = tpc.WoodburySplitPreconditioner(
        B=torch.as_tensor(np.array(Pj.B)),
        W2=torch.as_tensor(np.array(Pj.W2)), lam=LAM_PCG, info={})
    res_j = jcg.pcg((jk.matvec_psd, cj), jnp.asarray(y), precon=Pj, tol=1e-4,
                    chunk=4)
    res_t = tcg.pcg(lambda v: tk.matvec_psd(ct, v), torch.as_tensor(y),
                    precon=Pt, tol=1e-4, chunk=4)
    assert res_j.converged and res_t.converged
    assert res_t.num_iters == res_j.num_iters > 8
    np.testing.assert_allclose(res_t.resid_hist, res_j.resid_hist, rtol=1e-6)
    assert np.abs(res_t.x - res_j.x).max() <= 1e-6 * np.abs(res_j.x).max()


def test_pcg_stops_before_iterating_when_already_converged():
    b = torch.ones(5, dtype=torch.float64)
    res = tcg.pcg(lambda v: v, b, tol=1e-4, x0=b.clone())
    assert res.converged and res.num_iters == 0


@pytest.mark.parametrize("option, item", [
    ("matvec_dtype", "items 10-11"), ("apply_impl_ozaki", "item 11")])
def test_unported_solver_options_raise(caches, option, item):
    """What the port does not have yet raises and names its ROADMAP item,
    also with a strategy that builds no Nystrom preconditioner."""
    _, _, spec_t, ct, y = caches
    task = {"matvec_dtype": {"matvec_dtype": "ozaki"},
            "apply_impl_ozaki": {"apply_impl": "ozaki"}}[option]
    with pytest.raises(NotImplementedError, match=f"ROADMAP module {item}"):
        tit.solve_iterative(spec_t, ct, task, y, 1.0, break_percentage=0.1,
                            str_preconditioner="cholesky")


def test_energy_constrained_cholesky_solve_matches_jax(caches):
    """The energy-constrained system of the same points (n + N rows, the
    force labels and seeded energy labels), greedy pivoted Cholesky at 10%
    of n + N, 10 iterations at lam = 1e-10: equal pivots and iterations,
    iterates within 1e-6 (two PCG runs of this system part chaotically
    after the first few iterations; tests/test_torch_ecstr.py)."""
    spec_j, cj, spec_t, ct, y = caches
    y_ext = np.concatenate([y, np.random.default_rng(2).normal(size=16)])
    task = {"use_E_cstr": True, "solver_maxiter": 10}
    kw = dict(break_percentage=0.1, str_preconditioner="cholesky")
    res_j = jit_.solve_iterative(spec_j, cj, task, y_ext, 1.0, **kw)
    res_t = tit.solve_iterative(spec_t, ct, task, y_ext, 1.0, **kw)
    np.testing.assert_array_equal(res_t.info["pivots"], res_j.info["pivots"])
    assert res_t.num_iters == res_j.num_iters == 10
    assert res_t.alphas.shape == (ct.n + 16,)
    assert (np.abs(res_t.alphas - res_j.alphas).max()
            <= 1e-6 * np.abs(res_j.alphas).max())
