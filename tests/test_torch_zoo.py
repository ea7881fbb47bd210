"""The preconditioner zoo of the port against the JAX package's: dense
kernel pieces, the three pivoted-Cholesky factorizations and the
preconditioners built from them.

Inputs are random geometries made with numpy from a seed (as
``tests/test_solvers.py`` makes them) and handed to both packages; the CPU
runs the port.  Tolerances, each relative to the largest reference entry:
the kernel pieces 1e-12 (the same f64 sums in another order), the factors
1e-10, a preconditioner's ``P^-1 v`` 1e-9 (two f64 factorizations of the
same lam-floored matrices).

Pivot ties.  The kernel is invariant under translations, so the force
partials of one geometry along one axis sum to zero.  Once all but two
atoms of a point are pivots along an axis, the two remaining residual
columns are each other's negatives and their residual diagonals are equal
up to rounding: either is the next pivot, both give the same ``L L^T``, and
the pivot after them is the same again.  Tests that demand equal pivots
stop at a rank before the first such tie (80 on this geometry); a deeper
factorization is compared through ``L L^T`` and the pivot values.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mlff_tpu.ops import descriptor as jd  # noqa: E402
from mlff_tpu.ops import kernel as jk  # noqa: E402
from mlff_tpu.solvers import iterative as jit_  # noqa: E402
from mlff_tpu.solvers import pivoted_cholesky as jch  # noqa: E402
from mlff_tpu.solvers import preconditioners as jpc  # noqa: E402
from mlff_tpu_torch import convert  # noqa: E402
from mlff_tpu_torch.ops import descriptor as td  # noqa: E402
from mlff_tpu_torch.ops import kernel as tk  # noqa: E402
from mlff_tpu_torch.solvers import iterative as tit  # noqa: E402
from mlff_tpu_torch.solvers import pivoted_cholesky as tch  # noqa: E402
from mlff_tpu_torch.solvers import preconditioners as tpc  # noqa: E402

SIG, LAM = 10.0, 1e-10
N_ATOMS, N_TRAIN = 5, 14
RANK = 40            # before the first translation tie of this geometry
KERNEL_RTOL, FACTOR_RTOL, APPLY_RTOL = 1e-12, 1e-10, 1e-9


def _setup(perms=None, n_atoms=N_ATOMS, n_train=N_TRAIN, seed=0, lam=LAM):
    rng = np.random.default_rng(seed)
    R = rng.normal(size=(n_train, n_atoms, 3)) * 1.5
    perms = np.arange(n_atoms)[None, :] if perms is None else np.asarray(perms)
    spec_j = jd.make_spec(n_atoms)
    X, Jc = jd.descriptors_from_R(spec_j, jnp.asarray(R))
    cj = jk.build_cache(X, Jc, jd.incidence_matrix(spec_j),
                        jnp.asarray(jd.desc_perms(perms)), SIG, lam)
    spec_t = td.make_spec(n_atoms)
    Xt, Jct = td.descriptors_from_R(spec_t, torch.as_tensor(R))
    ct = tk.build_cache(Xt, Jct, td.incidence_matrix(spec_t),
                        td.desc_perms(perms), SIG, lam, device="cpu")
    return spec_j, cj, spec_t, ct


@pytest.fixture(scope="module")
def setup():
    return _setup()


@pytest.fixture(scope="module")
def setup_perms():
    """Two permutations, so the permutation axis of every einsum is live."""
    return _setup(perms=[[0, 1, 2, 3, 4], [1, 0, 2, 3, 4]], seed=1)


def _rel(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _vec(n, seed=4):
    return np.random.default_rng(seed).normal(size=n)


# -- kernel pieces -----------------------------------------------------------


def test_assemble_full_matches_jax(setup_perms):
    spec_j, cj, spec_t, ct = setup_perms
    want = jk.assemble_full(spec_j, cj)
    # a tile that does not divide N: the last row tile is ragged
    got = tk.assemble_full(spec_t, ct, tile=4)
    assert got.shape == (ct.n, ct.n)
    assert _rel(got, want) <= KERNEL_RTOL
    ridge = tk.assemble_full(spec_t, ct, add_ridge=0.5)
    assert _rel(ridge - got, 0.5 * np.eye(ct.n)) <= KERNEL_RTOL


def test_assemble_block_rectangular_matches_jax(setup_perms):
    spec_j, cj, spec_t, ct = setup_perms
    I, J = [3, 0, 7], [5, 2]
    want = jk.assemble_block(spec_j.dim_i, cj, jnp.asarray(I), jnp.asarray(J))
    got = tk.assemble_block(spec_t.dim_i, ct, torch.as_tensor(I),
                            torch.as_tensor(J))
    assert got.shape == (3 * spec_t.dim_i, 2 * spec_t.dim_i)
    assert _rel(got, want) <= KERNEL_RTOL


def test_kernel_diag_matches_jax(setup_perms):
    spec_j, cj, spec_t, ct = setup_perms
    want = jk.kernel_diag(spec_j.dim_i, cj)
    got = tk.kernel_diag_any(spec_t, ct)
    assert got.shape == (ct.n,)
    assert _rel(got, want) <= KERNEL_RTOL
    full = tk.assemble_full(spec_t, ct)
    assert _rel(got, torch.diagonal(full).numpy()) <= KERNEL_RTOL


@pytest.mark.parametrize("col", [0, 17, 104, N_TRAIN * 3 * N_ATOMS - 1])
def test_kernel_column_matches_jax(setup_perms, col):
    spec_j, cj, spec_t, ct = setup_perms
    want = jk.kernel_column(spec_j.dim_i, cj, jnp.asarray(col))
    for form in (col, torch.tensor([col])):
        got = tk.kernel_column(spec_t.dim_i, ct, form)
        assert got.shape == (ct.n,)
        assert _rel(got, want) <= KERNEL_RTOL
    j = torch.tensor([col // spec_t.dim_i])
    block = tk._point_block_cols(spec_t.dim_i, ct, j)
    assert block.shape == (ct.n, spec_t.dim_i)
    want_no_ridge = np.asarray(want).copy()
    want_no_ridge[col] -= LAM
    assert _rel(block[:, col % spec_t.dim_i], want_no_ridge) <= KERNEL_RTOL


@pytest.mark.parametrize("dim,dim_i,route", [
    (14365, 510, "kernel_diag_compressed"), (36, 27, "kernel_diag")],
    ids=["large_D", "small_D"])
def test_large_D_diagonal_routes_to_the_compressed_path(monkeypatch, dim,
                                                        dim_i, route):
    """Above the inflation budget (A = 170, D = 14,365) kernel_diag_any
    takes the compressed diagonal, below it the inflating one, by the JAX
    package's rule (the diagonals themselves: tests/test_torch_large_molecule.py)."""
    spec = types.SimpleNamespace(dim=dim, dim_i=dim_i)
    cache = types.SimpleNamespace(n_perms=1)
    assert tk._is_large_D(spec, cache.n_perms) == (
        dim * dim_i * 8 * 4 > jk._INFLATION_BUDGET)
    called = []
    for name in ("kernel_diag_compressed", "kernel_diag"):
        monkeypatch.setattr(tk, name,
                            lambda T, c, name=name: called.append(name))
    tk.kernel_diag_any(spec, cache)
    assert called == [route]


# -- the three factorizations --------------------------------------------------


def _same_factor(res_t, info_t, res_j, info_j):
    np.testing.assert_array_equal(res_t.pivots.numpy(), np.asarray(res_j.pivots))
    np.testing.assert_array_equal(info_t["pivots"], np.asarray(info_j["pivots"]))
    np.testing.assert_array_equal(info_t["index_columns"],
                                  info_j["index_columns"])
    assert info_t["L.shape"] == tuple(res_t.L.shape) == tuple(res_j.L.shape)
    Lj = np.asarray(res_j.L)
    assert _rel(res_t.L @ res_t.L.T, Lj @ Lj.T) <= FACTOR_RTOL
    assert _rel(res_t.pivot_values, res_j.pivot_values) <= FACTOR_RTOL
    assert _rel(res_t.remaining_diag, res_j.remaining_diag) <= FACTOR_RTOL
    np.testing.assert_allclose(info_t["remaining_diag_error"],
                               info_j["remaining_diag_error"], rtol=1e-8)
    assert info_t["min_pivot"] == float(res_t.pivot_values.min()) > 0


@pytest.mark.parametrize("which", ["no_perms", "perms"])
def test_pivoted_cholesky_matches_jax(setup, setup_perms, which):
    spec_j, cj, spec_t, ct = setup if which == "no_perms" else setup_perms
    res_j, info_j = jch.pivoted_cholesky(spec_j, cj, RANK)
    res_t, info_t = tch.pivoted_cholesky(spec_t, ct, RANK)
    _same_factor(res_t, info_t, res_j, info_j)
    assert _rel(res_t.L, res_j.L) <= FACTOR_RTOL
    # a factor of K + lam I: the residual diagonal is what L L^T leaves
    K = tk.assemble_full(spec_t, ct)
    resid = torch.diagonal(K - res_t.L @ res_t.L.T)
    assert _rel(res_t.remaining_diag, resid.numpy()) <= 1e-9


def test_pivoted_cholesky_past_translation_ties(setup):
    """Rank 40% of n, past the first tie (see the module docstring): the
    pivot values and L L^T agree; the pivots may differ where two residual
    diagonals are equal up to rounding."""
    spec_j, cj, spec_t, ct = setup
    k = int(0.4 * ct.n)
    res_j, _ = jch.pivoted_cholesky(spec_j, cj, k)
    res_t, info_t = tch.pivoted_cholesky(spec_t, ct, k)
    Lj = np.asarray(res_j.L)
    assert _rel(res_t.L @ res_t.L.T, Lj @ Lj.T) <= FACTOR_RTOL
    np.testing.assert_allclose(res_t.pivot_values.numpy(),
                               np.asarray(res_j.pivot_values), rtol=1e-6)
    assert len(set(info_t["pivots"].tolist())) == k
    assert sorted(info_t["index_columns"].tolist()) == list(range(ct.n))


def test_pivoted_cholesky_takes_a_seed_diagonal_and_rank_zero(setup):
    spec_j, cj, spec_t, ct = setup
    diag = np.array(jk.kernel_diag(spec_j.dim_i, cj))
    res_t, _ = tch.pivoted_cholesky(spec_t, ct, 5, diag=diag)
    res_j, _ = jch.pivoted_cholesky(spec_j, cj, 5)
    np.testing.assert_array_equal(res_t.pivots.numpy(), np.asarray(res_j.pivots))
    empty, info = tch.pivoted_cholesky(spec_t, ct, 0)
    assert empty.L.shape == (ct.n, 0) and info["min_pivot"] == float("inf")


def test_pivoted_cholesky_rejects_a_non_psd_diagonal(setup):
    _, _, spec_t, ct = setup
    with pytest.raises(ValueError, match="not PSD"):
        tch.pivoted_cholesky(spec_t, ct, 3, diag=-np.ones(ct.n))


@pytest.mark.parametrize("block", [1, 8, 128])
def test_panel_pivoted_cholesky_matches_jax(setup, block):
    spec_j, cj, spec_t, ct = setup
    res_j, info_j = jch.panel_pivoted_cholesky(spec_j, cj, RANK, block=block)
    res_t, info_t = tch.panel_pivoted_cholesky(spec_t, ct, RANK, block=block)
    _same_factor(res_t, info_t, res_j, info_j)
    assert info_t["block"] == block
    assert res_t.L.shape[1] == len(info_t["pivots"]) <= RANK


def test_panel_with_block_one_is_the_greedy_loop(setup):
    """Same pivots.  The factors differ by the ridge: the greedy loop takes
    its pivot value from the seed diagonal, which has no +lam (the
    reference's mixed convention), the panel from the corrected block,
    which has: lam / pivot ~ 1e-10 / 1e-5 relative in the last columns."""
    _, _, spec_t, ct = setup
    greedy, _ = tch.pivoted_cholesky(spec_t, ct, 20)
    panel, _ = tch.panel_pivoted_cholesky(spec_t, ct, 20, block=1)
    np.testing.assert_array_equal(panel.pivots.numpy(), greedy.pivots.numpy())
    assert _rel(panel.L, greedy.L.numpy()) <= 1e-6


@pytest.mark.parametrize("block", [1, 16])
def test_block_rp_cholesky_matches_jax(setup, block):
    spec_j, cj, spec_t, ct = setup
    res_j, info_j = jch.block_rp_cholesky(spec_j, cj, RANK, block=block,
                                          seed=3)
    res_t, info_t = tch.block_rp_cholesky(spec_t, ct, RANK, block=block,
                                          seed=3)
    _same_factor(res_t, info_t, res_j, info_j)
    other, _ = tch.block_rp_cholesky(spec_t, ct, RANK, block=block, seed=4)
    assert not np.array_equal(other.pivots.numpy(), res_t.pivots.numpy())


def test_full_index_order_matches_jax():
    rng = np.random.default_rng(2)
    pivots = rng.permutation(50)[:20]
    res = jch.PivotedCholeskyResult(None, jnp.asarray(pivots), None, None)
    np.testing.assert_array_equal(tch._full_index_order(pivots, 50),
                                  jch._full_index_order(res, 50))


@pytest.mark.parametrize("factorize", ["pivoted_cholesky",
                                       "panel_pivoted_cholesky",
                                       "block_rp_cholesky"])
def test_energy_constrained_factorizations_match_jax(setup, factorize):
    """Over the extended (n + N) system: the energy columns are pivots too
    (their diagonal ~2 against the forces' ~1e-3), and rank RANK stays below
    the first translation tie (rank 51 on this geometry), so the factors
    are the JAX package's pivot for pivot."""
    spec_j, cj, spec_t, ct = setup
    res_j, info_j = getattr(jch, factorize)(spec_j, cj, RANK, use_E_cstr=True)
    res_t, info_t = getattr(tch, factorize)(spec_t, ct, RANK, use_E_cstr=True)
    _same_factor(res_t, info_t, res_j, info_j)
    assert res_t.L.shape[0] == ct.n + N_TRAIN
    assert (info_t["pivots"] >= ct.n).any()


# -- preconditioners -----------------------------------------------------------


def test_woodbury_from_factor_matches_jax(setup):
    spec_j, cj, spec_t, ct = setup
    res_j, _ = jch.pivoted_cholesky(spec_j, cj, RANK)
    v = _vec(ct.n)
    want = np.asarray(jpc.woodbury_from_factor(res_j.L, LAM)(jnp.asarray(v)))
    res_t, _ = tch.pivoted_cholesky(spec_t, ct, RANK)
    P = tpc.woodbury_from_factor(res_t.L, LAM)
    assert P.B.shape == (ct.n, 128) and P.W2.shape == (128, 128)
    assert _rel(P(torch.as_tensor(v)), want) <= APPLY_RTOL
    # the dense inverse of L L^T + lam I
    L = res_t.L.numpy()
    dense = np.linalg.solve(L @ L.T + LAM * np.eye(ct.n), v)
    assert _rel(P(torch.as_tensor(v)), dense) <= 1e-6


def test_jax_factor_applied_through_the_port(setup):
    """convert.factor_preconditioner_from_numpy: a JAX-built factor, the
    port's apply."""
    spec_j, cj, _, ct = setup
    res_j, _ = jch.panel_pivoted_cholesky(spec_j, cj, RANK, block=8)
    v = _vec(ct.n)
    want = np.asarray(jpc.woodbury_from_factor(res_j.L, LAM)(jnp.asarray(v)))
    P = convert.factor_preconditioner_from_numpy(np.asarray(res_j.L), LAM,
                                                 device="cpu")
    assert isinstance(P, tpc.WoodburySplitPreconditioner)
    assert _rel(P(torch.as_tensor(v)), want) <= APPLY_RTOL


def test_nystrom_method_chol_matches_jax(setup):
    spec_j, cj, spec_t, ct = setup
    idx = np.sort(np.random.default_rng(5).choice(ct.n, 30, replace=False))
    v = _vec(ct.n)
    Pj = jpc.nystrom_preconditioner(spec_j, cj, idx, LAM, method="chol")
    want = np.asarray(Pj(jnp.asarray(v)))
    Pt = tpc.nystrom_preconditioner(spec_t, ct, idx, LAM, method="chol")
    assert isinstance(Pt, tpc.WoodburyPreconditioner)
    assert Pt.T.shape == (128, ct.n) == tuple(Pj.T.shape)
    assert _rel(Pt(torch.as_tensor(v)), want) <= APPLY_RTOL
    # convert.woodbury_preconditioner_from_numpy: the JAX T, the port's apply
    Pc = convert.woodbury_preconditioner_from_numpy(np.asarray(Pj.T), LAM,
                                                    device="cpu")
    assert _rel(Pc(torch.as_tensor(v)), want) <= 1e-12
    with pytest.raises(ValueError, match="unknown nystrom method"):
        tpc.nystrom_preconditioner(spec_t, ct, idx, LAM, method="qr")
    with pytest.raises(ValueError, match="no column-blocked form"):
        tpc.nystrom_preconditioner(spec_t, ct, idx, LAM, method="chol",
                                   block_cols=16)


def test_chol_ladders_escalate_on_breakdown():
    """``cholesky_ex`` reports a breakdown through ``info`` where the JAX
    package sees a NaN: the rung fails and the next one has more jitter."""
    rng = np.random.default_rng(6)
    Q, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    inner = torch.as_tensor(Q @ np.diag([1, 1, 1, 1, 1, -1e-3]) @ Q.T)
    _, failed = tpc._chol_with_reg(inner, 1e-10, 1.0)
    assert failed
    G, failed = tpc._chol_with_reg(inner, 1e-10, 1e14)
    assert not failed and bool(torch.isfinite(G).all())
    # stage 1 on a K_mm that is exactly singular (a column taken twice)
    K_nm = torch.as_tensor(rng.normal(size=(20, 3)))
    K_nm = torch.cat([K_nm, K_nm[:, :1]], dim=1)
    K_nm[:4] = K_nm[:4].T @ K_nm[:4]
    T = tpc._nystrom_factor_chol(K_nm, np.arange(4), 1e-10)
    assert T.shape == (4, 20) and bool(torch.isfinite(T).all())


@pytest.mark.parametrize("variant", [
    "eigvec_precon", "eigvec_precon_block_diagonal",
    "eigvec_precon_atomic_interactions"])
def test_eigvec_preconditioner_matches_jax(setup, variant):
    spec_j, cj, spec_t, ct = setup
    k, v = 30, _vec(ct.n)
    want = np.asarray(jpc.eigvec_preconditioner(
        spec_j, cj, k, LAM, variant=variant)(jnp.asarray(v)))
    svd_cache: dict = {}
    P = tpc.eigvec_preconditioner(spec_t, ct, k, LAM, variant=variant,
                                  svd_cache=svd_cache)
    assert _rel(P(torch.as_tensor(v)), want) <= APPLY_RTOL
    # the memoized (U, s) serve another k without a second decomposition
    assert list(svd_cache) == [("svd", variant, False)]
    U, s = svd_cache[("svd", variant, False)]
    want2 = np.asarray(jpc.eigvec_preconditioner(
        spec_j, cj, 12, LAM, variant=variant)(jnp.asarray(v)))
    P2 = tpc.eigvec_preconditioner(spec_t, None, 12, LAM, variant=variant,
                                   svd_cache=svd_cache)
    assert svd_cache[("svd", variant, False)][0] is U
    assert _rel(P2(torch.as_tensor(v)), want2) <= APPLY_RTOL


def test_eigvec_preconditioner_full_rank_is_the_inverse(setup):
    _, _, spec_t, ct = setup
    A = tk.assemble_full(spec_t, ct, add_ridge=LAM)
    v = torch.as_tensor(_vec(ct.n))
    P = tpc.eigvec_preconditioner(spec_t, ct, ct.n, LAM)
    out = A @ P(v)
    np.testing.assert_allclose(out.numpy(), v.numpy(), rtol=5e-5, atol=1e-7)
    with pytest.raises(NotImplementedError):
        tpc.eigvec_preconditioner(spec_t, ct, 4, LAM, variant="eigvec_other")
    # the energy-constrained system at full rank likewise; it is less well
    # conditioned: 2e-5 measured, where the force-only system meets 1e-7
    n_ext = ct.n + N_TRAIN
    A_ext = tk.assemble_full_ecstr(spec_t, ct)
    A_ext.diagonal().add_(LAM)
    v = torch.as_tensor(_vec(n_ext))
    P = tpc.eigvec_preconditioner(spec_t, ct, n_ext, LAM, use_E_cstr=True)
    np.testing.assert_allclose((A_ext @ P(v)).numpy(), v.numpy(), rtol=5e-5,
                               atol=1e-4)


def test_rank_k_leverage_scores_match_jax(setup):
    spec_j, cj, spec_t, ct = setup
    want = jpc.rank_k_leverage_scores(spec_j, cj, 30)
    got = tpc.rank_k_leverage_scores(spec_t, ct, 30)
    assert got.shape == (ct.n,)
    assert _rel(got, want) <= APPLY_RTOL


def test_jacobi_preconditioner_matches_jax(setup):
    spec_j, cj, spec_t, ct = setup
    v = _vec(ct.n)
    want = np.asarray(jpc.jacobi_preconditioner(
        jk.kernel_diag(spec_j.dim_i, cj), LAM)(jnp.asarray(v)))
    got = tpc.jacobi_preconditioner(tk.kernel_diag(spec_t.dim_i, ct), LAM)(
        torch.as_tensor(v))
    assert _rel(got, want) <= APPLY_RTOL


def test_cho_factor_stable_on_indefinite():
    """The matrix of tests/test_solvers.py::test_cho_factor_stable_on_indefinite."""
    rng = np.random.default_rng(9)
    M = rng.normal(size=(12, 12))
    M = M + M.T  # indefinite
    L = tpc.cho_factor_stable(M.copy())
    assert np.all(np.isfinite(L)) and np.allclose(L, np.tril(L))
    np.testing.assert_allclose(L, jpc.cho_factor_stable(M.copy()), rtol=1e-12)
    spd = M @ M.T + np.eye(12)
    Ls = tpc.cho_factor_stable(spd)
    np.testing.assert_allclose(Ls @ Ls.T, spd, rtol=1e-10)


@pytest.mark.parametrize("family", ["rank_k", "eigvec"])
def test_dense_diagnostic_guard(family, monkeypatch):
    spec = td.make_spec(4)
    fake_cache = types.SimpleNamespace(n=30_000, n_train=2_500,
                                       n_global=30_000, n_train_global=2_500)
    with pytest.raises(ValueError, match="small-n diagnostic"):
        if family == "rank_k":
            tpc.rank_k_leverage_scores(spec, fake_cache, 10)
        else:
            tpc.eigvec_preconditioner(spec, fake_cache, 10, 1e-10)
    monkeypatch.setenv("MLFF_TPU_DENSE_DIAG_MAX_N", "40000")
    tpc._guard_dense_diagnostic(family, 30_000)


# -- build_preconditioner: the factor strategies ---------------------------------


@pytest.mark.parametrize("strategy", ["cholesky", "cholesky_panel",
                                      "rpcholesky"])
def test_factor_strategies_build_the_jax_operator(setup, strategy):
    spec_j, cj, spec_t, ct = setup
    v = _vec(ct.n)
    Pj, idx_j, _ = jit_.build_preconditioner(
        spec_j, cj, strategy, RANK, LAM, np.random.default_rng(7))
    Pt, idx_t, info = tit.build_preconditioner(
        spec_t, ct, strategy, RANK, LAM, np.random.default_rng(7))
    np.testing.assert_array_equal(idx_t, idx_j)
    assert _rel(Pt(torch.as_tensor(v)), Pj(jnp.asarray(v))) <= APPLY_RTOL
    assert info["total_time_preconditioner"] >= info["total_time_cholesky_s"]


def test_df64_apply_of_a_cholesky_factor(setup):
    """apply_impl="df64" with a factor strategy: the factor goes through
    ``df64_from_split`` (3 components); on the CPU the df64 passes run their
    plain versions and agree with the f64 apply to the df64 tolerance."""
    _, _, spec_t, ct = setup
    v = torch.as_tensor(_vec(ct.n))
    P64, _, _ = tit.build_preconditioner(
        spec_t, ct, "cholesky", RANK, LAM, np.random.default_rng(7))
    Pdf, _, _ = tit.build_preconditioner(
        spec_t, ct, "cholesky", RANK, LAM, np.random.default_rng(7),
        task={"apply_impl": "df64"})
    assert isinstance(Pdf, tpc.DF64WoodburyPreconditioner)
    assert Pdf.Bm is not None and Pdf.info["components"] == 3
    assert _rel(Pdf(v), P64(v).numpy()) <= 3e-12


def test_unknown_strategy_and_apply_raise(setup):
    _, _, spec_t, ct = setup
    rng = np.random.default_rng(0)
    with pytest.raises(NotImplementedError, match="str_preconditioner"):
        tit.build_preconditioner(spec_t, ct, "ichol", 8, LAM, rng)
    with pytest.raises(ValueError, match="unknown apply_impl"):
        tit.build_preconditioner(spec_t, ct, "cholesky", 8, LAM, rng,
                                 task={"apply_impl": "f16"})
    assert set(tit.ALL_STRATEGIES) == set(jit_.ALL_STRATEGIES)
    assert tit.LEV_STRATEGIES == jit_.LEV_STRATEGIES
