"""Large molecules in the port against the JAX package.

Counterparts of ``tests/test_compressed_columns.py``,
``tests/test_large_molecule.py`` and the square-layout tests of
``tests/test_kernel.py``: inflation-free (compressed) columns, diagonal and
single columns; the square all-pairs layout (its cache fields, matvec and
column assembly); the pivoted Cholesky family at nanotube size
(A = 370, D = 68,265) through the compressed routes; and a small
``solve_iterative`` that selects the square matvec.  Each input is made
with NumPy from a seed and goes through both packages on the CPU.

Tolerances: columns, diagonals and matvecs are f64 against f64 and agree to
1e-10 relative to the largest entry (the JAX tests' rtol is 1e-9 against
their own oracles); the square layout's Matern weights to 1e-7 where the
Gram trick of a near-zero distance cancels (``tests/test_kernel.py``);
factorizations draw the same pivots and agree in L L^T to 1e-10.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mlff_tpu.data.synthetic import make_dataset  # noqa: E402
from mlff_tpu.ops import descriptor as jd  # noqa: E402
from mlff_tpu.ops import kernel as jk  # noqa: E402
from mlff_tpu.solvers import iterative as jit_  # noqa: E402
from mlff_tpu.solvers import pivoted_cholesky as jpch  # noqa: E402
from mlff_tpu.solvers import preconditioners as jpc  # noqa: E402
from mlff_tpu.solvers.cg import pcg as jpcg  # noqa: E402
from mlff_tpu_torch.convert import square_cache_from_numpy  # noqa: E402
from mlff_tpu_torch.ops import descriptor as td  # noqa: E402
from mlff_tpu_torch.ops import kernel as tk  # noqa: E402
from mlff_tpu_torch.solvers import iterative as tit  # noqa: E402
from mlff_tpu_torch.solvers import pivoted_cholesky as tpch  # noqa: E402
from mlff_tpu_torch.solvers import preconditioners as tpc  # noqa: E402
from mlff_tpu_torch.solvers.cg import pcg as tpcg  # noqa: E402

RTOL = 1e-10
SIG, LAM = 10.0, 1e-10


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _caches(R, perms=None, square=False, lam=LAM):
    """(spec, JAX cache, port cache) of geometries R (N, A, 3), each built by
    its own package; ``square`` adds the all-pairs fields."""
    n_atoms = R.shape[1]
    if perms is None:
        perms = np.arange(n_atoms)[None, :]
    spec_j = jd.make_spec(n_atoms)
    X, Jc = jd.descriptors_from_R(spec_j, jnp.asarray(R))
    cj = jk.build_cache(X, Jc, jd.incidence_matrix(spec_j),
                        jnp.asarray(jd.desc_perms(perms)), SIG, lam,
                        R=jnp.asarray(R) if square else None)
    spec_t = td.make_spec(n_atoms)
    Xt, Jct = td.descriptors_from_R(spec_t, torch.as_tensor(R))
    ct = tk.build_cache(Xt, Jct, td.incidence_matrix(spec_t),
                        td.desc_perms(perms), SIG, lam,
                        R=R if square else None, device="cpu")
    return spec_t, cj, ct


def _random_R(n_atoms, n_train, seed, scale=1.5):
    return np.random.default_rng(seed).normal(size=(n_train, n_atoms, 3)) * scale


def _involution(n_atoms):
    invol = np.arange(n_atoms)
    invol[0], invol[1] = 1, 0
    return np.stack([np.arange(n_atoms), invol])


def _unit_columns(cache, idxs):
    """Columns of K (no ridge) by the port's matvec of unit vectors."""
    cols = []
    for c in idxs:
        e = torch.zeros(cache.n, dtype=torch.float64)
        e[int(c)] = 1.0
        col = tk.matvec_psd(cache, e)
        col[int(c)] -= cache.lam
        cols.append(col)
    return torch.stack(cols, dim=1).numpy()


# -- compressed columns (tests/test_compressed_columns.py) --------------------


def test_compressed_matches_block_path():
    spec, cj, ct = _caches(_random_R(5, 9, 0), perms=_involution(5))
    idxs = np.sort(np.random.default_rng(1).choice(ct.n, 13, replace=False))
    got = tk.assemble_columns_compressed(spec, ct, idxs, chunk=4).numpy()
    assert _rel(got, jk.assemble_columns_compressed(spec, cj, idxs,
                                                    chunk=4)) <= RTOL
    assert _rel(got, tk.assemble_columns(spec, ct, idxs)) <= RTOL


def test_large_descriptor_compressed_columns_match_matvec():
    """A = 88 (D = 3828): compressed columns against JAX's and against the
    port's matvec of unit vectors."""
    spec, cj, ct = _caches(_random_R(88, 4, 0), )
    idxs = np.sort(np.random.default_rng(2).choice(ct.n, 6, replace=False))
    got = tk.assemble_columns_compressed(spec, ct, idxs, chunk=3).numpy()
    assert _rel(got, jk.assemble_columns_compressed(spec, cj, idxs,
                                                    chunk=3)) <= RTOL
    assert _rel(got, _unit_columns(ct, idxs)) <= RTOL


def test_grouped_compressed_matches_per_column():
    perms = np.stack([np.arange(7), np.array([1, 0, 2, 3, 4, 6, 5])])
    spec, cj, ct = _caches(_random_R(7, 10, 0), perms=perms)
    idxs = np.sort(np.random.default_rng(7).choice(
        ct.n, size=min(ct.n - 1, 5 * ct.n_train), replace=False))
    got = tk.assemble_columns_compressed_grouped(spec, ct, idxs,
                                                 g_chunk=4).numpy()
    assert _rel(got, jk.assemble_columns_compressed_grouped(
        spec, cj, idxs, g_chunk=4)) <= RTOL
    assert _rel(got, tk.assemble_columns_compressed(spec, ct, idxs)) <= RTOL


def test_square_assembly_matches_compressed():
    spec, cj, ct = _caches(_random_R(11, 6, 4), square=True)
    assert ct.Xsq is not None and ct.Usq is not None
    idxs = np.sort(np.random.default_rng(9).choice(
        ct.n, size=min(ct.n - 1, 40), replace=False))
    got = tk.assemble_columns_square(spec, ct, idxs, g_chunk=4).numpy()
    assert _rel(got, jk.assemble_columns_square(spec, cj, idxs,
                                                g_chunk=4)) <= RTOL
    assert _rel(got, tk.assemble_columns_compressed(spec, ct, idxs)) <= RTOL


@pytest.mark.parametrize("projections", ["cached", "recomputed"])
def test_square_assembly_self_columns(projections):
    """Columns of every point, the self block (delta = 0) included, against
    the port's matvec of unit vectors; with the per-point projections read
    from the cache and recomputed per call (a cache that could not hold
    them)."""
    spec, cj, ct = _caches(_random_R(7, 4, 2), square=True)
    if projections == "recomputed":
        ct.Usq = ct.Zsq = ct.C1sq = None
    idxs = np.arange(0, ct.n, 5)
    got = tk.assemble_columns_square(spec, ct, idxs).numpy()
    assert _rel(got, jk.assemble_columns_square(spec, cj, idxs)) <= RTOL
    assert _rel(got, _unit_columns(ct, idxs)) <= RTOL


@pytest.mark.parametrize("field", ["Xsq", "Gsq", "Usq", "Zsq", "C1sq"])
def test_square_cache_fields_match_jax(field):
    _, cj, ct = _caches(_random_R(7, 4, 2), square=True)
    got = getattr(ct, field)
    assert got.shape == getattr(cj, field).shape
    assert _rel(got, getattr(cj, field)) <= 1e-12


# -- the square layout (tests/test_kernel.py::TestSquareLayout) ---------------


def _square(R, perms):
    sq_j = jk.build_cache_square(jnp.asarray(R), perms, SIG, LAM)
    sq_t = tk.build_cache_square(R, perms, SIG, LAM, device="cpu")
    return sq_j, sq_t


def _two_perms(n_atoms):
    invol = np.arange(n_atoms)
    invol[0], invol[1] = 1, 0
    invol[2], invol[3] = 3, 2
    return np.stack([np.arange(n_atoms), invol])


@pytest.mark.parametrize("n_atoms,n_train,perms", [
    (6, 7, "two"), (17, 4, "one")], ids=["with_perms", "single_perm_large"])
def test_matvec_square_matches_packed(n_atoms, n_train, perms):
    R = _random_R(n_atoms, n_train, 3 if perms == "two" else 9)
    perms = (_two_perms(n_atoms) if perms == "two"
             else np.arange(n_atoms)[None, :])
    _, _, ct = _caches(R, perms=perms)
    sq_j, sq_t = _square(R, perms)
    rng = np.random.default_rng(5)
    for _ in range(2):
        v = rng.standard_normal(ct.n)
        got = tk.matvec_psd_square(sq_t, torch.as_tensor(v)).numpy()
        assert _rel(got, tk.matvec_psd(ct, torch.as_tensor(v))) <= RTOL
        assert _rel(got, jk.matvec_psd_square(sq_j, jnp.asarray(v))) <= RTOL


def test_square_kernel_weights_match_packed():
    """The square layout's weights equal the packed cache's and the JAX
    square cache's: near-zero distances amplify the Gram trick's
    cancellation, so a few self-distance entries differ at ~1e-8."""
    R = _random_R(6, 5, 4)
    perms = _two_perms(6)
    _, cj, ct = _caches(R, perms=perms)
    sq_j, sq_t = _square(R, perms)
    np.testing.assert_allclose(sq_t.A_exp.numpy(), ct.A_exp.numpy(),
                               rtol=1e-7, atol=1e-15)
    np.testing.assert_allclose(sq_t.A_exp.numpy(), np.asarray(sq_j.A_exp),
                               rtol=1e-7, atol=1e-15)
    for name in ("Gs", "Gst", "Xs", "Xst"):
        assert _rel(getattr(sq_t, name), getattr(sq_j, name)) <= 1e-12


def test_square_cache_converts_from_jax():
    R = _random_R(6, 5, 4)
    perms = _two_perms(6)
    sq_j, _ = _square(R, perms)
    sq_t = square_cache_from_numpy(
        {k: np.asarray(getattr(sq_j, k)) for k in sq_j._fields}, device="cpu")
    v = np.random.default_rng(8).standard_normal(5 * 6 * 3)
    got = tk.matvec_psd_square(sq_t, torch.as_tensor(v)).numpy()
    assert _rel(got, jk.matvec_psd_square(sq_j, jnp.asarray(v))) <= RTOL


def test_solve_iterative_selects_the_square_matvec():
    """Catcher geometries (A = 88 >= 64 P), N = 4: both packages switch to
    the square matvec, draw the same columns, and after the same 10
    iterations hold the same iterate (1e-10).  The solve is capped: rounding
    differences grow to ~1e-5 of the iterate by iteration 25, and the
    uncapped solves (~230 iterations at this ridge of 1e-6) end 0-6
    iterations apart."""
    ds = make_dataset("catcher", n_samples=4, seed=5)
    R = np.asarray(ds["R"])
    spec, cj, ct = _caches(R, lam=1e-6)
    assert tit._square_matvec_wins(spec, ct)
    assert jit_._square_matvec_wins(spec, cj)
    y = np.asarray(ds["F"], dtype=np.float64).ravel()
    y /= y.std()
    task = {"R_train": R, "perms": np.arange(88)[None], "solver_maxiter": 10}
    res_t = tit.solve_iterative(spec, ct, task, y, 1.0, break_percentage=0.1,
                                str_preconditioner="random_scores")
    res_j = jit_.solve_iterative(spec, cj, task, y, 1.0, break_percentage=0.1,
                                 str_preconditioner="random_scores")
    assert res_t.info["matvec_impl"] == "square"
    assert res_t.num_iters == res_j.num_iters == 10
    np.testing.assert_array_equal(res_t.inducing_pts_idxs,
                                  res_j.inducing_pts_idxs)
    assert _rel(res_t.alphas, res_j.alphas) <= RTOL
    assert abs(res_t.resid - res_j.resid) <= RTOL * res_j.resid


# -- catcher size (tests/test_large_molecule.py) ------------------------------


@pytest.fixture(scope="module")
def catcher():
    """A = 88 (D = 3828), N = 6: n = 1584."""
    ds = make_dataset("catcher", n_samples=8, seed=5)
    spec, cj, ct = _caches(np.asarray(ds["R"][:6]))
    return spec, cj, ct, ds


def test_catcher_dimensions(catcher):
    spec, _, ct, _ = catcher
    assert spec.dim == 88 * 87 // 2 and ct.n == 6 * 88 * 3
    assert tuple(td.inflate_jacobian(ct.Jc[0], ct.S).shape) == (3828, 264)


def test_inflate_jacobian_matches_jax(catcher):
    _, cj, ct, _ = catcher
    got = td.inflate_jacobian(ct.Jc[2], ct.S).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jd.inflate_jacobian(cj.Jc[2], cj.S)))


def test_catcher_matvec_matches_column(catcher):
    spec, cj, ct, _ = catcher
    e = torch.zeros(ct.n, dtype=torch.float64)
    e[13] = 1.0
    col = tk.matvec_psd(ct, e).numpy()
    assert _rel(col, tk.kernel_column(spec.dim_i, ct, 13)) <= RTOL
    assert _rel(col, jk.kernel_column(spec.dim_i, cj, jnp.asarray(13))) <= RTOL


def test_cg_with_nystrom_on_large_descriptor(catcher):
    """Nystrom-PCG on the catcher system: the same preconditioner apply and
    the same first 10 iterations as the JAX package (iterate and residual
    to 1e-10; later iterations of this lam = 1e-10 solve amplify rounding,
    to ~1e-1 of the residual by iteration 30).  The JAX test runs the solve
    to its end (~3,760 iterations, ~27 s in the port alone on the CPU); the
    card runs such solves in ``chip_smoke.py``'s train_catcher phase."""
    spec, cj, ct, ds = catcher
    y = np.asarray(ds["F"][:6], dtype=np.float64).ravel()
    y /= y.std()
    idxs = tpc.select_random(ct.n, ct.n // 6, np.random.default_rng(0))
    P_t = tpc.nystrom_preconditioner(spec, ct, idxs, LAM)
    P_j = jpc.nystrom_preconditioner(spec, cj, idxs, LAM)
    v = np.random.default_rng(1).normal(size=ct.n)
    assert _rel(P_t(torch.as_tensor(v)), P_j(jnp.asarray(v))) <= 1e-8
    res_t = tpcg(lambda x: tk.matvec_psd(ct, x), torch.as_tensor(y),
                 precon=P_t, tol=1e-4, maxiter=10)
    res_j = jpcg((jk.matvec_psd, cj), jnp.asarray(y), precon=P_j, tol=1e-4,
                 maxiter=10)
    assert np.all(np.isfinite(res_t.x))
    assert res_t.num_iters == res_j.num_iters == 10
    assert abs(res_t.resid - res_j.resid) <= RTOL * res_j.resid
    assert _rel(res_t.x, res_j.x) <= RTOL


# -- nanotube size (A = 370, D = 68,265) -------------------------------------


@pytest.fixture(scope="module")
def nanotube():
    """AIMS-nanotube-sized (A = 370 => D = 68,265), N = 3: n = 3330."""
    spec, cj, ct = _caches(_random_R(370, 3, 7, scale=6.0))
    assert tk._is_large_D(spec, ct.n_perms)
    return spec, cj, ct


def test_nanotube_diag_compressed_matches(nanotube):
    spec, cj, ct = nanotube
    d_any = tk.kernel_diag_any(spec, ct).numpy()
    np.testing.assert_array_equal(
        d_any, tk.kernel_diag_compressed(spec.dim_i, ct).numpy())
    assert _rel(d_any, jk.kernel_diag_compressed(spec.dim_i, cj)) <= RTOL
    cols = np.array([0, 517, ct.n - 1])
    c = tk.assemble_columns(spec, ct, cols).numpy()
    np.testing.assert_allclose(d_any[cols], c[cols, np.arange(3)],
                               rtol=RTOL)


def test_nanotube_columns_route_to_the_compressed_paths(nanotube):
    """Sparse selections take the per-column route, dense ones the grouped
    route; both match the JAX columns."""
    spec, cj, ct = nanotube
    sparse = np.array([5, 1200, 2500])
    dense = np.sort(np.random.default_rng(3).choice(1110, 12, replace=False))
    for idxs in (sparse, dense):
        got = tk.assemble_columns(spec, ct, idxs).numpy()
        assert _rel(got, jk.assemble_columns(spec, cj, idxs)) <= RTOL


def test_nanotube_panel_cholesky(nanotube):
    """Two rounds of 8 candidates (the JAX test takes three of 16)."""
    spec, cj, ct = nanotube
    res_t, info_t = tpch.panel_pivoted_cholesky(spec, ct, max_rank=16,
                                                block=8)
    res_j, info_j = jpch.panel_pivoted_cholesky(spec, cj, max_rank=16,
                                                block=8)
    assert res_t.L.shape[0] == ct.n and torch.isfinite(res_t.L).all()
    assert (res_t.pivot_values > 0).all()
    np.testing.assert_array_equal(info_t["pivots"], np.asarray(info_j["pivots"]))
    Lj = np.asarray(res_j.L)
    assert _rel(res_t.L @ res_t.L.T, Lj @ Lj.T) <= RTOL


def test_nanotube_greedy_cholesky_compressed_column(nanotube):
    spec, cj, ct = nanotube
    c_comp = tk.kernel_column_compressed(spec.dim_i, ct, 1234).numpy()
    assert _rel(c_comp, tk.kernel_column(spec.dim_i, ct, 1234)) <= RTOL
    assert _rel(c_comp, jk.kernel_column_compressed(
        spec.dim_i, cj, jnp.asarray(1234))) <= RTOL
    res_t, _ = tpch.pivoted_cholesky(spec, ct, max_rank=16)
    res_j, _ = jpch.pivoted_cholesky(spec, cj, max_rank=16)
    assert tuple(res_t.L.shape) == (ct.n, 16)
    assert (res_t.pivot_values > 0).all()
    np.testing.assert_array_equal(res_t.pivots.numpy(),
                                  np.asarray(res_j.pivots))
    assert _rel(res_t.L, res_j.L) <= RTOL
