"""The port's row-sharded operator (``mlff_tpu_torch.parallel``) against the
JAX package's, operator by operator: the counterparts of
``tests/test_parallel.py``'s matvec, layout, square-layout and
prediction tests, plus the on-the-fly matvec, column assembly, the
energy-constrained system and uneven row counts.

The JAX side runs in this process on the 8-device virtual CPU mesh of
``tests/conftest.py``, with ``mesh=None`` and with ``make_mesh()``.  The
torch side runs in a 2-rank and a 4-rank gloo group, spawned once for the
module (``tests/torch_dist_worker.py``, which imports no JAX; the two
groups run at the same time).  Each test is a case per group size.
Tolerances are those of ``tests/test_parallel.py``: matvec and apply
1e-10 relative (1e-12 absolute), predictions 1e-10, evaluate's MAEs 1e-9.
The prediction model's coefficients reach ~8e8 (lam = 1e-10), so its
forces are sums of terms ~1e8 times larger than they are, and a predicted
energy is the integration constant |c| (~6e4) plus a contraction that
cancels it: the two packages' unsharded Predictors part by 4.5e-11 of
max|F| and 1.3e-8 in E (measured), and the mesh's predictions are held to
JAX's at 1e-10 of max|F| and of |c| (as ``tests/test_torch_evaluate.py``
holds energies; e_mae too; and the batch of 3 against the port's own
unsharded Predictor, whose rows are summed in products of other shapes),
and to the port's own unsharded Predictor and evaluate otherwise, the same
sums split by rows, at 1e-10 / 1e-9 relative;
the energy-constrained pieces are held to the single-process port at
1e-12 relative (kernel pieces; the sums of another split) and 1e-10 (the
factor apply), as ``tests/test_torch_ecstr.py`` holds them to JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mlff_tpu.data.synthetic import make_dataset  # noqa: E402
from mlff_tpu.models.evaluate import evaluate as jax_evaluate  # noqa: E402
from mlff_tpu.models.gdml import Trainer as JaxTrainer  # noqa: E402
from mlff_tpu.models.predict import Predictor as JaxPredictor  # noqa: E402
from mlff_tpu.models.task import create_task  # noqa: E402
from mlff_tpu.ops import descriptor as jd  # noqa: E402
from mlff_tpu.ops import kernel as jk  # noqa: E402
from mlff_tpu.parallel import mesh as jmesh  # noqa: E402
from mlff_tpu.solvers import preconditioners as jpc  # noqa: E402

from .torch_dist_worker import _cache, start_groups  # noqa: E402
from .torch_threads import one_torch_thread  # noqa: E402,F401

WORLDS = (2, 4)
N_TRAIN, N_ATOMS, SIG, LAM = 16, 4, 10.0, 1e-10


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _close(got, want, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def inputs():
    """NumPy inputs of every scenario, made from seeds."""
    rng = np.random.default_rng(0)
    R = rng.normal(size=(N_TRAIN, N_ATOMS, 3)) * 1.5
    n = N_TRAIN * N_ATOMS * 3
    v = rng.normal(size=n)
    V = rng.normal(size=(n, 3))
    # a sparse selection (point blocks) and a dense one (grouped columns)
    cols = [np.sort(rng.choice(n, 10, replace=False)), np.arange(0, n, 2)]
    L = rng.normal(size=(n, 8))
    R_sq = rng.normal(size=(16, 6, 3)) * 1.5
    perms_sq = np.stack([np.arange(6), np.array([1, 0, 2, 3, 5, 4])])
    v_sq = rng.normal(size=16 * 6 * 3)
    # columns of a few points, several partials each (the grouped routes)
    cols_sq = np.sort(np.concatenate([p * 18 + rng.choice(18, 6, False)
                                      for p in (1, 6, 11, 14)]))
    # energy constraints: a random geometry with two permutations
    R_e = rng.normal(size=(8, 5, 3)) * 1.5
    perms_e = np.array([[0, 1, 2, 3, 4], [1, 0, 2, 3, 4]])
    n_e = 8 * 5 * 3
    v_e = rng.normal(size=n_e + 8)
    idxs_e = np.sort(rng.choice(n_e, 20, replace=False))
    idxs_any = np.sort(np.concatenate([idxs_e[:10], n_e + np.array([1, 5])]))
    # prediction: a model trained by the JAX package
    ds = make_dataset("ethanol", n_samples=120, seed=9)
    task = create_task(ds, 24, ds, n_valid=8, sig=5.0, solver="cg",
                       use_sym=False)
    model = JaxTrainer().train(task, break_percentage=0.2,
                               str_preconditioner="lev_random")
    model = {k: np.asarray(v_) if hasattr(v_, "shape") else v_
             for k, v_ in model.items()}
    return dict(R=R, v=v, V=V, cols=cols, L=L, R_sq=R_sq, perms_sq=perms_sq,
                v_sq=v_sq, cols_sq=cols_sq, R_e=R_e, perms_e=perms_e, v_e=v_e, idxs_e=idxs_e,
                idxs_any=idxs_any, k_e=15, ds=ds, model=model)


@pytest.fixture(scope="module")
def started(inputs):
    """The torch side's groups, started before the JAX side runs."""
    i = inputs
    ds = i["ds"]
    scenarios = [
        ("operator", dict(R=i["R"], v=i["v"], V=i["V"], cols=i["cols"])),
        ("column_routes", dict(R=i["R_sq"], cols=i["cols_sq"], col=7)),
        ("uneven", dict(R=i["R"][:N_TRAIN - 1])),
        ("precon", dict(L=i["L"], v=i["v"], lam=LAM)),
        ("df64_build", dict(R=i["R"], v=i["v"], n_inducing=4)),
        ("square_matvec", dict(R=i["R_sq"], perms=i["perms_sq"],
                               v=i["v_sq"])),
        ("ecstr_operator", dict(R=i["R_e"], perms=i["perms_e"], v=i["v_e"],
                                idxs=i["idxs_e"], idxs_any=i["idxs_any"],
                                k=i["k_e"])),
        ("predict", dict(model=i["model"], R=ds["R"][:40], ds_R=ds["R"],
                         ds_F=ds["F"], ds_E=ds["E"])),
    ]
    return start_groups([(w, scenarios) for w in WORLDS])


@pytest.fixture(scope="module")
def runs(started, jax_ref):
    """{world: every rank's results} of the torch side."""
    return dict(zip(WORLDS, started.results()))


@pytest.fixture(scope="module")
def jax_ref(inputs, started):
    """The JAX package's numbers, unsharded and on its 8-device mesh."""
    i = inputs
    spec = jd.make_spec(N_ATOMS)
    X, Jc = jd.descriptors_from_R(spec, jnp.asarray(i["R"]))
    args = (X, Jc, jd.incidence_matrix(spec),
            jnp.asarray(jd.desc_perms(np.arange(N_ATOMS)[None])), SIG, LAM)
    cache = jk.build_cache(*args)
    otf = jk.build_cache(*args, pairwise=False)
    mesh = jmesh.make_mesh()
    sh = jmesh.shard_cache(cache, mesh)
    v = jnp.asarray(i["v"])
    v_sh = jmesh.shard_vector(v, mesh)
    P = jpc.woodbury_from_factor(jnp.asarray(i["L"]), LAM)
    sq = jk.build_cache_square(jnp.asarray(i["R_sq"]),
                               jnp.asarray(i["perms_sq"]), SIG, LAM)
    v_sq = jnp.asarray(i["v_sq"])
    ds, model = i["ds"], i["model"]
    R40 = ds["R"][:40]
    return {
        "matvec": np.asarray(jk.matvec_psd(cache, v)),
        "matvec_mesh": np.asarray(jk.matvec_psd(sh, v_sh)),
        "matvec_otf": np.asarray(jk.matvec_psd(otf, v)),
        "matmat": np.asarray(jk.matmat_psd(cache, jnp.asarray(i["V"]))),
        "diag": np.asarray(jk.kernel_diag_any(spec, cache)),
        "cols": [np.asarray(jk.assemble_columns(spec, cache, c))
                 for c in i["cols"]],
        "apply": np.asarray(P(v)),
        "apply_mesh": np.asarray(jmesh.shard_preconditioner(P, mesh)(
            jmesh.shard_vector(v, mesh))),
        "sq": np.asarray(jk.matvec_psd_square(sq, v_sq)),
        "sq_mesh": np.asarray(jk.matvec_psd_square(
            jmesh.shard_square_cache(sq, mesh),
            jmesh.shard_vector(v_sq, mesh))),
        "predict": JaxPredictor(model).predict(R40),
        "predict_mesh": JaxPredictor(model, mesh=mesh).predict(R40),
        "eval": jax_evaluate(model, ds, n_points=30),
        "eval_mesh": jax_evaluate(model, ds, n_points=30, mesh=mesh),
    }


@pytest.fixture(params=WORLDS, ids=lambda w: f"{w}ranks")
def world(request):
    return request.param


def test_sharded_matvec_matches_single_device(runs, jax_ref, world):
    got = runs[world][0]["operator"]["matvec"]
    _close(got, jax_ref["matvec"])
    _close(got, jax_ref["matvec_mesh"])


def test_sharded_matvec_is_actually_sharded(runs, world):
    """Every rank holds N / world rows of the (N, M) caches and of X."""
    for r in runs[world]:
        op = r["operator"]
        assert op["world"] == world
        assert op["rows_A_exp"] == op["rows_X"] == N_TRAIN // world


def test_otf_matvec_on_mesh(runs, jax_ref, world):
    """The on-the-fly cache (no (N, M) arrays) row-sharded."""
    _close(runs[world][0]["operator"]["matvec_otf"], jax_ref["matvec_otf"])


def test_matmat_diag_and_columns_on_mesh(runs, jax_ref, world):
    """matmat_psd, kernel_diag_any and the point-block and grouped column
    routes, each rank's rows gathered."""
    op = runs[world][0]["operator"]
    _close(op["matmat"], jax_ref["matmat"])
    _close(op["diag"], jax_ref["diag"])
    for i, want in enumerate(jax_ref["cols"]):
        _close(op[f"cols{i}"], want, atol=1e-12 * np.abs(want).max())


def test_large_molecule_column_routes_on_mesh(runs, inputs, world):
    """The compressed, compressed-grouped and square column routes, single
    columns (the greedy loop's, ridge on the owner's row) and the
    compressed diagonal on the mesh, against the single-process port (held
    to the JAX package by tests/test_torch_large_molecule.py) at 1e-12."""
    import dataclasses

    from mlff_tpu_torch.ops import descriptor as td
    from mlff_tpu_torch.ops import kernel as tk

    R = inputs["R_sq"]
    spec = td.make_spec(R.shape[1])
    X, Jc = td.descriptors_from_R(spec, torch.as_tensor(R))
    cache = tk.build_cache(X, Jc, td.incidence_matrix(spec),
                           td.desc_perms(np.arange(R.shape[1])[None]), SIG,
                           LAM, R=R, device="cpu")
    c = inputs["cols_sq"]
    g = torch.as_tensor([7])
    want = {
        "compressed": tk.assemble_columns_compressed(spec, cache, c),
        "compressed_grouped": tk.assemble_columns_compressed_grouped(
            spec, cache, c),
        "square": tk.assemble_columns_square(spec, cache, c),
        "square_no_projections": tk.assemble_columns_square(
            spec, dataclasses.replace(cache, Usq=None, Zsq=None, C1sq=None),
            c),
        "column": tk.kernel_column(spec.dim_i, cache, g),
        "column_compressed": tk.kernel_column_compressed(spec.dim_i, cache,
                                                         g),
        "diag_compressed": tk.kernel_diag_compressed(spec.dim_i, cache),
    }
    got = runs[world][0]["column_routes"]
    for key, w in want.items():
        assert _rel(got[key], w.numpy()) <= 1e-12, (key, _rel(got[key],
                                                              w.numpy()))


def test_uneven_rows_raise(runs, world):
    """N = 15 over 2 or 4 ranks: ValueError, as the JAX package requires N
    to divide evenly."""
    for r in runs[world]:
        assert r["uneven"].startswith("ValueError"), r["uneven"]


def test_shard_preconditioner_layouts(runs, jax_ref, world):
    """The split factor's B lands row-sharded, W2 replicated; the split,
    column-blocked, row-sharded-factor and df64 applies all equal the JAX
    split apply at 1e-10 (df64's words carry 2^-72 of B, well inside)."""
    n = N_TRAIN * N_ATOMS * 3
    for r in runs[world]:
        p = r["precon"]
        assert p["rows_B"] == n // world
        assert p["rows_Bs"] == [n // world] * 2
        assert p["rows_W2"] == 128
    want = jax_ref["apply"]
    p = runs[world][0]["precon"]
    for key in ("split", "colblock", "factor", "df64"):
        _close(p[key], want, atol=1e-12 * np.abs(want).max())
        _close(p[key], jax_ref["apply_mesh"],
               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("strategy", ["cholesky", "lev_random"])
def test_df64_components_count_global_rows(runs, world, strategy):
    """The df64 factor's number of components follows the JAX package's
    rule on the whole factor's bytes, also where a rank's rows alone fall
    below its limit (the limit set between the two): a sharded build keeps
    the 2 components of the unsharded one, and applies as it does at
    1e-10."""
    for r in runs[world]:
        assert r["df64_build"][strategy]["components"] == (2, 2)
    got = runs[world][0]["df64_build"][strategy]
    _close(got["apply_mesh"], got["apply"],
           atol=1e-12 * np.abs(got["apply"]).max())


def test_sharded_square_matvec_matches_single_device(runs, jax_ref, world):
    """The square all-pairs layout row-sharded, its permuted training side
    (Gst) too."""
    r = runs[world][0]["square_matvec"]
    assert r["rows_Gst"] == 16 * 2 // world
    _close(r["matvec"], jax_ref["sq"])
    _close(r["matvec"], jax_ref["sq_mesh"])


def test_ecstr_operator_on_mesh(runs, inputs, world):
    """The energy-constrained (n + N) system on the mesh, each rank holding
    its points' force and energy entries: matvec, diagonal, force and mixed
    columns, the Nystrom apply and the three pivoted factorizations against
    the single-process port (held to the JAX package by
    tests/test_torch_ecstr.py): equal pivots, 1e-12 / 1e-10."""
    from mlff_tpu_torch.ops import kernel as tk
    from mlff_tpu_torch.solvers import pivoted_cholesky as tpch
    from mlff_tpu_torch.solvers import preconditioners as tpc

    i = inputs
    spec, cache = _cache(i["R_e"], SIG, LAM, i["perms_e"])
    v = torch.as_tensor(i["v_e"])
    got = runs[world][0]["ecstr_operator"]
    want = {
        "matvec": tk.matvec_psd_ecstr(cache, v),
        "diag": tk.kernel_diag_ecstr(spec.dim_i, cache),
        "cols": tk.assemble_columns_ecstr(spec, cache, i["idxs_e"]),
        "cols_any": tk.assemble_columns_ecstr_any(spec, cache,
                                                  i["idxs_any"]),
    }
    for key, w in want.items():
        assert _rel(got[key], w.numpy()) <= 1e-12, key
    P = tpc.nystrom_preconditioner(spec, cache, i["idxs_e"], LAM,
                                   use_E_cstr=True)
    assert _rel(got["apply"], P(v).numpy()) <= 1e-10
    for name, fn in (("greedy", tpch.pivoted_cholesky),
                     ("panel", tpch.panel_pivoted_cholesky),
                     ("rp", tpch.block_rp_cholesky)):
        res, _ = fn(spec, cache, i["k_e"], use_E_cstr=True)
        np.testing.assert_array_equal(got[name + "_pivots"],
                                      res.pivots.numpy())
        assert _rel(got[name + "_L"], res.L.numpy()) <= 1e-12, name


def test_predict_eval_on_mesh(runs, jax_ref, inputs, world):
    """Predictor(mesh=) splits the batch over the ranks (40 geometries, and
    a batch of 3, fewer than 4 ranks, padded), takes the f64 contraction
    whatever ``fast`` says, and every rank gets the whole result;
    evaluate(mesh=) reproduces the metrics."""
    from mlff_tpu_torch.models.predict import Predictor

    E1, F1 = jax_ref["predict"]
    E8, F8 = jax_ref["predict_mesh"]
    model = inputs["model"]
    from mlff_tpu_torch.models.evaluate import evaluate

    ds = inputs["ds"]
    E0, F0 = Predictor(model, device="cpu").predict(ds["R"][:40])
    res0 = evaluate(model, ds, n_points=30, device="cpu")
    e_atol = 1e-10 * abs(float(model["c"]))
    f_atol = 1e-10 * np.abs(F1).max()
    for r in runs[world]:
        p = r["predict"]
        assert p["fast"] is False
        for E, F in ((E1, F1), (E8, F8)):
            _close(p["E"], E, rtol=0, atol=e_atol)
            _close(p["F"], F, rtol=0, atol=f_atol)
        _close(p["E"], E0)
        _close(p["F"], F0)
        # a batch of 3 split over the ranks: other product shapes
        _close(p["E3"], E0[:3], rtol=0, atol=e_atol)
        _close(p["F3"], F0[:3], rtol=0, atol=f_atol)
        for res in (jax_ref["eval"], jax_ref["eval_mesh"]):
            assert p["eval"]["n_points"] == res.n_points
            for field in ("f_mae", "cos_mae"):
                np.testing.assert_allclose(p["eval"][field],
                                           getattr(res, field), rtol=1e-9)
            assert abs(p["eval"]["e_mae"] - res.e_mae) <= e_atol
        for field, want in res0.as_dict().items():
            np.testing.assert_allclose(p["eval"][field], want, rtol=1e-9)
