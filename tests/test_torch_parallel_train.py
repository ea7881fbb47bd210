"""Training on the port's row-sharded operator against the JAX package:
``Trainer.train(mesh=)`` with the Nystrom preconditioner (the counterpart
of ``tests/test_parallel.py::test_trainer_train_on_mesh_matches_single_device``),
the square layout with ``cholesky_panel``, stagnation restarts, energy
constraints, the df64 apply and the greedy and block-RP pivoted Cholesky.

The JAX side runs in this process on the 8-device virtual CPU mesh of
``tests/conftest.py``, unsharded and on ``make_mesh()``, while the torch
side runs in a 2-rank and a 4-rank gloo group spawned once for the module
(``tests/torch_dist_worker.py``).  The JAX package runs every one of these
on its mesh (energy constraints and the df64 apply included), so the port
runs them too.

Tolerances.  The alphas are held to 1e-6 of max|alpha| (the JAX test's),
the square-layout solve to 1e-5.  The JAX test's iteration bound of +-1
holds there by chance: on this lam = 1e-10 system at tol 1e-10 its own
2-, 4- and 8-device meshes take 2333, 2330 and 2325 iterations against
its single device's 2326 (the summation order of the dot products moves
the ~2300-iteration trajectory), so the port is held to 1% of both JAX
counts.  Runs whose iterates drift apart are compared capped at 10
iterations, as ``tests/test_torch_ecstr.py`` does: the energy-constrained
system (calibrated ethanol, P = 6, N_train = 16) parts by ~2e-6 between
JAX's own mesh and single device there, and is held to 1e-5; the df64
and pivoted-Cholesky runs part by ~1e-11 and are held to 1e-9.  The
restart run is held to JAX's restart count and inducing set.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mlff_tpu.data.synthetic import (  # noqa: E402
    make_benchmark_dataset, make_dataset)
from mlff_tpu.models.gdml import Trainer as JaxTrainer  # noqa: E402
from mlff_tpu.models.task import create_task  # noqa: E402
from mlff_tpu.parallel import mesh as jmesh  # noqa: E402

from .torch_dist_worker import start_groups  # noqa: E402
from .torch_threads import one_torch_thread  # noqa: E402,F401

WORLDS = (2, 4)
CAP = 10


def _cases():
    """{name: (task, train kwargs)} of every training compared."""
    ds = make_dataset("ethanol", n_samples=36, seed=3)
    base = create_task(ds, 24, ds, n_valid=8, sig=5.0, solver="cg",
                       use_sym=False)
    lev = dict(break_percentage=0.05, str_preconditioner="lev_random")
    ds_sq = make_dataset("x", n_samples=40, seed=7, n_atoms=8)
    sq = create_task(ds_sq, 16, ds_sq, n_valid=10, sig=10.0, solver="cg",
                     use_sym=False)
    ds_r, perms_r = make_benchmark_dataset("ethanol", n_samples=42, seed=11,
                                           n_train=32)
    rst = create_task(ds_r, 32, ds_r, n_valid=5, sig=10.0, solver="cg",
                      perms=perms_r)
    ds_e, perms_e = make_benchmark_dataset("ethanol", n_samples=26, seed=11,
                                           n_train=16)
    ecs = create_task(ds_e, 16, ds_e, n_valid=5, sig=10.0, solver="cg",
                      perms=perms_e, use_E_cstr=True)
    return {
        "nystrom": (dict(base, solver_tol=1e-10), lev),
        "square": (dict(sq, matvec_impl="square", solver_tol=1e-9),
                   dict(break_percentage=0.2,
                        str_preconditioner="cholesky_panel")),
        "restarts": (dict(rst, n_inducing_pts_init=1),
                     dict(break_percentage=None,
                          str_preconditioner="lev_random",
                          allow_restarts=True)),
        "ecstr": (dict(ecs, solver_maxiter=CAP),
                  dict(break_percentage=0.2, str_preconditioner="lev_random")),
        "df64": (dict(base, apply_impl="df64", solver_maxiter=CAP), lev),
        "cholesky": (dict(base, solver_maxiter=CAP),
                     dict(break_percentage=0.05,
                          str_preconditioner="cholesky")),
        "rpcholesky": (dict(base, solver_maxiter=CAP),
                       dict(break_percentage=0.05,
                            str_preconditioner="rpcholesky")),
    }


def _plain(model):
    return {k: np.asarray(v) if hasattr(v, "shape") else v
            for k, v in model.items()}


@pytest.fixture(scope="module")
def cases():
    return _cases()


@pytest.fixture(scope="module")
def started(cases):
    """The torch side's groups, started before the JAX side trains."""
    scenarios = [(name, "train", dict(task=t, **kw))
                 for name, (t, kw) in cases.items()]
    return start_groups([(w, scenarios) for w in WORLDS])


@pytest.fixture(scope="module")
def jax_models(cases, started):
    """{name: (unsharded model, 8-device mesh model)} of the JAX package."""
    mesh = jmesh.make_mesh()
    return {name: (_plain(JaxTrainer().train(dict(t), **kw)),
                   _plain(JaxTrainer().train(dict(t), mesh=mesh, **kw)))
            for name, (t, kw) in cases.items()}


@pytest.fixture(scope="module")
def runs(started, jax_models):
    return dict(zip(WORLDS, started.results()))


@pytest.fixture(params=WORLDS, ids=lambda w: f"{w}ranks")
def world(request):
    return request.param


def _rel(got, want):
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def _same_on_every_rank(runs, world, name):
    ranks = [r[name] for r in runs[world]]
    for r in ranks[1:]:
        for key in ("alphas_F", "solver_iters"):
            np.testing.assert_array_equal(r[key], ranks[0][key])
    return ranks[0]


def test_trainer_train_on_mesh_matches_single_device(runs, jax_models,
                                                     world):
    """The production path on the mesh: Nystrom (lev_random) factors and
    the CG state row-sharded; the same model on every rank, the Gram guard
    quiet, alphas within 1e-6 and iterations within 1% of both JAX runs."""
    got = _same_on_every_rank(runs, world, "nystrom")
    assert not got["gram_guard_fired"]
    assert got["solver_iters"] >= 10
    for m in jax_models["nystrom"]:
        assert abs(int(got["solver_iters"]) - int(m["solver_iters"])) \
            <= 0.01 * int(m["solver_iters"])
        assert _rel(got["alphas_F"], m["alphas_F"]) <= 1e-6


def test_square_layout_solve_on_mesh(runs, jax_models, world):
    """matvec_impl='square' with cholesky_panel on the mesh converges to
    the JAX solves within 1e-5."""
    got = _same_on_every_rank(runs, world, "square")
    assert got["is_conv"]
    for m in jax_models["square"]:
        assert m["is_conv"]
        assert _rel(got["alphas_F"], m["alphas_F"]) <= 1e-5


def test_restarts_on_mesh(runs, jax_models, world):
    """Calibrated ethanol from one inducing point stagnates and restarts:
    the restart count and the grown inducing set are JAX's, and the solve
    converges."""
    got = _same_on_every_rank(runs, world, "restarts")
    assert got["is_conv"]
    for m in jax_models["restarts"]:
        assert int(got["num_restarts"]) == int(m["num_restarts"]) >= 1
        np.testing.assert_array_equal(got["inducing_pts_idxs"],
                                      m["inducing_pts_idxs"])


def test_ecstr_on_mesh(runs, jax_models, world):
    """Energy constraints on the mesh (each rank holds its points' force
    and energy entries), capped at 10 iterations: alphas_F and alphas_E
    within 1e-5 of both JAX runs."""
    got = _same_on_every_rank(runs, world, "ecstr")
    for m in jax_models["ecstr"]:
        assert int(got["solver_iters"]) == int(m["solver_iters"]) == CAP
        assert _rel(got["alphas_F"], m["alphas_F"]) <= 1e-5
        assert _rel(got["alphas_E"], m["alphas_E"]) <= 1e-5


def test_df64_apply_on_mesh(runs, jax_models, world):
    """apply_impl='df64' with the factor's words row-sharded (the JAX
    package keeps its df64 factor unsharded on the mesh), capped at 10
    iterations: within 1e-9 of both JAX runs."""
    got = _same_on_every_rank(runs, world, "df64")
    for m in jax_models["df64"]:
        assert _rel(got["alphas_F"], m["alphas_F"]) <= 1e-9


@pytest.mark.parametrize("strategy", ["cholesky", "rpcholesky"])
def test_pivoted_cholesky_on_mesh(runs, jax_models, cases, world, strategy):
    """The greedy loop (global argmax, the pivot's row broadcast from its
    owner) and the block-RP rounds (candidates from the gathered diagonal)
    on the mesh: the pivots of the unsharded port, alphas within 1e-9 of
    both JAX runs after 10 iterations."""
    from mlff_tpu_torch.models.gdml import Trainer

    got = _same_on_every_rank(runs, world, strategy)
    task, kw = cases[strategy]
    tr = Trainer(device="cpu")
    tr.train(dict(task), **kw)
    np.testing.assert_array_equal(got["pivots"], tr.last_info["pivots"])
    for m in jax_models[strategy]:
        assert _rel(got["alphas_F"], m["alphas_F"]) <= 1e-9
