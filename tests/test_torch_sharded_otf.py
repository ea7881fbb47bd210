"""The row-sharded on-the-fly matvec, held to the benchmark's plain
reference (``benchmark/reference.py``: plain PyTorch, nothing of the
program), on four gloo ranks spawned once for the module
(``tests/torch_dist_worker.py``):

  * the sharded OTF matvec against the reference's K v, which is
    -F(R_i; v) at std 1: the forces that coefficients v predict at the
    training points;
  * a whole training with the Trainer's rule sending the cache to the OTF
    matvec, judged by the reference: the stored descriptors, the
    cotangents J a and the true residual of (K + lam I) a = y, under the
    limits of the row-sharded ethanol training at n = 157,464 (those of
    the one-card ethanol training);
  * what recording leaves: ``mesh.collective`` spans that synchronize
    nothing, the span ``matvec.otf`` and counter ``matvec.otf_tiles`` on
    the OTF route only, and the sharded apply's span ``precon.apply``;
  * the Nystrom builds' host LAPACK on rank 0 alone.

The data: calibrated synthetic ethanol (P = 6) at N = 16 training points,
k = 96 Nystrom columns of n = 432, sigma = 10, lambda = 1e-10, tol 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmark import reference  # noqa: E402

from .torch_dist_worker import run_group  # noqa: E402
from .torch_threads import one_torch_thread  # noqa: E402,F401

WORLD = 4
N_TRAIN = 16          # 4 rows a rank
N_SAMPLES = 76
K_COLUMNS = 96
SIG = 10.0
LAM = 1e-10           # the Trainer's CG ridge
TOL = 1e-4
MATVEC_RTOL = 1e-12
# the limits of the row-sharded ethanol training (and of the one-card one)
LIMITS = {"desc_err": 1e-11, "w_err": 3e-11, "resid": 1.05e-4}


@pytest.fixture(scope="module")
def inputs():
    from mlff_tpu_torch.data.synthetic import make_benchmark_dataset
    from mlff_tpu_torch.models.task import create_task

    ds, perms = make_benchmark_dataset("ethanol", N_SAMPLES, n_train=N_TRAIN)
    task = create_task(ds, N_TRAIN, sig=SIG, solver="cg", solver_tol=TOL,
                       perms=perms)
    task.update(apply_impl="xla", matvec_dtype="float64")
    R = np.asarray(task["R_train"])
    v = np.random.default_rng(19).normal(size=R.size)
    return dict(task=task, R=R, F=np.asarray(task["F_train"]),
                perms=np.asarray(perms), v=v)


@pytest.fixture(scope="module")
def ranks(inputs):
    return run_group(WORLD, [
        ("otf_matvec", dict(R=inputs["R"], perms=inputs["perms"],
                            v=inputs["v"], sig=SIG, lam=LAM)),
        ("train_otf", dict(task=inputs["task"], n_columns=K_COLUMNS,
                           str_preconditioner="lev_random"))])


def judge(inputs, m) -> dict:
    """The benchmark's checks of a trained model against the reference."""
    R = inputs["R"]
    y = inputs["F"].ravel() / np.std(inputs["F"])
    aF = np.asarray(m["alphas_F"], dtype=np.float64)
    X_ref = reference.model_arrays(R, np.zeros_like(R))[0]
    _, w_ref = reference.model_arrays(R, aF.reshape(R.shape))
    _, K_a = reference.Model(R, aF.reshape(R.shape), inputs["perms"],
                             SIG).predict(R)

    def rel(got, want):
        return float(np.abs(np.asarray(got) - want).max() /
                     np.abs(want).max())

    r = K_a.ravel() - LAM * aF - y
    return {"desc_err": rel(m["R_desc"], X_ref),
            "w_err": rel(m["R_d_desc_alpha"], w_ref),
            "resid": float(np.linalg.norm(r) / np.linalg.norm(y))}


def test_rows_divide_over_the_ranks(inputs):
    assert inputs["R"].shape[0] == N_TRAIN and N_TRAIN % WORLD == 0
    assert len(inputs["perms"]) == 6


@pytest.mark.parametrize("rank", range(WORLD))
def test_sharded_otf_matvec_matches_the_reference(ranks, inputs, rank):
    R, v = inputs["R"], inputs["v"]
    Kv = -reference.Model(R, v.reshape(R.shape), inputs["perms"],
                          SIG).predict(R)[1].ravel()
    for route in ("otf", "cached"):
        got = ranks[rank]["otf_matvec"][route]["matvec"] - LAM * v
        err = np.abs(got - Kv).max() / np.abs(Kv).max()
        assert err <= MATVEC_RTOL, (route, err)


@pytest.mark.parametrize("rank", range(WORLD))
def test_otf_training_on_four_ranks_meets_the_cell_s_limits(ranks, inputs,
                                                            rank):
    m = ranks[rank]["train_otf"]
    assert bool(m["is_conv"])
    assert m["otf_spans"] > 0 and m["otf_tiles"] >= m["otf_spans"]
    checks = judge(inputs, m)
    over = {k: v for k, v in checks.items() if not v <= LIMITS[k]}
    assert not over, checks
    # every rank returns the same model
    assert np.array_equal(m["alphas_F"], ranks[0]["train_otf"]["alphas_F"])


def test_sharded_apply_is_a_span_holding_its_all_reduce(ranks):
    """Every apply of the sharded solve is a span ``precon.apply`` holding
    one collective (the all-reduce of B^T v)."""
    for r in ranks:
        m = r["train_otf"]
        assert m["apply_spans"] > m["solver_iters"]
        assert m["apply_collectives"] == m["apply_spans"]


def test_rank0_alone_runs_the_host_factorizations(ranks):
    """Each Nystrom build (the leverage scores' and the preconditioner's)
    factors W1 and W2 in host LAPACK on rank 0 alone, which broadcasts
    them; the other ranks compute none."""
    assert ranks[0]["train_otf"]["host_factors"] == 2 * [
        "_host_whiten_factor", "_host_inner_isqrt"]
    for r in ranks[1:]:
        assert r["train_otf"]["host_factors"] == []


@pytest.mark.parametrize("route", ["otf", "cached"])
def test_recording_spans_and_counts_by_route(ranks, route):
    """One matvec per route, recorded: its one all-gather is a span that
    synchronizes nothing; the tile loop is a span ``matvec.otf`` and its
    tiles are counted on the OTF route alone."""
    for r in ranks:
        got = r["otf_matvec"]
        assert got["synced"] == []
        row = got[route]
        assert row["collective_spans"] == row["collectives"] == 1
        if route == "otf":
            # 16 rows over 4 ranks: one tile of 4 rows
            assert (row["otf_spans"], row["otf_tiles"]) == (1, 1)
        else:
            assert (row["otf_spans"], row["otf_tiles"]) == (0, 0)
