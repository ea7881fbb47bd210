"""Four processes on a 2 x 2 ('hosts', 'rows') mesh (``make_host_mesh``,
gloo on the CPU): the counterpart of ``tests/test_multiprocess.py`` and
``tests/dcn_worker.py``, whose two JAX processes of four virtual devices
each flatten their mesh into one 'rows' axis.  The port's row sharding runs
over the flattened mesh the same way.

The sharded matvec must equal each rank's own unsharded oracle to 1e-10;
PCG through the sharded operator (a Nystrom preconditioner of n / 3
random columns, placed on the mesh) must converge within max(5, 15%) of
the unsharded solve's iterations, and its iterate must leave a true
residual <= 1.5e-6 ||v|| through the unsharded operator: the JAX test's
limits.  No JAX here: the worker (``tests/torch_dist_worker.py``) imports
none, and the oracle is the port's own unsharded operator.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from .torch_dist_worker import run_group  # noqa: E402


@pytest.fixture(scope="module")
def ranks():
    rng = np.random.default_rng(0)
    n_atoms, n_train = 4, 16
    R = rng.normal(size=(n_train, n_atoms, 3)) * 1.5
    n = n_train * n_atoms * 3
    v = rng.normal(size=n)
    idxs = np.sort(rng.choice(n, n // 3, replace=False))
    return run_group(4, [("pcg", dict(R=R, v=v, idxs=idxs))],
                     host_mesh=True)


def test_host_mesh_is_two_by_two(ranks):
    for r in ranks:
        assert r["pcg"]["mesh_shape"] == (2, 2)


def test_sharded_matvec_equals_local_oracle(ranks):
    for r in ranks:
        np.testing.assert_allclose(r["pcg"]["matvec"], r["pcg"]["ref"],
                                   rtol=1e-10, atol=1e-12)


def test_pcg_through_sharded_operator_converges(ranks):
    for r in ranks:
        p = r["pcg"]
        assert p["conv"] == (True, True)
        assert abs(p["iters_sh"] - p["iters"]) <= max(5, 0.15 * p["iters"])


def test_sharded_solve_true_residual(ranks):
    for r in ranks:
        assert r["pcg"]["true_resid"] <= 1.5e-6 * r["pcg"]["v_norm"]
