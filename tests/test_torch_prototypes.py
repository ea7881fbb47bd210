"""The port's dense prototypes (``mlff_tpu_torch.experiments.prototypes``)
and ``parallel.distributed.hardware_info``: the counterparts of
``tests/test_prototypes.py``, and each prototype function against
``mlff_tpu.experiments.prototypes`` on the same seeded NumPy inputs at
1e-12 relative (the same dense f64 algorithms, LAPACK's and torch's
rounding apart; 1.6e-13 measured at most).  The GP case uses noise 1e-6
on well-spread points; its posterior variance, 1 minus a quadratic form
within ~1e-4 of 1, loses four digits to that cancellation and is held to
1e-8 of its largest entry (9e-10 measured)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mlff_tpu.experiments import prototypes as jproto  # noqa: E402
from mlff_tpu_torch.experiments import prototypes as proto  # noqa: E402
from .torch_threads import one_torch_thread  # noqa: E402,F401

RTOL = 1e-12


def test_dense_pivoted_cholesky_selftest():
    proto.selftest_pivoted_cholesky(device="cpu")


def test_woodbury_selftest():
    proto.selftest_woodbury(device="cpu")


def test_gp_regression_demo():
    rng = np.random.default_rng(2)
    X = rng.uniform(-3, 3, size=(40, 1))
    y = np.sin(X[:, 0])
    Xq = np.linspace(-2.5, 2.5, 20)[:, None]
    mean, var = proto.gp_regression(X, y, Xq, lengthscale=1.0, noise=1e-8,
                                    device="cpu")
    np.testing.assert_allclose(mean, np.sin(Xq[:, 0]), atol=0.05)
    assert np.all(var >= -1e-10)


def test_condition_number():
    A = np.diag([1.0, 10.0, 100.0])
    assert abs(proto.condition_number(A, device="cpu") - 100.0) < 1e-9


def test_hardware_info():
    from mlff_tpu_torch.parallel.distributed import hardware_info

    info = hardware_info()
    assert "uname" in info and info["torch_version"] == torch.__version__
    assert {"platform", "device_kind", "n_devices", "n_hosts",
            "cuda_version"} <= set(info)
    if not torch.cuda.is_available():
        assert info["platform"] == "cpu" and info["n_hosts"] == 1


def _spd(rng, n, rank=None):
    B = rng.normal(size=(n, rank or n))
    return B @ B.T + (0 if rank else n) * np.eye(n)


def _rel(got, want):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    return np.abs(got - want).max() / np.abs(want).max()


def _case(name, rng):
    """(port result, JAX-module result) pairs of one function."""
    if name == "dense_pivoted_cholesky":
        A = _spd(rng, 30)
        (L, piv), (Lj, pivj) = (proto.dense_pivoted_cholesky(A, 20,
                                                             device="cpu"),
                                jproto.dense_pivoted_cholesky(A, 20))
        np.testing.assert_array_equal(piv, pivj)
        return [(L, Lj)]
    if name == "pivot_transformation":
        M = rng.normal(size=(12, 3))
        piv = rng.permutation(12)[:5]
        return [(proto.pivot_transformation(torch.as_tensor(M), piv, inv),
                 jproto.pivot_transformation(M, piv, inv))
                for inv in (False, True)]
    if name == "init_precond_operator":
        K = _spd(rng, 40, rank=20)
        v = rng.normal(size=40)
        P = proto.init_precond_operator(K, 15, 1e-3, device="cpu")
        return [(P(torch.as_tensor(v)),
                 jproto.init_precond_operator(K, 15, 1e-3).matvec(v))]
    if name == "solve_linear_system_woodbury":
        K = _spd(rng, 50, rank=25)
        y = rng.normal(size=50)
        x, it = proto.solve_linear_system_woodbury(K, y, 20, 1e-3,
                                                   device="cpu")
        xj, itj = jproto.solve_linear_system_woodbury(K, y, 20, 1e-3)
        assert it == itj
        return [(x, xj)]
    if name == "rbf_kernel":
        Xa, Xb = rng.normal(size=(9, 3)), rng.normal(size=(7, 3))
        return [(proto.rbf_kernel(Xa, Xb, 1.3, device="cpu"),
                 jproto.rbf_kernel(Xa, Xb, 1.3))]
    if name == "gp_regression":
        X = np.linspace(-3, 3, 25)[:, None]
        y = np.sin(X[:, 0])
        Xq = np.linspace(-2.5, 2.5, 11)[:, None]
        got = proto.gp_regression(X, y, Xq, 1.0, 1e-6, device="cpu")
        want = jproto.gp_regression(X, y, Xq, 1.0, 1e-6)
        return [(got[0], want[0]), (got[1], want[1], 1e-8)]
    if name == "condition_number":
        K = _spd(rng, 20)
        return [(np.array(proto.condition_number(K, 1e-3, device="cpu")),
                 np.array(jproto.condition_number(K, 1e-3)))]
    raise ValueError(name)


@pytest.mark.parametrize("name", [
    "dense_pivoted_cholesky", "pivot_transformation", "init_precond_operator",
    "solve_linear_system_woodbury", "rbf_kernel", "gp_regression",
    "condition_number"])
def test_matches_jax_module(name):
    for pair in _case(name, np.random.default_rng(7)):
        got, want, tol = (pair + (RTOL,))[:3]
        assert _rel(got, want) <= tol, (name, _rel(got, want))
