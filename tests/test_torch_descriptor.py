"""The port's descriptors and Jacobian contractions against the JAX package.

Same geometries (numpy, from a seed) through ``mlff_tpu.ops.descriptor`` and
``mlff_tpu_torch.ops.descriptor``.  Both packages evaluate the same f64
formulas in the same order up to summation order, so they agree to ~1e-12
relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mlff_tpu.data.synthetic import benchmark_perms, make_benchmark_dataset  # noqa: E402
from mlff_tpu.ops import descriptor as jd  # noqa: E402
from mlff_tpu_torch.ops import descriptor as td  # noqa: E402

RTOL = 1e-12  # f64 against f64, summation order only


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def geoms():
    ds, _ = make_benchmark_dataset("ethanol", n_samples=24, seed=5,
                                   n_train=20)
    return ds["R"]


# name -> (lat_and_inv as numpy or None, interact_cut_off)
_LAT = np.diag([6.0, 7.0, 8.0]) + 0.3 * np.eye(3)[[1, 2, 0]]
CASES = {
    "plain": (None, None),
    "periodic": ((_LAT, np.linalg.inv(_LAT)), None),
    "cutoff": (None, 2.5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_descriptors_and_jacobians_match_jax(geoms, case):
    lat, cut = CASES[case]
    spec_j, spec_t = jd.make_spec(9), td.make_spec(9)
    lat_j = None if lat is None else tuple(jnp.asarray(a) for a in lat)
    lat_t = None if lat is None else tuple(torch.as_tensor(a) for a in lat)
    X_j, Jc_j = jd.descriptors_from_R(spec_j, jnp.asarray(geoms),
                                      lat_and_inv=lat_j, interact_cut_off=cut)
    X_t, Jc_t = td.descriptors_from_R(spec_t, torch.as_tensor(geoms),
                                      lat_and_inv=lat_t, interact_cut_off=cut)
    assert X_t.dtype == torch.float64 and X_t.shape == X_j.shape
    assert Jc_t.shape == Jc_j.shape
    assert _rel(X_t.numpy(), X_j) < RTOL
    assert _rel(Jc_t.numpy(), Jc_j) < RTOL


def test_jacobian_contractions_match_jax(geoms):
    spec_j, spec_t = jd.make_spec(9), td.make_spec(9)
    S_j, S_t = jd.incidence_matrix(spec_j), td.incidence_matrix(spec_t)
    np.testing.assert_array_equal(S_t.numpy(), np.asarray(S_j))
    _, Jc_j = jd.descriptors_from_R(spec_j, jnp.asarray(geoms))
    _, Jc_t = td.descriptors_from_R(spec_t, torch.as_tensor(geoms))
    rng = np.random.default_rng(0)
    v = rng.normal(size=(len(geoms), 9, 3))
    f = rng.normal(size=(len(geoms), spec_t.dim))
    w_j = jd.d_desc_dot_vec(Jc_j, S_j, jnp.asarray(v))
    w_t = td.d_desc_dot_vec(Jc_t, S_t, torch.as_tensor(v))
    assert _rel(w_t.numpy(), w_j) < RTOL
    g_j = jd.vec_dot_d_desc(Jc_j, S_j, jnp.asarray(f))
    g_t = td.vec_dot_d_desc(Jc_t, S_t, torch.as_tensor(f))
    assert _rel(g_t.numpy(), g_j) < RTOL


def test_desc_perms_match_jax():
    perms = benchmark_perms("ethanol")
    assert perms.shape == (6, 9)
    np.testing.assert_array_equal(td.desc_perms(perms), jd.desc_perms(perms))
