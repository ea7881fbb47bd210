"""The port's kernel operator against the JAX package's.

One small calibrated-ethanol training set (N = 20, the real P = 6
permutation group) goes through ``build_cache``, ``matvec_psd`` and
``assemble_columns`` of both packages.  All of it is f64 on both sides, so
the fields, the matvec and the columns agree to ~1e-12 relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mlff_tpu.data.synthetic import make_benchmark_dataset  # noqa: E402
from mlff_tpu.ops import descriptor as jd  # noqa: E402
from mlff_tpu.ops import kernel as jk  # noqa: E402
from mlff_tpu_torch.convert import kernel_cache_from_numpy  # noqa: E402
from mlff_tpu_torch.ops import descriptor as td  # noqa: E402
from mlff_tpu_torch.ops import kernel as tk  # noqa: E402

RTOL = 1e-12  # f64 against f64, summation order only
SIG, LAM = 10.0, 1e-10


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def caches():
    ds, perms = make_benchmark_dataset("ethanol", n_samples=20, seed=11,
                                       n_train=20)
    R = ds["R"]
    spec_j = jd.make_spec(9)
    X, Jc = jd.descriptors_from_R(spec_j, jnp.asarray(R))
    P = jnp.asarray(jd.desc_perms(perms), dtype=jnp.int32)
    cj = jk.build_cache(X, Jc, jd.incidence_matrix(spec_j), P, SIG, LAM)
    spec_t = td.make_spec(9)
    Xt, Jct = td.descriptors_from_R(spec_t, torch.as_tensor(R))
    ct = tk.build_cache(Xt, Jct, td.incidence_matrix(spec_t),
                        td.desc_perms(perms), SIG, LAM, device="cpu")
    return spec_j, cj, spec_t, ct


# A_exp: the Gram-trick distance of a point to its own identity copy is the
# square root of a rounding residue (~1e-16 |x|^2), so exp(-dist) carries a
# ~1e-8 difference in either package; A_exp1 = A_exp (1 + dist) cancels it
# to first order.
FIELD_RTOL = {"X": RTOL, "Jc": RTOL, "Xq": RTOL, "Xqt": RTOL, "A_exp": 1e-7,
              "A_exp1": RTOL}


@pytest.mark.parametrize("field", sorted(FIELD_RTOL))
def test_build_cache_fields_match_jax(caches, field):
    _, cj, _, ct = caches
    got = getattr(ct, field)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    assert tuple(got.shape) == tuple(getattr(cj, field).shape)
    assert _rel(got.numpy(), getattr(cj, field)) < FIELD_RTOL[field]


def test_matvec_psd_matches_jax(caches):
    _, cj, _, ct = caches
    v = np.random.default_rng(0).normal(size=ct.n)
    got = tk.matvec_psd(ct, torch.as_tensor(v)).numpy()
    assert _rel(got, jk.matvec_psd(cj, jnp.asarray(v))) < RTOL


@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_assemble_columns_matches_jax(caches, kind):
    """A leverage-like sparse set (scattered single partials) and a dense set
    (whole points); both packages send them down different branches by the
    same rule: the grouped column-exact assembly and the chunked point
    blocks (``_point_blocks_chunk``)."""
    spec_j, cj, spec_t, ct = caches
    rng = np.random.default_rng(1)
    if kind == "sparse":
        cols = np.sort(rng.choice(ct.n, 40, replace=False))
    else:
        cols = np.arange(3 * spec_t.dim_i, 7 * spec_t.dim_i)
    got = tk.assemble_columns(spec_t, ct, cols)
    assert tuple(got.shape) == (ct.n, len(cols))
    assert _rel(got.numpy(), jk.assemble_columns(spec_j, cj, cols)) < RTOL


def test_kernel_cache_from_numpy_reproduces_jax_matvec(caches):
    _, cj, _, _ = caches
    fields = {name: np.asarray(getattr(cj, name))
              for name in ("X", "Jc", "S", "P_idx", "Xq", "Xqt", "A_exp",
                           "A_exp1", "sig", "lam")}
    ct = kernel_cache_from_numpy(fields, device="cpu")
    v = np.random.default_rng(2).normal(size=ct.n)
    got = tk.matvec_psd(ct, torch.as_tensor(v)).numpy()
    assert _rel(got, jk.matvec_psd(cj, jnp.asarray(v))) < RTOL


@pytest.mark.parametrize("option", ["pairwise_false", "square_R"])
def test_cache_options_build_what_jax_builds(caches, option):
    """build_cache(pairwise=False) leaves out the (N, M) weights and its
    matvec recomputes them; build_cache(R=...) adds the square all-pairs
    fields.  Both as the JAX package builds them."""
    _, cj, _, ct = caches
    ds, perms = make_benchmark_dataset("ethanol", n_samples=20, seed=11,
                                       n_train=20)
    kw = ({"pairwise": False} if option == "pairwise_false"
          else {"R": ds["R"]})
    got = tk.build_cache(ct.X, ct.Jc, ct.S, ct.P_idx, SIG, LAM, device="cpu",
                         **kw)
    want = jk.build_cache(cj.X, cj.Jc, cj.S, cj.P_idx, SIG, LAM,
                          **{k: jnp.asarray(v) if k == "R" else v
                             for k, v in kw.items()})
    if option == "pairwise_false":
        assert got.A_exp is None and got.A_exp1 is None
        v = np.random.default_rng(3).normal(size=ct.n)
        assert _rel(tk.matvec_psd(got, torch.as_tensor(v)),
                    jk.matvec_psd(want, jnp.asarray(v))) < RTOL
    else:
        for name in ("Xsq", "Gsq", "Usq", "Zsq", "C1sq"):
            assert _rel(getattr(got, name), getattr(want, name)) < RTOL
