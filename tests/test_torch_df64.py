"""The df64 arithmetic (``mlff_tpu_torch.ops.df64``) and the df64 GEMV
passes (``mlff_tpu_torch.ops.df64_gemv``) against the JAX package.

Inputs are made with numpy from seeds and handed to both packages.  The
error-free transformations are exact, so the port's outputs equal the JAX
package's bit for bit and their sums equal the f64 sums and products.  The
compensated dots and the GEMV passes are held to 3e-12 relative to the f64
product, the tolerance of ``tests/test_df64.py``; the JAX Pallas kernels run
in interpret mode, as that file runs them.  On the CPU the wrappers run the
plain versions and launch nothing; the CUDA kernels are compared with the
plain versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mlff_tpu.ops import df64 as jdf  # noqa: E402
from mlff_tpu.ops import pallas_df64 as jpdf  # noqa: E402
from mlff_tpu_torch.ops import df64 as tdf  # noqa: E402
from mlff_tpu_torch.ops import df64_gemv as g  # noqa: E402
from mlff_tpu_torch.utils import trace  # noqa: E402

RTOL = 3e-12   # tests/test_df64.py


def _f32(rng, scale=1.0, n=1000):
    return (rng.standard_normal(n) * scale).astype(np.float32)


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _primitive_args(fn):
    """f32 inputs of each primitive: values spanning ten decades, and
    (hi, lo) pairs with lo ~ 2^-24 hi."""
    rng = np.random.default_rng(1)
    a = _f32(rng)
    b = (rng.standard_normal(1000) * 10.0 ** rng.integers(-7, 3, 1000)
         ).astype(np.float32)
    if fn == "veltkamp_split":
        return (a,)
    if fn == "fast_two_sum":   # needs |a| >= |b|
        big = np.abs(a) >= np.abs(b)
        return np.where(big, a, b), np.where(big, b, a)
    if fn in ("two_sum", "two_prod"):
        return a, b
    return a, _f32(rng, 1e-8), b, _f32(rng, 1e-8) * np.abs(b)


@pytest.mark.parametrize("fn", ["veltkamp_split", "two_sum", "fast_two_sum",
                                "two_prod", "df64_add", "df64_prod"])
def test_primitives_equal_jax_bit_for_bit(fn):
    args = _primitive_args(fn)
    want = getattr(jdf, fn)(*(jnp.asarray(x) for x in args))
    got = getattr(tdf, fn)(*(torch.as_tensor(x) for x in args))
    for gt, wt in zip(got, want):
        assert gt.dtype == torch.float32
        np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))


@pytest.mark.parametrize("op", ["two_sum", "two_prod"])
def test_error_free_transformations_are_exact(op):
    a, b = _primitive_args(op)
    hi, lo = getattr(tdf, op)(torch.as_tensor(a), torch.as_tensor(b))
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    exact = a64 + b64 if op == "two_sum" else a64 * b64
    np.testing.assert_array_equal(
        hi.numpy().astype(np.float64) + lo.numpy().astype(np.float64), exact)


def test_split_join_roundtrip_and_equal_to_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(1000) * 10.0 ** rng.integers(-8, 8, 1000)
    h, lo = tdf.split_f64(torch.as_tensor(x))
    jh, jl = jdf.split_f64(jnp.asarray(x))
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jl))
    rt = tdf.join_f64(h, lo).numpy()
    assert (np.abs(rt - x) / np.abs(x)).max() < 2.0 ** -47


@pytest.mark.parametrize("direction", ["bv", "bx"])
def test_compensated_dot_accuracy(direction):
    rng = np.random.default_rng(0)
    n, m = 20000, 64
    B = rng.standard_normal((n, m)) / np.sqrt(n)
    Bh, Bl = tdf.split_f64(torch.as_tensor(B))
    if direction == "bv":
        v = rng.standard_normal(n)
        got = tdf.join_f64(*tdf.df64_dot_bv(Bh, Bl,
                                            *tdf.split_f64(torch.as_tensor(v))))
        want = B.T @ v
    else:
        x = rng.standard_normal(m)
        got = tdf.join_f64(*tdf.df64_dot_bx(Bh, Bl,
                                            *tdf.split_f64(torch.as_tensor(x))))
        want = B @ x
    assert _rel(got.numpy(), want) < RTOL


@pytest.fixture(scope="module")
def padded():
    """B (1001, 130) f64 inside (1024, 512) zero padding, as the JAX kernels
    take it, split into its f32 pair; v and x padded alike."""
    rng = np.random.default_rng(4)
    n, m, n_pad, m_pad = 1001, 130, 1024, 512
    B = np.zeros((n_pad, m_pad))
    B[:n, :m] = rng.standard_normal((n, m)) / np.sqrt(n)
    v = np.zeros(n_pad)
    v[:n] = rng.standard_normal(n)
    x = np.zeros(m_pad)
    x[:m] = rng.standard_normal(m)
    Bh, Bl = (np.array(a) for a in jdf.split_f64(jnp.asarray(B)))
    return B, Bh, Bl, v, x


@pytest.mark.parametrize("kernel", ["bt_v", "b_x"])
def test_wrapper_on_cpu_matches_pallas_kernel(padded, kernel):
    B, Bh, Bl, v, x = padded
    vec, want = (v, B.T @ v) if kernel == "bt_v" else (x, B @ x)
    jax_fn = jpdf.df64_bt_v if kernel == "bt_v" else jpdf.df64_b_x
    wrapper = getattr(g, f"df64_{kernel}")
    got_jax = np.asarray(jax_fn(jnp.asarray(Bh), jnp.asarray(Bl),
                                jnp.asarray(vec), interpret=True))
    before = trace.counter(g.LAUNCHES[kernel])
    got = wrapper(torch.as_tensor(Bh), torch.as_tensor(Bl),
                  torch.as_tensor(vec))
    assert trace.counter(g.LAUNCHES[kernel]) == before
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert _rel(got.numpy(), want) < RTOL
    assert _rel(got_jax, want) < RTOL
    assert _rel(got.numpy(), got_jax) < RTOL


@pytest.mark.parametrize("bad", ["float64_b", "float32_vector", "strided",
                                 "shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(padded, bad):
    """Wrong types and shapes raise.  A strided B is no longer among them:
    the reference takes any B, and so does the wrapper (on the card the
    kernel gets a contiguous copy), with the plain version's result."""
    _, Bh, Bl, v, _ = padded
    Bh, Bl, v = (torch.as_tensor(a) for a in (Bh, Bl, v))
    if bad == "strided":
        strided = Bl.T.contiguous().T
        assert not strided.is_contiguous()
        assert torch.equal(g.df64_bt_v(Bh, strided, v),
                           g.df64_bt_v_ref(Bh, Bl, v))
        return
    if bad == "float64_b":
        Bh = Bh.double()
    elif bad == "float32_vector":
        v = v.float()
    else:
        v = v[:-1]
    with pytest.raises((TypeError, ValueError)):
        g.df64_bt_v(Bh, Bl, v)


def test_bound_is_the_bytes_of_the_pair_at_the_main_shape():
    """At the main path's factor shape both passes are bound by reading
    the (hi, lo) pair: 8 n m bytes (387 MB) over 3.35 TB/s."""
    t, by = g.bound_seconds(31482, 1536, 67e12, 3.35e12)
    assert by == "bytes"
    assert abs(t - (8 * 31482 * 1536 + 8 * (31482 + 1536)) / 3.35e12) < 1e-12
