"""The port's reduced-precision matvecs (``matvec_dtype="float32"`` on a
``downcast_cache`` copy, ``"mixed"``: centred split f32 products with f64
chunk sums) against the f64 operator and the JAX package's: the
counterparts of ``tests/test_mixed_matvec.py``, with its thresholds.

Against f64: the f32 matvec within 1e-5 relative, the mixed one within
3e-7 (inside the 1e-7 noise knee that file measured, with its margin),
cached and on the fly.  Against the JAX package: the mixed matvecs of both
packages are the same sums of f32 products in another order, 5e-8 apart at
most (each is ~1.6e-7 from f64 here); the f32 ones differ by the JAX
package's promotion (its cached f32 matvec rounds its cotangents to f32 as
the port does; its on-the-fly one keeps them f64), so they are held to the
f64 threshold only.  Trainings with either option converge with a true f64
residual at the tolerance: residual replacement keeps the solve honest.
The n = 15,741 honesty test is ``slow``, as the JAX package's is.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mlff_tpu.data.synthetic import make_benchmark_dataset  # noqa: E402
from mlff_tpu.models.gdml import Trainer as JaxTrainer  # noqa: E402
from mlff_tpu.models.task import create_task  # noqa: E402
from mlff_tpu.ops import kernel as jk  # noqa: E402
from mlff_tpu_torch.convert import kernel_cache_from_numpy  # noqa: E402
from mlff_tpu_torch.models.gdml import Trainer  # noqa: E402
from mlff_tpu_torch.ops import kernel as tk  # noqa: E402

from .torch_threads import one_torch_thread  # noqa: E402,F401

MIXED_JAX_RTOL = 5e-8


def _task(n_train=40):
    ds, perms = make_benchmark_dataset("ethanol", n_train + 20)
    return create_task(ds, n_train, ds, n_valid=10, sig=10.0, solver="cg",
                       perms=perms)


def _caches(task, pairwise=True):
    spec, S, X, Jc, P_idx = JaxTrainer().build_kernel_inputs(task)
    cj = jk.build_cache(X, Jc, S, P_idx, 10.0, 1e-10, pairwise=pairwise)
    ct = kernel_cache_from_numpy(
        {k: (None if getattr(cj, k) is None else np.asarray(getattr(cj, k)))
         for k in ("X", "Jc", "S", "P_idx", "Xq", "Xqt", "A_exp", "A_exp1",
                   "sig", "lam")}, device="cpu")
    return cj, ct


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def task():
    return _task()


def test_downcast_cache_matvec_close(task):
    cj, ct = _caches(task)
    lo = tk.downcast_cache(ct)
    assert lo.Xqt.dtype == lo.A_exp.dtype == torch.float32
    assert lo.Jc.dtype == torch.float64 and isinstance(lo.lam, float)
    assert ct.Xqt.dtype == torch.float64          # the f64 cache is kept
    v = np.random.default_rng(0).normal(size=ct.n)
    hi = tk.matvec_psd(ct, torch.as_tensor(v)).numpy()
    out = tk.matvec_psd(lo, torch.as_tensor(v))
    assert out.dtype == torch.float64
    assert _rel(out.numpy(), hi) < 1e-5
    lo_j = np.asarray(jk.matvec_psd(jk.downcast_cache(cj), jnp.asarray(v)))
    assert _rel(lo_j, hi) < 1e-5


@pytest.mark.parametrize("pairwise", [True, False], ids=["cached", "otf"])
def test_mixed_chunkacc_matvec_close(task, pairwise):
    """The centred, chunk-accumulated mixed matvec inside the noise knee
    (~sqrt(chunk) * 2^-24 by construction), cached and on the fly, and
    next to the JAX package's."""
    cj, ct = _caches(task, pairwise)
    _, ct64 = _caches(task)
    rng = np.random.default_rng(1 if pairwise else 5)
    worst = worst_j = 0.0
    for _ in range(3 if pairwise else 1):
        v = rng.normal(size=ct.n)
        hi = tk.matvec_psd(ct64, torch.as_tensor(v)).numpy()
        mx = tk.matvec_psd_mixed(ct, torch.as_tensor(v)).numpy()
        mx_j = np.asarray(jk.matvec_psd_mixed(cj, jnp.asarray(v)))
        worst = max(worst, _rel(mx, hi))
        worst_j = max(worst_j, _rel(mx, mx_j))
    assert worst < 3e-7, worst
    assert worst_j < MIXED_JAX_RTOL, worst_j


def test_f32_otf_matvec_close(task):
    """The f32 matvec on an on-the-fly cache (distances and weights in f32
    per row tile): within the f32 threshold of the f64 operator."""
    _, ct = _caches(task, pairwise=False)
    _, ct64 = _caches(task)
    v = np.random.default_rng(2).normal(size=ct.n)
    hi = tk.matvec_psd(ct64, torch.as_tensor(v)).numpy()
    lo = tk.matvec_psd(tk.downcast_cache(ct), torch.as_tensor(v)).numpy()
    assert _rel(lo, hi) < 1e-5


@pytest.fixture(scope="module")
def trainings(task):
    kw = dict(break_percentage=0.1, str_preconditioner="lev_random")
    return {dt: Trainer(device="cpu").train(dict(task, matvec_dtype=dt), **kw)
            for dt in ("float32", "mixed")}


def _true_resid(task, model) -> float:
    _, ct = _caches(task)
    ct.lam = float(model["lam"])
    y, _, _ = JaxTrainer().labels(task)
    x = torch.as_tensor(-np.asarray(model["alphas_F"]).ravel())
    return float(np.linalg.norm(tk.matvec_psd(ct, x).numpy() - y)
                 / np.linalg.norm(y))


@pytest.mark.parametrize("matvec_dtype", ["float32", "mixed"])
def test_reduced_precision_solve_is_honest(task, trainings, matvec_dtype):
    """A reduced-precision solve converges, and its iterate satisfies the
    f64 system at the tolerance (without residual replacement the recursive
    residual drifts and reports 1e-4 where the true one sits at 1e-2).
    Iteration parity is not gated: this tiny calibrated system amplifies
    even knee-level matvec noise several-fold (tests/test_mixed_matvec.py)."""
    m = trainings[matvec_dtype]
    assert m["is_conv"]
    assert _true_resid(task, m) <= 1.3e-4


@pytest.mark.slow
def test_mixed_chunkacc_honest_at_15k():
    """At n = 15,741 (sig 10, lev_random, k/n = 0.105), where the spectrum
    reaches the ridge floor, the mixed solve must stay honest, not fast:
    within a budget of 3x the f64 iterations it terminates, and if it
    reports convergence the true f64 residual is at the tolerance."""
    ds, perms = make_benchmark_dataset("ethanol", 583 + 60)
    task = create_task(ds, 583, ds, n_valid=40, sig=10.0, solver="cg",
                       perms=perms)
    kw = dict(break_percentage=0.105, str_preconditioner="lev_random")
    m64 = Trainer(device="cpu").train(task, **kw)
    assert m64["is_conv"]
    taskmx = dict(task, matvec_dtype="mixed",
                  solver_maxiter=int(3 * int(m64["solver_iters"])))
    mmx = Trainer(device="cpu").train(taskmx, **kw)
    if mmx["is_conv"]:
        assert _true_resid(task, mmx) <= 1.3e-4


def test_float32_constrained_matvec(task):
    """With energy constraints "float32" runs the constrained matvec on the
    f32 copy (both packages), within the f32 threshold of the f64 one;
    "mixed" and "ozaki" take the f64 matvec, the JAX package's rule."""
    from mlff_tpu_torch.solvers import iterative as tit

    cj, ct = _caches(task)
    v = np.random.default_rng(3).normal(size=ct.n + ct.n_train)
    hi = tk.matvec_psd_ecstr(ct, torch.as_tensor(v)).numpy()
    lo = tk.matvec_psd_ecstr(tk.downcast_cache(ct), torch.as_tensor(v))
    assert lo.dtype == torch.float64 and _rel(lo.numpy(), hi) < 1e-5
    lo_j = np.asarray(jk.matvec_psd_ecstr(jk.downcast_cache(cj),
                                          jnp.asarray(v)))
    assert _rel(lo_j, hi) < 1e-5
    for dtype in ("mixed", "ozaki"):
        mv, exact = tit._matvec_for({"matvec_dtype": dtype}, ct, True)
        assert exact is None
        np.testing.assert_array_equal(mv(torch.as_tensor(v)).numpy(), hi)
