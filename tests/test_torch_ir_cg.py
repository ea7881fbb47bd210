"""The port's mixed-precision iterative refinement (``solvers/ir_cg.py``)
against the JAX package's: the counterparts of ``tests/test_ir_cg.py``.

The same system in both packages (60 ethanol geometries, sig = 5, a Nystrom
factor of n / 8 random columns, its fused T from
``WoodburySplitPreconditioner.fused_T``).  At lam = 1e-6 refinement
converges within 6 outer steps in both, and the port's solution agrees with
the f64 PCG solution within 2e-4 of its scale (that file's limit).  At the
production lam = 1e-10 the f32 inner solves cannot represent the operator's
small end: both packages stop within 3 outer steps and report no
convergence.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mlff_tpu.data.synthetic import make_dataset  # noqa: E402
from mlff_tpu.ops import descriptor as jd  # noqa: E402
from mlff_tpu.ops import kernel as jk  # noqa: E402
from mlff_tpu.solvers import preconditioners as jpc  # noqa: E402
from mlff_tpu.solvers.ir_cg import ir_pcg_kernel as jax_ir_pcg_kernel  # noqa: E402,E501
from mlff_tpu_torch.ops import descriptor as td  # noqa: E402
from mlff_tpu_torch.ops import kernel as tk  # noqa: E402
from mlff_tpu_torch.solvers import preconditioners as tpc  # noqa: E402
from mlff_tpu_torch.solvers.cg import pcg  # noqa: E402
from mlff_tpu_torch.solvers.ir_cg import ir_pcg_kernel  # noqa: E402

from .torch_threads import one_torch_thread  # noqa: E402,F401

SIG = 5.0


def _problem(lam):
    """The port's and the JAX package's system and preconditioner: the same
    geometries and the same random columns."""
    ds = make_dataset("ethanol", n_samples=60, seed=3)
    y = ds["F"][:60].ravel()
    y = y / y.std()
    perms = np.arange(9)[None, :]
    spec_t = td.make_spec(9)
    X, Jc = td.descriptors_from_R(spec_t, torch.as_tensor(ds["R"][:60]))
    cache = tk.build_cache(X, Jc, td.incidence_matrix(spec_t),
                           td.desc_perms(perms), SIG, lam, device="cpu")
    idx = tpc.select_random(cache.n, cache.n // 8, np.random.default_rng(0))
    P = tpc.nystrom_preconditioner(spec_t, cache, idx, lam)
    spec_j = jd.make_spec(9)
    Xj, Jcj = jd.descriptors_from_R(spec_j, jnp.asarray(ds["R"][:60]))
    cache_j = jk.build_cache(Xj, Jcj, jd.incidence_matrix(spec_j),
                             jnp.asarray(jd.desc_perms(perms)), SIG, lam)
    P_j = jpc.nystrom_preconditioner(spec_j, cache_j, idx, lam)
    return (spec_t, cache, P, torch.as_tensor(y)), (spec_j, cache_j, P_j,
                                                   jnp.asarray(y))


def test_ir_converges_at_moderate_lambda():
    lam = 1e-6
    (spec, cache, P, b), (spec_j, cache_j, P_j, b_j) = _problem(lam)
    kw = dict(tol=1e-4, inner_tol=1e-2, inner_maxiter=300)
    res = ir_pcg_kernel(spec, cache, b, P.fused_T(), lam, **kw)
    res_j = jax_ir_pcg_kernel(spec_j, cache_j, b_j, P_j.fused_T(), lam, **kw)
    assert res.converged and res_j.converged
    assert res.outer_iters <= 6 and res_j.outer_iters <= 6
    res64 = pcg(lambda v: tk.matvec_psd(cache, v), b, precon=P, tol=1e-6,
                maxiter=3000)
    scale = np.abs(res64.x).max()
    np.testing.assert_allclose(res.x, res64.x, atol=2e-4 * scale)
    np.testing.assert_allclose(res.x, res_j.x, atol=2e-4 * scale)


def test_ir_detects_f32_floor_at_production_lambda():
    lam = 1e-10
    (spec, cache, P, b), (spec_j, cache_j, P_j, b_j) = _problem(lam)
    kw = dict(tol=1e-4, inner_tol=1e-2, inner_maxiter=100, max_outer=3)
    res = ir_pcg_kernel(spec, cache, b, P.fused_T(), lam, **kw)
    res_j = jax_ir_pcg_kernel(spec_j, cache_j, b_j, P_j.fused_T(), lam, **kw)
    assert not res.converged and not res_j.converged
    assert res.outer_iters <= 3 and res_j.outer_iters <= 3
