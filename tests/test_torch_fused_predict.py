"""The fused prediction contraction (``mlff_tpu_torch.ops.fused_predict``).

On the CPU the wrapper runs the kernel's plain PyTorch version, which is
held here to the JAX package's Pallas kernel (interpret mode) and to its
f64 contraction.  Against the f32 Pallas kernel the tolerances are those of
``tests/test_pallas_predict.py`` (atol 2e-5 * max|F|, rtol 2e-4): the
Pallas side is f32.  Against the f64 contraction the plain version (f64)
agrees to 1e-10 relative, the summation order of products whose terms
cancel by ~1e3.  The CUDA kernel itself is compared with the plain version
on the card (``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mlff_tpu.data.synthetic import benchmark_perms, make_benchmark_dataset  # noqa: E402
from mlff_tpu.ops import descriptor as jd  # noqa: E402
from mlff_tpu.ops import kernel as jk  # noqa: E402
from mlff_tpu.ops.pallas_predict import desc_forces_pallas  # noqa: E402
from mlff_tpu_torch.ops import fused_predict as fp  # noqa: E402

SIG = 10.0
ATOL_REL, RTOL_F32 = 2e-5, 2e-4   # tests/test_pallas_predict.py
RTOL_F64 = 1e-10


@pytest.fixture(scope="module")
def operands():
    """Held-out query descriptors against 30 permuted training points
    (M = 180), random cotangents; f64 numpy."""
    ds, _ = make_benchmark_dataset("ethanol", n_samples=70, seed=11,
                                   n_train=30)
    spec = jd.make_spec(9)
    P_idx = jnp.asarray(jd.desc_perms(benchmark_perms("ethanol")))
    q = jk.SQRT5 / SIG
    X, _ = jd.descriptors_from_R(spec, jnp.asarray(ds["R"][:30]))
    Xq_query, _ = jd.descriptors_from_R(spec, jnp.asarray(ds["R"][30:]))
    Xqt = jk.permuted_descriptors(q * X, P_idx)
    w = np.random.default_rng(1).normal(size=(30, spec.dim))
    wt = jk.perm_expand_w(jnp.asarray(w), P_idx)
    return np.asarray(q * Xq_query), np.asarray(Xqt), np.asarray(wt)


def _torch(*arrays):
    return tuple(torch.as_tensor(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("B", [7, 40])
def test_plain_version_matches_pallas_kernel(operands, B):
    Xq, Xqt, wt = operands
    F_p, E_p = desc_forces_pallas(jnp.asarray(Xq[:B]), jnp.asarray(Xqt),
                                  jnp.asarray(wt), sig=SIG, interpret=True)
    F_t, E_t = fp.desc_forces_fused_ref(*_torch(Xq[:B], Xqt, wt), SIG)
    assert F_t.shape == (B, Xq.shape[1]) and E_t.shape == (B,)
    np.testing.assert_allclose(F_t.numpy(), np.asarray(F_p), rtol=RTOL_F32,
                               atol=ATOL_REL * float(F_t.abs().max()))
    np.testing.assert_allclose(E_t.numpy(), np.asarray(E_p), rtol=RTOL_F32,
                               atol=ATOL_REL * float(E_t.abs().max()))


@pytest.mark.parametrize("B", [7, 40])
def test_plain_version_matches_f64_contraction(operands, B):
    Xq, Xqt, wt = (jnp.asarray(a) for a in operands)
    dist = jk.pairwise_dist_gram(Xq[:B], Xqt)
    A_exp = (5.0 / (3.0 * SIG**2)) * jnp.exp(-dist)
    F_j, E_j = jk._desc_forces_x(Xqt, SIG, Xq[:B], A_exp, A_exp * (1 + dist),
                                 wt)
    F_t, E_t = fp.desc_forces_fused_ref(
        *_torch(operands[0][:B], operands[1], operands[2]), SIG)
    for got, want in ((F_t, F_j), (E_t, E_j)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= RTOL_F64 * np.abs(want).max()


def test_wrapper_on_cpu_runs_plain_version_without_launching(operands):
    args = _torch(operands[0][:7], operands[1], operands[2])
    before = fp.desc_forces_fused.launches
    F_w, E_w = fp.desc_forces_fused(*args, SIG)
    F_r, E_r = fp.desc_forces_fused_ref(*args, SIG)
    assert fp.desc_forces_fused.launches == before
    assert torch.equal(F_w, F_r) and torch.equal(E_w, E_r)


@pytest.mark.parametrize("bad", ["float32", "strided", "shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(operands, bad):
    Xq, Xqt, wt = _torch(operands[0][:7], operands[1], operands[2])
    if bad == "float32":
        Xq = Xq.float()
    elif bad == "strided":
        Xqt = torch.as_tensor(np.asfortranarray(operands[1]))
    else:
        wt = wt[:-1]
    with pytest.raises((TypeError, ValueError)):
        fp.desc_forces_fused(Xq, Xqt, wt, SIG)


def test_split_plan_covers_the_training_axis():
    for B, M in ((512, 6996), (7, 6959), (1, 64), (600, 65)):
        n_split, rows = fp.split_plan(B, M, 132)
        assert rows % fp.TM == 0
        assert (n_split - 1) * rows < M <= n_split * rows
