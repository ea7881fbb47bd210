"""The port on the card: the fused kernel against its plain version, the
fast Predictor against the f64 one on a small model, the df64 GEMV kernels
against their plain versions and the f64 product, and a small
``apply_impl="df64"`` training on the card against the same on the CPU.

These tests need an NVIDIA GPU and skip without one.  The file imports
nothing of JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The fused contraction is f64 on both sides.  On random cotangents 1e-10
relative covers the summation order.  On a trained model the contraction's
terms cancel by ~1e6, so the fast and the f64 Predictor are held to 1e-8
relative, and energies on the scale of the contraction's output before the
integration constant c is added.  The df64 passes are held to 3e-12
relative, the tolerance of ``tests/test_df64.py``; the df64 training, like
``chip_smoke.py``'s reference phase, to +-2 iterations and 1e-4 * max|F|.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mlff_tpu_torch.data.synthetic import (  # noqa: E402
    benchmark_perms, make_benchmark_dataset, make_dataset)
from mlff_tpu_torch.models.gdml import Trainer  # noqa: E402
from mlff_tpu_torch.models.predict import Predictor  # noqa: E402
from mlff_tpu_torch.models.task import create_task  # noqa: E402
from mlff_tpu_torch.ops import descriptor as dsc  # noqa: E402
from mlff_tpu_torch.ops import df64  # noqa: E402
from mlff_tpu_torch.ops import df64_gemv  # noqa: E402
from mlff_tpu_torch.ops import fused_predict as fp  # noqa: E402
from mlff_tpu_torch.ops import kernel as knl  # noqa: E402

SIG = 10.0
RTOL, MODEL_RTOL = 1e-10, 1e-8
DF64_RTOL, SOLVE_TOL = 3e-12, 1e-4

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def small():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernel runs on the card")
    ds, perms = make_benchmark_dataset("ethanol", n_samples=70, seed=11,
                                       n_train=30)
    return ds, perms


def _rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("B", [1, 7, 40])
def test_kernel_matches_plain_version(small, B):
    ds, perms = small
    spec = dsc.make_spec(9)
    P_idx = torch.as_tensor(dsc.desc_perms(perms), device="cuda")
    X, _ = dsc.descriptors_from_R(spec, torch.as_tensor(ds["R"], device="cuda"))
    q = knl.SQRT5 / SIG
    Xqt = knl.permuted_descriptors(q * X[:30], P_idx)
    w = torch.as_tensor(np.random.default_rng(1).normal(size=(30, spec.dim)),
                        device="cuda")
    args = ((q * X[30:30 + B]).contiguous(), Xqt, knl.perm_expand_w(w, P_idx))
    before = fp.desc_forces_fused.launches
    F_k, E_k = fp.desc_forces_fused(*args, SIG)
    F_r, E_r = fp.desc_forces_fused_ref(*args, SIG)
    torch.cuda.synchronize()
    assert fp.desc_forces_fused.launches == before + 1
    assert _rel_err(F_k, F_r) <= RTOL and _rel_err(E_k, E_r) <= RTOL


def test_fast_predictor_matches_f64_predictor(small):
    ds, perms = small
    task = create_task(ds, 30, ds, n_valid=5, sig=SIG, solver="cg",
                       perms=perms)
    model = Trainer().train(task, n_columns=200,
                            str_preconditioner="lev_random")
    held = np.setdiff1d(np.arange(70), task["idxs_train"])
    before = fp.desc_forces_fused.launches
    E_f, F_f = Predictor(model, fast=True).predict(ds["R"][held])
    assert fp.desc_forces_fused.launches > before
    E_x, F_x = Predictor(model).predict(ds["R"][held])
    assert np.abs(F_f - F_x).max() <= MODEL_RTOL * np.abs(F_x).max()
    assert np.abs(E_f - E_x).max() <= \
        MODEL_RTOL * np.abs(E_x - model["c"]).max()


@pytest.mark.parametrize("shape", [(700, 150), (1024, 512), (4099, 1030),
                                   (257, 4)])
@pytest.mark.parametrize("kernel", ["bt_v", "b_x"])
def test_df64_kernel_matches_plain_version_and_f64(small, kernel, shape):
    n, m = shape
    rng = np.random.default_rng(n + m)
    B = torch.as_tensor(rng.standard_normal((n, m)) / np.sqrt(n),
                        device="cuda")
    Bh, Bl = df64.split_f64(B)
    if kernel == "bt_v":
        vec = torch.as_tensor(rng.standard_normal(n), device="cuda")
        want = B.T @ vec
    else:
        vec = torch.as_tensor(rng.standard_normal(m), device="cuda")
        want = B @ vec
    wrapper = getattr(df64_gemv, f"df64_{kernel}")
    plain = getattr(df64_gemv, f"df64_{kernel}_ref")
    before = wrapper.launches
    got = wrapper(Bh, Bl, vec)
    ref = plain(Bh, Bl, vec)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert _rel_err(got, ref) <= DF64_RTOL
    assert _rel_err(got, want) <= DF64_RTOL


@pytest.mark.parametrize("kernel", ["bt_v", "b_x"])
def test_df64_kernel_holds_its_error_where_the_sum_cancels(small, kernel):
    """Columns (rows for b_x) of B that sum to ~0 against a vector of ones:
    the result is ~1e-8 of the sum of magnitudes, and the error is held to
    3e-12 of that sum, sum_i |b_i| |v_i|, as for any compensated dot."""
    n, m = (4099, 1030) if kernel == "bt_v" else (1030, 4096)
    rng = np.random.default_rng(7)
    B = rng.standard_normal((n, m))
    axis = 0 if kernel == "bt_v" else 1
    B -= B.mean(axis=axis, keepdims=True)
    B += 1e-8 * rng.standard_normal(B.shape)
    B = torch.as_tensor(B, device="cuda")
    Bh, Bl = df64.split_f64(B)
    vec = torch.ones(B.shape[axis], dtype=torch.float64, device="cuda")
    want = B.T @ vec if kernel == "bt_v" else B @ vec
    scale = (B.abs().T @ vec if kernel == "bt_v" else B.abs() @ vec).max()
    assert float(want.abs().max()) < 1e-5 * float(scale)
    got = getattr(df64_gemv, f"df64_{kernel}")(Bh, Bl, vec)
    ref = getattr(df64_gemv, f"df64_{kernel}_ref")(Bh, Bl, vec)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= DF64_RTOL * float(scale)
    assert float((got - ref).abs().max()) <= DF64_RTOL * float(scale)


@pytest.mark.parametrize("shape", [(31482, 1536), (4099, 1030)])
def test_df64_bt_v_gives_the_same_bits_twice(small, shape):
    """The slabs' partials are added in a fixed tree by whichever block
    finishes last: the order of finishing must not show in the result."""
    n, m = shape
    gen = torch.Generator(device="cuda").manual_seed(5)
    B = torch.randn((n, m), generator=gen, dtype=torch.float64, device="cuda")
    Bh, Bl = df64.split_f64(B)
    v = torch.randn(n, generator=gen, dtype=torch.float64, device="cuda")
    first = df64_gemv.df64_bt_v(Bh, Bl, v)
    for _ in range(3):
        assert torch.equal(df64_gemv.df64_bt_v(Bh, Bl, v), first)


def test_df64_training_on_card_matches_cpu(small):
    """On the well-conditioned plain kernel, as chip_smoke.py's reference
    phase: the card's and the CPU's reduction orders differ, which on the
    calibrated kernel moves two solves ~1e-4 * max|F| apart inside the
    same residual ball."""
    ds = make_dataset("ethanol", n_samples=40, seed=3)
    ds["z"] = np.asarray([6, 6, 8, 1, 1, 1, 1, 1, 1])
    task = create_task(ds, 30, ds, n_valid=5, sig=SIG, solver="cg",
                       perms=benchmark_perms("ethanol"))
    task["apply_impl"] = "df64"
    held = np.setdiff1d(np.arange(40), task["idxs_train"])
    kw = dict(n_columns=200, str_preconditioner="lev_random")
    before = (df64_gemv.df64_bt_v.launches, df64_gemv.df64_b_x.launches)
    m_gpu = Trainer().train(task, **kw)
    assert df64_gemv.df64_bt_v.launches > before[0]
    assert df64_gemv.df64_b_x.launches > before[1]
    m_cpu = Trainer(device="cpu").train(task, **kw)
    assert m_gpu["is_conv"] and m_cpu["is_conv"]
    assert abs(int(m_gpu["solver_iters"]) - int(m_cpu["solver_iters"])) <= 2
    F_g = Predictor(m_gpu).predict(ds["R"][held])[1]
    F_c = Predictor(m_cpu, device="cpu").predict(ds["R"][held])[1]
    assert np.abs(F_g - F_c).max() <= SOLVE_TOL * np.abs(F_c).max()
