"""The port on the card: the fused kernel against its plain version, and the
fast Predictor against the f64 one, on a small model.

These tests need an NVIDIA GPU and skip without one.  The file imports
nothing of JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Both sides are f64.  On random cotangents 1e-10 relative covers the
summation order.  On a trained model the contraction's terms cancel by
~1e6, so the fast and the f64 Predictor are held to 1e-8 relative, and
energies on the scale of the contraction's output before the integration
constant c is added.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mlff_tpu_torch.data.synthetic import make_benchmark_dataset  # noqa: E402
from mlff_tpu_torch.models.gdml import Trainer  # noqa: E402
from mlff_tpu_torch.models.predict import Predictor  # noqa: E402
from mlff_tpu_torch.models.task import create_task  # noqa: E402
from mlff_tpu_torch.ops import descriptor as dsc  # noqa: E402
from mlff_tpu_torch.ops import fused_predict as fp  # noqa: E402
from mlff_tpu_torch.ops import kernel as knl  # noqa: E402

SIG = 10.0
RTOL, MODEL_RTOL = 1e-10, 1e-8

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
