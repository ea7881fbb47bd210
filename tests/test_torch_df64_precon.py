"""The df64 Woodbury preconditioner, the column-blocked Nyström factor and
training with ``apply_impl="df64"``: the port on the CPU against the JAX
package.

Factors the JAX package built are handed to the port through
``mlff_tpu_torch.convert``, so both sides apply the same operator; inputs
are made with numpy from seeds.  Tolerances are those of
``tests/test_df64.py``: the df64 apply agrees with the f64 apply to 1e-11
relative (the 2^-48 words of B, fresh rounding per apply), the three words
of B reconstruct it below 2^-68, and the column-blocked route to 5e-11.
The column-blocked factor is f64 on both sides; on the calibrated kernel at
lam = 1e-10 its blocks, W2 and apply agree to ~1e-12, held here to 5e-11.
Trainings follow ``tests/test_torch_train_e2e.py``: the same inducing
columns, iterations within +-2, held-out forces within 1e-4 * max|F|.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mlff_tpu.data.synthetic import (  # noqa: E402
    benchmark_perms, make_benchmark_dataset, make_dataset)
from mlff_tpu.models.gdml import Trainer as JaxTrainer  # noqa: E402
from mlff_tpu.models.predict import Predictor as JaxPredictor  # noqa: E402
from mlff_tpu.models.task import create_task  # noqa: E402
from mlff_tpu.ops import descriptor as jd  # noqa: E402
from mlff_tpu.ops import kernel as jk  # noqa: E402
from mlff_tpu.solvers import preconditioners as jpc  # noqa: E402
from mlff_tpu_torch import convert  # noqa: E402
from mlff_tpu_torch.models.gdml import Trainer  # noqa: E402
from mlff_tpu_torch.models.predict import Predictor  # noqa: E402
from mlff_tpu_torch.ops import descriptor as td  # noqa: E402
from mlff_tpu_torch.ops import df64_gemv as g  # noqa: E402
from mlff_tpu_torch.solvers import preconditioners as tpc  # noqa: E402

LAM, SIG = 1e-10, 10.0
APPLY_RTOL, COLBLOCK_RTOL = 1e-11, 5e-11
N_TRAIN, N_SAMPLES, N_COLUMNS, SOLVE_TOL = 30, 40, 200, 1e-4


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _np(a):
    return None if a is None else np.array(a)


@pytest.fixture(scope="module")
def factor():
    """A JAX split Woodbury factor of a random (700, 150) L at lam = 1e-10,
    as in tests/test_df64.py, and a right-hand side."""
    rng = np.random.default_rng(0)
    L = rng.standard_normal((700, 150)) / np.sqrt(700)
    return L, rng.standard_normal(700)


@pytest.mark.parametrize("components", [2, 3])
def test_df64_apply_matches_jax(factor, components):
    L, v = factor
    P = jpc.woodbury_from_factor(jnp.asarray(L), LAM)
    z_split = np.asarray(jpc.woodbury_split_apply(P, jnp.asarray(v)))
    Pj = jpc.df64_from_split(P, components=components)
    z_jax = np.asarray(jpc.df64_woodbury_apply(Pj, jnp.asarray(v)))
    Pt = convert.df64_preconditioner_from_numpy(
        _np(Pj.Bh), _np(Pj.Bl), _np(Pj.W2), LAM, Bm=_np(Pj.Bm), device="cpu")
    before = (g.df64_bt_v.launches, g.df64_b_x.launches)
    z = Pt(torch.as_tensor(v)).numpy()
    assert (g.df64_bt_v.launches, g.df64_b_x.launches) == before
    assert z.shape == v.shape
    assert _rel(z, z_jax) < APPLY_RTOL
    assert _rel(z, z_split) < APPLY_RTOL


@pytest.mark.parametrize("components", [2, 3])
def test_df64_from_split_matches_split_apply(factor, components):
    """The port's own conversion: its words equal the JAX package's
    (unpadded), three words reconstruct B below 2^-68, and the apply
    matches the f64 split apply it came from."""
    L, v = factor
    P = jpc.woodbury_from_factor(jnp.asarray(L), LAM)
    B, W2 = np.array(P.B), np.array(P.W2)
    words_jax = jpc._split_pad_b(jnp.asarray(B), *B.shape, components)
    P_split = convert.split_preconditioner_from_numpy(B, W2, LAM,
                                                      device="cpu")
    z_split = P_split(torch.as_tensor(v)).numpy()
    Pt = tpc.df64_from_split(P_split, components=components)
    assert P_split.B is None
    assert Pt.info["components"] == components
    for got, want in zip((Pt.Bh, Pt.Bl, Pt.Bm), words_jax):
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if components == 3:
        recon = sum(w.numpy().astype(np.float64) for w in (Pt.Bh, Pt.Bl, Pt.Bm))
        assert _rel(recon, B) < 2.0 ** -68
    assert _rel(Pt(torch.as_tensor(v)).numpy(), z_split) < APPLY_RTOL


@pytest.fixture(scope="module")
def colblock():
    """Calibrated ethanol (n = 432) kernel cache built by the JAX package
    and carried to the port; 60 random columns in blocks of 25."""
    ds, perms = make_benchmark_dataset("ethanol", n_samples=16, seed=11,
                                       n_train=16)
    spec_j = jd.make_spec(9)
    X, Jc = jd.descriptors_from_R(spec_j, jnp.asarray(ds["R"]))
    cj = jk.build_cache(X, Jc, jd.incidence_matrix(spec_j),
                        jnp.asarray(jd.desc_perms(perms), dtype=jnp.int32),
                        SIG, LAM)
    ct = convert.kernel_cache_from_numpy(
        {k: np.asarray(getattr(cj, k)) for k in (
            "X", "Jc", "S", "P_idx", "Xq", "Xqt", "A_exp", "A_exp1", "sig",
            "lam")}, device="cpu")
    idx = np.sort(np.random.default_rng(5).choice(ct.n, 60, replace=False))
    Bs_j, W2_j = jpc._nystrom_factor_split_colblocked(
        spec_j, cj, idx, LAM, 1e-10, 25)
    Bs_t, W2_t, info = tpc._nystrom_factor_split_colblocked(
        td.make_spec(9), ct, idx, LAM, 1e-10, 25)
    v = np.random.default_rng(1).standard_normal(ct.n)
    return Bs_j, W2_j, Bs_t, W2_t, info, v


def test_colblock_factor_matches_jax(colblock):
    Bs_j, W2_j, Bs_t, W2_t, info, _ = colblock
    assert [B.shape[1] for B in Bs_t] == [25, 25, 10]
    assert info["n_blocks"] == 3 and not info["gram_guard_fired"]
    for Bt, Bj in zip(Bs_t, Bs_j):
        assert _rel(Bt.numpy(), np.asarray(Bj)) < COLBLOCK_RTOL
    assert _rel(W2_t.numpy(), np.asarray(W2_j)) < COLBLOCK_RTOL


@pytest.mark.parametrize("apply_impl", ["xla", "df64"])
def test_colblock_apply_matches_jax(colblock, apply_impl):
    """The padded blocks applied as blocks ('xla') and as one 2-component
    df64 factor, each against the JAX package's counterpart."""
    Bs_j, W2_j, Bs_t, W2_t, _, v = colblock
    Bs_jp, W2_jp = jpc._pad_colblocks(Bs_j, W2_j)
    Bs_tp, W2_tp = tpc._pad_colblocks(Bs_t, W2_t)
    assert sum(B.shape[1] for B in Bs_tp) == 128 == W2_tp.shape[0]
    if apply_impl == "xla":
        Pj = jpc.WoodburyColBlockPreconditioner(Bs=Bs_jp, W2=W2_jp,
                                                lam=jnp.asarray(LAM))
        Pt = convert.colblock_preconditioner_from_numpy(
            [np.array(B) for B in Bs_jp], np.array(W2_jp), LAM, device="cpu")
    else:
        Pj = jpc.df64_from_colblocks(tuple(jnp.array(B) for B in Bs_jp),
                                     jnp.array(W2_jp), LAM)
        Pt = tpc.df64_from_colblocks(Bs_tp, W2_tp, LAM)
        assert Pt.Bm is None and Pt.info["components"] == 2
    want = np.asarray(Pj(jnp.asarray(v)))
    assert _rel(Pt(torch.as_tensor(v)).numpy(), want) < COLBLOCK_RTOL


@pytest.fixture(scope="module")
def nystrom_system():
    """The colblock fixture's system (n = 432, 60 random columns): the JAX
    cache carried to the port."""
    ds, perms = make_benchmark_dataset("ethanol", n_samples=16, seed=11,
                                       n_train=16)
    spec_j = jd.make_spec(9)
    X, Jc = jd.descriptors_from_R(spec_j, jnp.asarray(ds["R"]))
    cj = jk.build_cache(X, Jc, jd.incidence_matrix(spec_j),
                        jnp.asarray(jd.desc_perms(perms), dtype=jnp.int32),
                        SIG, LAM)
    ct = convert.kernel_cache_from_numpy(
        {k: np.asarray(getattr(cj, k)) for k in (
            "X", "Jc", "S", "P_idx", "Xq", "Xqt", "A_exp", "A_exp1", "sig",
            "lam")}, device="cpu")
    idx = np.sort(np.random.default_rng(5).choice(ct.n, 60, replace=False))
    return spec_j, cj, ct, idx


@pytest.mark.parametrize("option", ["apply_impl", "MLFF_BUILD_GEMM"])
def test_ozaki_engines_raise(nystrom_system, option, monkeypatch):
    """The Ozaki engines (the test keeps the name of the slice in which they
    raised) build in both packages from the same columns: the Ozaki apply
    (7 digit planes of B), and the df64 apply of a factor whose whiten and
    Gram ran through the exact-slice build engine.  The applies agree within
    the column-blocked route's 5e-11 (the two f64 builds agree to ~1e-12;
    the digits add ~2^-56), the guard does not fire."""
    spec_j, cj, ct, idx = nystrom_system
    apply_impl = "ozaki" if option == "apply_impl" else "df64"
    if option == "MLFF_BUILD_GEMM":
        monkeypatch.setenv("MLFF_BUILD_GEMM", "ozaki")
        monkeypatch.setattr(tpc, "_BUILD_GEMM_MODE", None)
        monkeypatch.setattr(jpc, "_BUILD_GEMM_MODE", None)
    Pt = tpc.nystrom_preconditioner(td.make_spec(9), ct, idx, LAM,
                                    apply_impl=apply_impl)
    Pj = jpc.nystrom_preconditioner(spec_j, cj, idx, LAM,
                                    apply_impl=apply_impl)
    if option == "MLFF_BUILD_GEMM":
        assert Pt.info["build_gemm"] == "ozaki"
        monkeypatch.setattr(tpc, "_BUILD_GEMM_MODE", None)
        monkeypatch.setattr(jpc, "_BUILD_GEMM_MODE", None)
    else:
        assert isinstance(Pt, tpc.OzakiApplyPreconditioner)
        assert len(Pt.B_dig) == 7 and Pt.B_dig[0].shape[0] % 256 == 0
    assert Pt.info["apply_impl"] == apply_impl
    assert not Pt.info["gram_guard_fired"]
    v = np.random.default_rng(1).standard_normal(ct.n)
    want = np.asarray(Pj(jnp.asarray(v)))
    assert _rel(Pt(torch.as_tensor(v)).numpy(), want) < COLBLOCK_RTOL


@pytest.fixture(scope="module", params=["df64", "colblock_df64"])
def trained(request):
    """``df64`` on the calibrated kernel (~145 iterations); the column-
    blocked route on the plain one (~15 iterations).  On the calibrated
    kernel the column-blocked solves of the two packages, df64 or f64
    alike, land 1.1-1.3e-4 * max|F| apart on the held-out forces: two
    points of the same 1e-4 residual ball (tests/test_torch_train_e2e.py);
    on the plain kernel they agree to ~3e-9."""
    if request.param == "df64":
        ds, perms = make_benchmark_dataset("ethanol", n_samples=N_SAMPLES,
                                           seed=11, n_train=N_TRAIN)
    else:
        ds = make_dataset("ethanol", n_samples=N_SAMPLES, seed=3)
        ds["z"] = np.asarray([6, 6, 8, 1, 1, 1, 1, 1, 1])
        perms = benchmark_perms("ethanol")
    task = create_task(ds, N_TRAIN, ds, n_valid=5, sig=SIG, solver="cg",
                       perms=perms)
    task["apply_impl"] = "df64"
    if request.param == "colblock_df64":
        task["nystrom_block_cols"] = 80      # k = 200: blocks 80, 80, 40
    kw = dict(n_columns=N_COLUMNS, str_preconditioner="lev_random")
    m_jax = JaxTrainer().train(task, **kw)
    tr = Trainer(device="cpu")
    m_port = tr.train(task, **kw)
    held = np.setdiff1d(np.arange(N_SAMPLES), task["idxs_train"])
    return request.param, ds, held, m_jax, m_port, tr.last_info


def test_df64_training_matches_jax(trained):
    kind, ds, held, m_jax, m_port, info = trained
    assert m_jax["is_conv"] and m_port["is_conv"]
    np.testing.assert_array_equal(m_port["inducing_pts_idxs"],
                                  m_jax["inducing_pts_idxs"])
    assert abs(int(m_port["solver_iters"]) - int(m_jax["solver_iters"])) <= 2
    assert info["nystrom"]["apply_impl"] == "df64"
    assert info["nystrom"]["components"] == (3 if kind == "df64" else 2)
    E_j, F_j = JaxPredictor(m_jax).predict(ds["R"][held])
    E_t, F_t = Predictor(m_port, device="cpu").predict(ds["R"][held])
    assert np.abs(F_t - F_j).max() <= SOLVE_TOL * np.abs(F_j).max()
