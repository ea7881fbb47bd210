"""Energy-constrained training (``use_E_cstr``) in the port against the JAX
package: the extended (n + N) kernel, the Nystrom and eigenvector
preconditioners on it, the solvers, the Trainer, resume, prediction, and the
three faults of the reference that the port answers.

Inputs are made with numpy from seeds and handed to both packages; the CPU
runs the port.  The kernel pieces use a random geometry with two
permutations (the permutation axis of every energy block is live) and are
held to 1e-12 relative (the same f64 sums in another order), the factors to
1e-10.  The trainings use calibrated ethanol with its P = 6 permutations at
N_train = 10.

The extended system at lam = 1e-10 is ill-conditioned (cond ~ 6e11 at
N_train = 10): two LAPACKs' Cholesky solves of the same matrix part by
~1e-6 of the coefficients, within cond * eps, and two PCG runs part by
~1e2 per iteration once the first few are done, so iterative parity is
asserted on runs capped at 10 iterations (they part by ~1e-9 there, and
the df64 apply's rounding adds ~1e-7).  A model's predictions are sums of
a force-coefficient and an energy-coefficient term each ~1e5 times larger
than the result, so they are compared against the size of those terms.
The errors quoted as measured are CPU runs of both packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mlff_tpu.data.synthetic import make_benchmark_dataset  # noqa: E402
from mlff_tpu.models import task as jtask  # noqa: E402
from mlff_tpu.models.gdml import Trainer as JaxTrainer  # noqa: E402
from mlff_tpu.models.predict import Predictor as JaxPredictor  # noqa: E402
from mlff_tpu.ops import descriptor as jd  # noqa: E402
from mlff_tpu.ops import kernel as jk  # noqa: E402
from mlff_tpu.solvers import iterative as jit_  # noqa: E402
from mlff_tpu.solvers import preconditioners as jpc  # noqa: E402
from mlff_tpu_torch import convert  # noqa: E402
from mlff_tpu_torch.models import task as ttask  # noqa: E402
from mlff_tpu_torch.models.gdml import Trainer  # noqa: E402
from mlff_tpu_torch.models.predict import Predictor  # noqa: E402
from mlff_tpu_torch.ops import descriptor as td  # noqa: E402
from mlff_tpu_torch.ops import fused_predict as fp  # noqa: E402
from mlff_tpu_torch.ops import kernel as tk  # noqa: E402
from mlff_tpu_torch.solvers import analytic as tan  # noqa: E402
from mlff_tpu_torch.solvers import iterative as tit  # noqa: E402
from mlff_tpu_torch.solvers import preconditioners as tpc  # noqa: E402
from mlff_tpu_torch.utils import trace  # noqa: E402
from .torch_threads import one_torch_thread  # noqa: E402,F401

SIG, LAM = 10.0, 1e-10
N_ATOMS, N_TRAIN = 5, 8
PERMS = [[0, 1, 2, 3, 4], [1, 0, 2, 3, 4]]
KERNEL_RTOL, FACTOR_RTOL = 1e-12, 1e-10
N_TASK = 10          # training points of the Trainer tests
CAP = 10             # iterations of the capped solves


def _rel(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _setup(lam):
    """(spec_j, cache_j, spec_t, cache_t, y): a random geometry with two
    permutations and a seeded right-hand side of the extended system."""
    rng = np.random.default_rng(4)
    R = rng.normal(size=(N_TRAIN, N_ATOMS, 3)) * 1.5
    spec_j = jd.make_spec(N_ATOMS)
    X, Jc = jd.descriptors_from_R(spec_j, jnp.asarray(R))
    cj = jk.build_cache(X, Jc, jd.incidence_matrix(spec_j),
                        jnp.asarray(jd.desc_perms(np.asarray(PERMS))), SIG,
                        lam)
    spec_t = td.make_spec(N_ATOMS)
    Xt, Jct = td.descriptors_from_R(spec_t, torch.as_tensor(R))
    ct = tk.build_cache(Xt, Jct, td.incidence_matrix(spec_t),
                        td.desc_perms(np.asarray(PERMS)), SIG, lam,
                        device="cpu")
    y = rng.normal(size=ct.n + N_TRAIN)
    return spec_j, cj, spec_t, ct, y / np.std(y)


@pytest.fixture(scope="module")
def setup():
    return _setup(LAM)


# -- the extended kernel ---------------------------------------------------------


def test_matvec_matches_jax_and_the_dense_kernel(setup):
    spec_j, cj, spec_t, ct, y = setup
    got = tk.matvec_psd_ecstr(ct, torch.as_tensor(y))
    assert got.shape == (ct.n + N_TRAIN,)
    assert _rel(got, jk.matvec_psd_ecstr(cj, jnp.asarray(y))) <= KERNEL_RTOL
    K = tk.assemble_full_ecstr(spec_t, ct).numpy()
    assert _rel(got, (K + LAM * np.eye(len(y))) @ y) <= KERNEL_RTOL


def test_energy_weights_match_jax(setup):
    """K_ee to 1e-12; the recovered distances to 1e-7 absolute: a point
    against its own permuted copy has a Gram-trick distance of
    sqrt(rounding), ~1e-8, in either package (K_ee is flat there)."""
    _, cj, _, ct, _ = setup
    (K_ee, dist), (K_ee_j, dist_j) = tk._ecstr_mats(ct), jk._ecstr_mats(cj)
    assert _rel(K_ee, K_ee_j) <= KERNEL_RTOL
    assert float(np.abs(dist.numpy() - np.asarray(dist_j)).max()) <= 1e-7


def test_energy_blocks_match_jax(setup):
    spec_j, cj, spec_t, ct, _ = setup
    K_fe, K_ee = tk.assemble_ecstr_blocks(spec_t.dim_i, ct)
    K_fe_j, K_ee_j = jk.assemble_ecstr_blocks(spec_j.dim_i, cj)
    assert K_fe.shape == (ct.n, N_TRAIN) and K_ee.shape == (N_TRAIN, N_TRAIN)
    assert _rel(K_fe, K_fe_j) <= KERNEL_RTOL
    assert _rel(K_ee, K_ee_j) <= KERNEL_RTOL


def test_full_kernel_matches_jax_and_is_symmetric(setup):
    spec_j, cj, spec_t, ct, _ = setup
    K = tk.assemble_full_ecstr(spec_t, ct, tile=4)
    assert _rel(K, jk.assemble_full_ecstr(spec_j, cj)) <= KERNEL_RTOL
    assert _rel(K.T, K) <= KERNEL_RTOL
    # its force block is the plain kernel, bit for bit
    assert torch.equal(K[:ct.n, :ct.n], tk.assemble_full(spec_t, ct, tile=4))


def test_diagonal_matches_jax_and_the_full_kernel(setup):
    spec_j, cj, spec_t, ct, _ = setup
    d = tk.kernel_diag_ecstr(spec_t.dim_i, ct)
    assert _rel(d, jk.kernel_diag_ecstr(spec_j.dim_i, cj)) <= KERNEL_RTOL
    assert _rel(d, torch.diagonal(tk.assemble_full_ecstr(spec_t, ct))) \
        <= KERNEL_RTOL


def test_force_columns_match_jax(setup):
    spec_j, cj, spec_t, ct, _ = setup
    idx = np.sort(np.random.default_rng(2).choice(ct.n, 12, replace=False))
    cols = tk.assemble_columns_ecstr(spec_t, ct, idx)
    assert cols.shape == (ct.n + N_TRAIN, 12)
    assert _rel(cols, jk.assemble_columns_ecstr(spec_j, cj, idx)) \
        <= KERNEL_RTOL
    K_fe, _ = tk.assemble_ecstr_blocks(spec_t.dim_i, ct)
    assert torch.equal(tk.assemble_columns_ecstr(spec_t, ct, idx, K_fe=K_fe),
                       cols)


@pytest.mark.parametrize("kind", ["force", "energy", "mixed"])
def test_any_columns_match_jax_and_the_full_kernel(setup, kind):
    spec_j, cj, spec_t, ct, _ = setup
    rng = np.random.default_rng(3)
    f_idx = rng.choice(ct.n, 7, replace=False)
    e_idx = ct.n + rng.choice(N_TRAIN, 3, replace=False)
    idx = np.sort({"force": f_idx, "energy": e_idx,
                   "mixed": np.concatenate([f_idx, e_idx])}[kind])
    cols = tk.assemble_columns_ecstr_any(spec_t, ct, idx)
    assert _rel(cols, jk.assemble_columns_ecstr_any(spec_j, cj, idx)) \
        <= KERNEL_RTOL
    assert _rel(cols, tk.assemble_full_ecstr(spec_t, ct)[:, idx]) \
        <= KERNEL_RTOL
    blocks = tk.assemble_ecstr_blocks(spec_t.dim_i, ct)
    assert torch.equal(
        tk.assemble_columns_ecstr_any(spec_t, ct, idx, blocks=blocks), cols)


def test_column_assembly_refuses_what_jax_refuses(setup):
    """Energy columns as Nystrom inducing columns (an assert in the JAX
    package), and unsorted indices, whose force-before-energy order the
    assembly relies on."""
    _, _, spec_t, ct, _ = setup
    with pytest.raises(ValueError, match="force columns"):
        tk.assemble_columns_ecstr(spec_t, ct, np.array([0, ct.n]))
    with pytest.raises(ValueError, match="sorted"):
        tk.assemble_columns_ecstr_any(spec_t, ct, np.array([ct.n, 0]))


@pytest.mark.parametrize("entry", [
    "matvec", "blocks", "diag", "columns", "columns_any", "full", "solve"])
def test_on_the_fly_cache_raises(setup, entry):
    """Every energy block is recovered from the (N, M) pairwise weights, so
    a cache without them (pairwise=False) cannot carry the system."""
    _, _, spec_t, ct, y = setup
    otf = tk.build_cache(ct.X, ct.Jc, ct.S, ct.P_idx, SIG, LAM,
                         pairwise=False, device="cpu")
    calls = {
        "matvec": lambda: tk.matvec_psd_ecstr(otf, torch.as_tensor(y)),
        "blocks": lambda: tk.assemble_ecstr_blocks(spec_t.dim_i, otf),
        "diag": lambda: tk.kernel_diag_ecstr(spec_t.dim_i, otf),
        "columns": lambda: tk.assemble_columns_ecstr(spec_t, otf, [0, 1]),
        "columns_any": lambda: tk.assemble_columns_ecstr_any(spec_t, otf,
                                                             [0, ct.n]),
        "full": lambda: tk.assemble_full_ecstr(spec_t, otf),
        "solve": lambda: tit.solve_iterative(
            spec_t, otf, {"use_E_cstr": True}, y, 1.0,
            break_percentage=0.2, str_preconditioner="lev_random"),
    }
    with pytest.raises(ValueError, match="pairwise"):
        calls[entry]()


# -- preconditioners on the extended system --------------------------------------


@pytest.mark.parametrize("block_cols", [None, 8], ids=["monolithic",
                                                       "colblocked"])
def test_nystrom_factor_matches_jax(setup, block_cols):
    """Force columns as inducing points, (n + N)-row factor; the
    column-blocked build assembles the cross block once for its three
    blocks, the JAX package once per block: the factors agree all the
    same."""
    spec_j, cj, spec_t, ct, _ = setup
    idx = np.sort(np.random.default_rng(5).choice(ct.n, 20, replace=False))
    kw = dict(use_E_cstr=True, method="chol_host", block_cols=block_cols)
    P_j = jpc.nystrom_preconditioner(spec_j, cj, idx, LAM, **kw)
    P_t = tpc.nystrom_preconditioner(spec_t, ct, idx, LAM, **kw)
    if block_cols is None:
        pairs = [(P_t.B, P_j.B)]
    else:
        assert len(P_t.Bs) == len(P_j.Bs) == 3
        pairs = list(zip(P_t.Bs, P_j.Bs))
    for B_t, B_j in pairs:
        assert B_t.shape[0] == ct.n + N_TRAIN
        assert _rel(B_t, B_j) <= FACTOR_RTOL
    assert _rel(P_t.W2, P_j.W2) <= FACTOR_RTOL


@pytest.mark.parametrize("variant", ["eigvec_precon",
                                     "eigvec_precon_block_diagonal",
                                     "eigvec_precon_atomic_interactions"])
def test_eigvec_masks_match_jax(setup, variant):
    """The extended masks: equal singular values of the masked (n + N)
    matrix (1e-10 of the largest), and equal rank-k factors L L^T, which
    are the same whatever basis each SVD picks within a repeated singular
    value."""
    spec_j, cj, spec_t, ct, _ = setup
    n_ext, k = ct.n + N_TRAIN, 20
    sc_j, sc_t = {}, {}
    P_j = jpc.eigvec_preconditioner(spec_j, cj, k, LAM, variant=variant,
                                    svd_cache=sc_j, use_E_cstr=True)
    P_t = tpc.eigvec_preconditioner(spec_t, ct, k, LAM, variant=variant,
                                    svd_cache=sc_t, use_E_cstr=True)
    (s_j,), (s_t,) = ([v[1] for v in sc.values()] for sc in (sc_j, sc_t))
    assert s_t.shape == (n_ext,)
    assert _rel(s_t, s_j) <= FACTOR_RTOL
    B_j = np.asarray(P_j.B)
    assert P_t.B.shape == B_j.shape == (n_ext, 128)
    assert _rel(P_t.B @ P_t.B.T, B_j @ B_j.T) <= FACTOR_RTOL


# -- solvers -----------------------------------------------------------------------


@pytest.mark.parametrize("apply_impl", ["xla", "df64"])
def test_capped_solve_matches_jax(apply_impl):
    """The constrained calibrated-ethanol system (its labels with the
    centred energies), lev_random at 20% of n + N, 10 iterations (the df64
    apply through the kernels' plain versions here, the JAX kernels in
    interpret mode): equal inducing columns, iterates within 1e-6 (3.8e-9
    measured with the f64 apply, 9.8e-8 with df64)."""
    _, task, _ = _task("cg")
    jt, tt = JaxTrainer(), Trainer(device="cpu")
    spec_j, S, X, Jc, P_idx = jt.build_kernel_inputs(task)
    y, _, _ = jt.labels(task)
    cj = jk.build_cache(X, Jc, S, P_idx, SIG, LAM)
    spec_t, S_t, X_t, Jc_t, P_t = tt.build_kernel_inputs(task)
    ct = tk.build_cache(X_t, Jc_t, S_t, P_t, SIG, LAM, device="cpu")
    np.testing.assert_array_equal(tt.labels(task)[0], y)
    sub = {"use_E_cstr": True, "solver_maxiter": CAP,
           "apply_impl": apply_impl}
    kw = dict(break_percentage=0.2, str_preconditioner="lev_random", seed=1)
    res_j = jit_.solve_iterative(spec_j, cj, sub, y, 1.0, **kw)
    res_t = tit.solve_iterative(spec_t, ct, sub, y, 1.0, **kw)
    assert res_t.num_iters == res_j.num_iters == CAP
    assert len(res_t.inducing_pts_idxs) == int(0.2 * (ct.n + N_TASK))
    np.testing.assert_array_equal(res_t.inducing_pts_idxs,
                                  res_j.inducing_pts_idxs)
    assert res_t.alphas.shape == (ct.n + N_TASK,)
    assert _rel(res_t.alphas, res_j.alphas) <= 1e-6


def test_square_layout_stays_off(setup):
    """The square matvec has no energy-constrained form: a forced
    ``matvec_impl="square"`` keeps the packed matvec, as in the JAX
    package."""
    _, _, spec_t, ct, y = setup
    res = tit.solve_iterative(
        spec_t, ct, {"use_E_cstr": True, "matvec_impl": "square",
                     "solver_maxiter": 2}, y, 1.0, break_percentage=0.2,
        str_preconditioner="lev_random")
    assert res.info["matvec_impl"] == "packed"


# -- the Trainer, resume and prediction ---------------------------------------


def _task(solver):
    ds, perms = make_benchmark_dataset("ethanol", n_samples=N_TASK + 10,
                                       seed=11, n_train=N_TASK)
    task = jtask.create_task(ds, N_TASK, ds, n_valid=5, sig=SIG, perms=perms,
                             solver=solver, use_E_cstr=True)
    held = np.setdiff1d(np.arange(N_TASK + 10), task["idxs_train"])
    return ds, task, held


TRAIN_KW = dict(break_percentage=0.2, str_preconditioner="lev_random")


@pytest.fixture(scope="module")
def analytic_pair():
    ds, task, held = _task("analytic")
    return ds, task, held, JaxTrainer().train(dict(task)), \
        Trainer(device="cpu").train(dict(task))


def _term_scales(m, R):
    """(energy, force) scale of a constrained model's predictions on R: the
    largest value of either of its two terms alone (force and energy
    coefficients), which cancel to the model's output."""
    sE = sF = 0.0
    for part in (dict(m, alphas_E=np.zeros(N_TASK)),
                 dict(m, R_d_desc_alpha=np.zeros_like(m["R_d_desc_alpha"]))):
        E, F = JaxPredictor(part).predict(R)
        sE = max(sE, float(np.abs(E - m["c"]).max()))
        sF = max(sF, float(np.abs(F).max()))
    return sE, sF


def _assert_models_agree(ds, held, m_t, m_j, alphas_rtol, pred_rtol):
    """Equal keys and c, coefficients within ``alphas_rtol`` of the largest,
    held-out predictions within ``pred_rtol`` of the terms' scale."""
    assert set(m_t) == set(m_j)
    assert m_t["alphas_E"].shape == (N_TASK,)
    assert _rel(m_t["alphas_F"], m_j["alphas_F"]) <= alphas_rtol
    assert _rel(m_t["alphas_E"], m_j["alphas_E"]) <= alphas_rtol
    assert m_t["c"] == m_j["c"]
    R = ds["R"][held]
    E_j, F_j = JaxPredictor(m_j).predict(R)
    E_t, F_t = Predictor(m_t, device="cpu").predict(R)
    sE, sF = _term_scales(m_j, R)
    assert float(np.abs(F_t - F_j).max()) <= pred_rtol * sF
    assert float(np.abs(E_t - E_j).max()) <= pred_rtol * sE


def test_analytic_training_matches_jax(analytic_pair):
    """The dense (n + N) solve in two LAPACKs (cond ~ 6e11): coefficients
    within 1e-5 of the largest (9.1e-7 measured; cond * eps ~ 1e-4), each
    package's coefficients solving the JAX package's system as well as its
    own do (relative residual 2.7e-8 both), and predictions within 1e-9 of
    the terms' scale (9.2e-12 measured)."""
    ds, task, held, m_j, m_t = analytic_pair
    _assert_models_agree(ds, held, m_t, m_j, 1e-5, 1e-9)
    assert m_t["c"] == float(np.mean(task["E_train"]))
    jt = JaxTrainer()
    spec, S, X, Jc, P_idx = jt.build_kernel_inputs(task)
    y, _, _ = jt.labels(task)
    cache = jk.build_cache(X, Jc, S, P_idx, SIG, float(task["lam"]))
    K = np.asarray(jk.assemble_full_ecstr(spec, cache))
    A = K + tan.ANALYTIC_REG * np.eye(len(y))

    def resid(m):
        a = -np.concatenate([m["alphas_F"], m["alphas_E"]])
        return np.linalg.norm(A @ a - y) / np.linalg.norm(y)

    assert resid(m_t) <= max(10 * resid(m_j), 1e-8)


def test_cg_training_matches_jax():
    """lev_random PCG capped at 10 iterations (two f64 runs of a
    lam = 1e-10 system part further after that): coefficients within 1e-7
    (2.5e-9 measured), predictions within 1e-6 of the terms' scale, c the
    training energies' mean in both."""
    ds, task, held = _task("cg")
    task["solver_maxiter"] = CAP
    m_j = JaxTrainer().train(dict(task), **TRAIN_KW)
    m_t = Trainer(device="cpu").train(dict(task), **TRAIN_KW)
    assert int(m_t["solver_iters"]) == int(m_j["solver_iters"]) == CAP
    assert len(m_t["inducing_pts_idxs"]) == int(0.2 * 28 * N_TASK)
    _assert_models_agree(ds, held, m_t, m_j, 1e-7, 1e-6)


def test_resume_with_energy_coefficients_matches_jax():
    """A constrained JAX model stopped after 10 iterations, resumed by both
    packages through their own create_task_from_model for 2 more: the task
    carries alphas0_E, solver_iters reaches 12 in both and the coefficients
    agree within 1e-7 (3.8e-9 measured; later iterations part chaotically,
    see the module docstring)."""
    ds, task, _ = _task("cg")
    m0 = JaxTrainer().train(dict(task, solver_maxiter=CAP), **TRAIN_KW)
    task_j = jtask.create_task_from_model(m0, ds)
    task_t = ttask.create_task_from_model(m0, ds)
    assert task_t["use_E_cstr"] and task_t["alphas0_E"].shape == (N_TASK,)
    for key in task_j:
        np.testing.assert_array_equal(np.asarray(task_t[key]),
                                      np.asarray(task_j[key]), err_msg=key)
    r_j = JaxTrainer().train(dict(task_j, solver_maxiter=2), **TRAIN_KW)
    r_t = Trainer(device="cpu").train(dict(task_t, solver_maxiter=2),
                                      **TRAIN_KW)
    assert int(r_t["solver_iters"]) == int(r_j["solver_iters"]) == CAP + 2
    assert _rel(r_t["alphas_F"], r_j["alphas_F"]) <= 1e-7
    assert _rel(r_t["alphas_E"], r_j["alphas_E"]) <= 1e-7


def test_fast_predictor_takes_the_f64_contraction_for_constrained_models(
        analytic_pair):
    """A JAX-trained constrained model carried across by
    ``convert.model_from_numpy``: ``fast=True`` routes as the JAX package
    does (models/predict.py:106-109), to the f64 contraction, launching no
    fused kernel, with the same bits as ``fast=False``.  Against the JAX
    Predictor: each of the two terms of the contraction (force and energy
    coefficients) within 1e-10 of its own size, and the model's energies
    within 1e-10 of the terms' size (they cancel ~1e5-fold), forces within
    1e-8."""
    ds, _, held, m_j, _ = analytic_pair
    m = convert.model_from_numpy(m_j)
    R = ds["R"][held]
    launches = trace.counter(fp.LAUNCHES)
    fast = Predictor(m, fast=True, device="cpu")
    assert not fast.fast
    E_f, F_f = fast.predict(R)
    E_s, F_s = Predictor(m, fast=False, device="cpu").predict(R)
    assert trace.counter(fp.LAUNCHES) == launches
    np.testing.assert_array_equal(E_f, E_s)
    np.testing.assert_array_equal(F_f, F_s)
    E_j, F_j = JaxPredictor(m_j).predict(R)
    assert _rel(F_f, F_j) <= 1e-8
    scale = 0.0
    for part in (dict(m, alphas_E=np.zeros(N_TASK)),
                 dict(m, R_d_desc_alpha=np.zeros_like(m["R_d_desc_alpha"]))):
        E_pj, F_pj = JaxPredictor(part).predict(R)
        E_pt, F_pt = Predictor(part, fast=True, device="cpu").predict(R)
        assert _rel(E_pt - m["c"], E_pj - m["c"]) <= 1e-10
        assert _rel(F_pt, F_pj) <= 1e-10
        scale = max(scale, float(np.abs(E_pj - m["c"]).max()))
    assert float(np.abs(E_f - E_j).max()) <= 1e-10 * scale


def test_model_from_numpy_checks_the_energy_coefficients(analytic_pair):
    _, _, _, m_j, _ = analytic_pair
    assert convert.model_from_numpy(m_j)["alphas_E"].shape == (N_TASK,)
    with pytest.raises(ValueError, match="alphas_E"):
        convert.model_from_numpy(dict(m_j, alphas_E=np.zeros(N_TASK + 1)))


# -- faults of the reference that the port answers ----------------------------


def test_checkpoint_of_a_constrained_solve_is_the_model_train_makes(
        monkeypatch):
    """The JAX package hands the whole (n + N) iterate to create_model as
    force coefficients and raises.  The port splits it as ``train`` does:
    a solve capped at one chunk of 25 iterations saves one checkpoint, the
    same iterate ``train`` returns, and that model predicts as the trained
    one does, bit for bit."""
    monkeypatch.setenv("MLFF_CKPT_EVERY_S", "0")
    ds, task, held = _task("cg")
    jt = JaxTrainer()
    spec, S, X, Jc, _ = jt.build_kernel_inputs(task)
    y, y_std, _ = jt.labels(task)
    snap = dict(alphas_psd=np.zeros(len(y)), num_iters=3, resid=1.0,
                inducing_pts_idxs=np.arange(5))
    with pytest.raises(ValueError, match="reshape"):
        jt._wrap_ckpt(lambda m: None, task, spec, S, X, Jc, y, y_std)(**snap)

    saved = []
    m = Trainer(device="cpu").train(dict(task, solver_maxiter=25),
                                    save_progr_callback=saved.append,
                                    **TRAIN_KW)
    (ck,) = saved
    assert int(ck["solver_iters"]) == int(m["solver_iters"]) + 1 == 26
    np.testing.assert_array_equal(ck["alphas_F"], m["alphas_F"])
    np.testing.assert_array_equal(ck["alphas_E"], m["alphas_E"])
    assert ck["c"] == m["c"] == float(np.mean(task["E_train"]))
    E_c, F_c = Predictor(ck, device="cpu").predict(ds["R"][held])
    E_m, F_m = Predictor(m, device="cpu").predict(ds["R"][held])
    np.testing.assert_array_equal(E_c, E_m)
    np.testing.assert_array_equal(F_c, F_m)


def test_cg_cholesky_refuses_energy_constraints():
    """The JAX package passes no energy constraint to this solver and fails
    reshaping the (n + N) labels; the port refuses first."""
    _, task, _ = _task("cg_cholesky")
    with pytest.raises(TypeError, match="reshape"):
        JaxTrainer().train(dict(task), break_percentage=0.1)
    with pytest.raises(ValueError, match="cg_cholesky"):
        Trainer(device="cpu").train(dict(task), break_percentage=0.1)


def test_flag_eigvals_refuses_energy_constraints(setup):
    """The JAX package's spectrum assembles the force-only K and applies the
    (n + N) preconditioner to its columns, and fails; the port refuses."""
    spec_j, cj, spec_t, ct, y = setup
    task = {"use_E_cstr": True}
    kw = dict(break_percentage=0.2, str_preconditioner="lev_random",
              flag_eigvals=True)
    with pytest.raises(TypeError, match="broadcasting"):
        jit_.solve_iterative(spec_j, cj, task, y, 1.0, **kw)
    with pytest.raises(ValueError, match="flag_eigvals"):
        tit.solve_iterative(spec_t, ct, task, y, 1.0, **kw)
