"""The port on the card: the fused kernel against its plain version, the
fast Predictor against the f64 one on a small model, the df64 GEMV kernels
against their plain versions and the f64 product, and a small
``apply_impl="df64"`` training on the card against the same on the CPU.

These tests need an NVIDIA GPU and skip without one.  The file imports
nothing of JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The fused contraction is f64 on both sides.  On random cotangents 1e-10
relative covers the summation order, far inside ``chip_smoke.py``'s
atol 2e-5 * max|F| + rtol 2e-4; that holds at every descriptor width the
kernel is built for, with ragged B and M, and where queries are training
rows (zero distances, which the kernel and the plain version round
differently).  On a trained model the contraction's
terms cancel by ~1e6, so the fast and the f64 Predictor are held to 1e-8
relative, and energies on the scale of the contraction's output before the
integration constant c is added.  The df64 passes are held to 3e-12
relative, the tolerance of ``tests/test_df64.py``; the df64 training, like
``chip_smoke.py``'s reference phase, to +-2 iterations and 1e-4 * max|F|.
The wide route (D > 129) is held to its plain version at 1e-10 as the
narrow widths are, at D = 130, 210, 3,828 and 68,265.  The on-the-fly
matvec and the square matvec are held to the cached packed matvec (1e-12,
1e-10).  The greedy pivoted Cholesky on the card is held to the port's own
CPU run on a random geometry (equal pivots, L to 1e-10, below the rank where
translation ties appear, see ``tests/test_torch_zoo.py``) and queues its
steps without a host read.  The energy-constrained matvec, energy blocks and
greedy loop on the card are held to the port's CPU run (1e-12, 1e-12, equal
pivots and L to 1e-10); the df64 passes also run at the row count of the
constrained main path's factor, 32,648.  The Ozaki engine's f32 digit
products are exact on the card at the 2^24 bound (+-256 digits over
256-deep segments, against an int64 product); an f32 product of the
precision engines raises with TF32 on; the Ozaki matvec and apply on the
card are held to the port's CPU result on the same bits within 1e-15 of
the norm (the digit products are exact; the f64 parts round in another
order).
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
from mlff_tpu_torch.solvers import iterative as tit  # noqa: E402
from mlff_tpu_torch.solvers import pivoted_cholesky as pch  # noqa: E402
from mlff_tpu_torch.tools.time_fused_predict import operands  # noqa: E402

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


# descriptor width -> (molecule, training geometries); 3 has no molecule
WIDTHS = {3: None, 36: ("ethanol", 100), 66: ("uracil", 300),
          105: ("toluene", 40), 120: ("salicylic", 300)}


@pytest.fixture(scope="module")
def by_width(small):
    """{D: (513 queries, Xqt, wt)} on the card, M ragged (not a multiple of
    the kernel's 16-row stages)."""
    out = {}
    for D, source in WIDTHS.items():
        if source is None:
            rng = np.random.default_rng(D)
            Xq, Xqt, wt = (torch.as_tensor(a, device="cuda") for a in (
                0.2 + rng.random((513, D)), 0.2 + rng.random((301, D)),
                rng.normal(size=(301, D))))
        else:
            Xq, Xqt, wt = operands(*source, 513, "cuda")
            Xqt, wt = Xqt[:-3].contiguous(), wt[:-3].contiguous()
        assert Xq.shape == (513, D) and Xqt.shape[0] % 16 != 0
        out[D] = (Xq, Xqt, wt)
    return out


@pytest.mark.parametrize("B", [1, 7, 40, 513])
@pytest.mark.parametrize("D", sorted(WIDTHS))
def test_kernel_matches_plain_version_at_every_width(by_width, D, B):
    Xq, Xqt, wt = by_width[D]
    args = (Xq[:B].contiguous(), Xqt, wt)
    before = fp.desc_forces_fused.launches
    F_k, E_k = fp.desc_forces_fused(*args, SIG)
    F_r, E_r = fp.desc_forces_fused_ref(*args, SIG)
    torch.cuda.synchronize()
    assert fp.desc_forces_fused.launches == before + 1
    assert F_k.shape == (B, D) and E_k.shape == (B,)
    assert torch.isfinite(F_k).all() and torch.isfinite(E_k).all()
    assert _rel_err(F_k, F_r) <= RTOL and _rel_err(E_k, E_r) <= RTOL


@pytest.mark.parametrize("D", [36, 105])
def test_kernel_matches_plain_version_on_self_pairs(by_width, D):
    """Queries taken from the training rows: d^2 of a row against itself is
    rounding noise of either sign, clamped to 0 or not, in the kernel and in
    the plain version differently; F and E feel it only to second order."""
    _, Xqt, wt = by_width[D]
    args = (Xqt[5:205].contiguous(), Xqt, wt)
    F_k, E_k = fp.desc_forces_fused(*args, SIG)
    F_r, E_r = fp.desc_forces_fused_ref(*args, SIG)
    torch.cuda.synchronize()
    assert _rel_err(F_k, F_r) <= RTOL and _rel_err(E_k, E_r) <= RTOL


@pytest.mark.parametrize("B", [1, 513])
def test_kernel_gives_the_same_bits_twice(by_width, B):
    """The slabs' partials are added in a fixed order, without atomics."""
    Xq, Xqt, wt = by_width[36]
    args = (Xq[:B].contiguous(), Xqt, wt)
    F_1, E_1 = fp.desc_forces_fused(*args, SIG)
    for _ in range(3):
        F_2, E_2 = fp.desc_forces_fused(*args, SIG)
        assert torch.equal(F_1, F_2) and torch.equal(E_1, E_2)


# the wide route: width -> (molecule, training geometries); None: random
WIDE_WIDTHS = {130: None, 210: ("aspirin", 250), 3828: ("catcher", 119),
               68265: ("nanotube", 14)}


@pytest.fixture(scope="module")
def by_wide_width(small):
    """{D: (queries, Xqt, wt)} on the card: 513 queries (60 at the
    nanotube's width), M ragged against the wide route's 16-row steps and
    64-row tiles where the molecule allows."""
    out = {}
    for D, source in WIDE_WIDTHS.items():
        if source is None:
            rng = np.random.default_rng(D)
            Xq, Xqt, wt = (torch.as_tensor(a, device="cuda") for a in (
                0.05 + 0.1 * rng.random((513, D)),
                0.05 + 0.1 * rng.random((301, D)), rng.normal(size=(301, D))))
        else:
            Xq, Xqt, wt = operands(*source, 513 if D < 68265 else 60, "cuda")
            if Xqt.shape[0] > 64:
                Xqt, wt = Xqt[:-3].contiguous(), wt[:-3].contiguous()
        assert Xq.shape[1] == D and fp.geometry_for(D) is fp.WIDE
        out[D] = (Xq, Xqt, wt)
    return out


@pytest.mark.parametrize("B", [1, 7, 64, 513])
@pytest.mark.parametrize("D", sorted(WIDE_WIDTHS))
def test_wide_kernel_matches_plain_version(by_wide_width, D, B):
    Xq, Xqt, wt = by_wide_width[D]
    args = (Xq[:B].contiguous(), Xqt, wt)
    B = args[0].shape[0]
    before = fp.desc_forces_fused.launches
    F_k, E_k = fp.desc_forces_fused(*args, SIG)
    F_r, E_r = fp.desc_forces_fused_ref(*args, SIG)
    torch.cuda.synchronize()
    assert fp.desc_forces_fused.launches == before + 1
    assert F_k.shape == (B, D) and E_k.shape == (B,)
    assert torch.isfinite(F_k).all() and torch.isfinite(E_k).all()
    assert _rel_err(F_k, F_r) <= RTOL and _rel_err(E_k, E_r) <= RTOL


@pytest.mark.parametrize("D", [210, 3828])
def test_wide_kernel_gives_the_same_bits_twice(by_wide_width, D):
    """Slab partials and row sums are added in a fixed order."""
    Xq, Xqt, wt = by_wide_width[D]
    args = (Xq[:300].contiguous(), Xqt, wt)
    F_1, E_1 = fp.desc_forces_fused(*args, SIG)
    for _ in range(2):
        F_2, E_2 = fp.desc_forces_fused(*args, SIG)
        assert torch.equal(F_1, F_2) and torch.equal(E_1, E_2)


def test_wide_kernel_chunks_the_queries(by_wide_width, monkeypatch):
    """A call whose weights pass the budget goes in chunks of queries, the
    last one ragged."""
    Xq, Xqt, wt = by_wide_width[210]
    monkeypatch.setattr(fp, "WIDE_WEIGHT_DOUBLES", 2 * 128 * Xqt.shape[0])
    fp.plan.cache_clear()
    try:
        assert fp.plan(513, Xqt.shape[0], 210, 132).b_chunk == 128
        F_k, E_k = fp.desc_forces_fused(Xq, Xqt, wt, SIG)
    finally:
        fp.plan.cache_clear()
    F_r, E_r = fp.desc_forces_fused_ref(Xq, Xqt, wt, SIG)
    torch.cuda.synchronize()
    assert _rel_err(F_k, F_r) <= RTOL and _rel_err(E_k, E_r) <= RTOL


def test_kernel_geometry_is_the_plans(small):
    """What the built library reports for each width is what ``plan``
    assumes, and the card keeps at least the planned blocks resident."""
    lib = fp._library()
    for geo in fp.GEOMETRIES:
        queries, threads, smem, resident = fp.library_geometry(lib, geo.width)
        assert (queries, threads, smem) == (geo.queries, geo.threads,
                                            geo.smem_bytes)
        assert resident >= geo.blocks_per_sm
    wide = fp.library_wide_geometry(lib)
    assert wide[:6] == (fp.WIDE.queries, fp.WIDE.tile, fp.WIDE.depth,
                        fp.WIDE.threads, fp.WIDE.smem_weights,
                        fp.WIDE.smem_forces)
    assert min(wide[6:]) >= 2


def test_otf_matvec_matches_the_cached_matvec(small, monkeypatch):
    """The on-the-fly matvec on the card, tiles of the 128-row floor with a
    ragged last one, against the cached matvec at 1e-12."""
    ds, perms = make_benchmark_dataset("ethanol", n_samples=300, seed=11,
                                       n_train=300)
    spec = dsc.make_spec(9)
    X, Jc = dsc.descriptors_from_R(spec, torch.as_tensor(ds["R"],
                                                         device="cuda"))
    args = (X, Jc, dsc.incidence_matrix(spec, device="cuda"),
            dsc.desc_perms(perms), SIG, 1e-10)
    cached = knl.build_cache(*args)
    otf = knl.build_cache(*args, pairwise=False)
    v = torch.as_tensor(np.random.default_rng(2).normal(size=cached.n),
                        device="cuda")
    monkeypatch.setattr(knl, "_OTF_TILE", 128)
    assert _rel_err(knl.matvec_psd(otf, v), knl.matvec_psd(cached, v)) <= 1e-12


def test_square_matvec_matches_the_packed_matvec(small):
    """The square all-pairs matvec on the card against the packed one
    (catcher geometries, A = 88) at 1e-10."""
    ds, _ = make_benchmark_dataset("catcher", n_samples=6, seed=11,
                                   n_train=119)
    spec = dsc.make_spec(88)
    R = torch.as_tensor(ds["R"], device="cuda")
    X, Jc = dsc.descriptors_from_R(spec, R)
    perms = np.arange(88)[None]
    packed = knl.build_cache(X, Jc, dsc.incidence_matrix(spec, device="cuda"),
                             dsc.desc_perms(perms), SIG, 1e-10)
    sq = knl.build_cache_square(R, perms, SIG, 1e-10)
    v = torch.as_tensor(np.random.default_rng(5).normal(size=packed.n),
                        device="cuda")
    assert _rel_err(knl.matvec_psd_square(sq, v),
                    knl.matvec_psd(packed, v)) <= 1e-10


def test_fast_predictor_matches_f64_predictor_at_a_wide_width(small):
    """An aspirin model (D = 210): the fast Predictor takes the wide route
    and agrees with the f64 Predictor as at narrow widths."""
    ds, perms = make_benchmark_dataset("aspirin", n_samples=40, seed=11,
                                       n_train=30)
    task = create_task(ds, 30, ds, n_valid=5, sig=SIG, solver="cg",
                       perms=perms)
    model = Trainer().train(task, n_columns=400,
                            str_preconditioner="lev_random")
    held = np.setdiff1d(np.arange(40), task["idxs_train"])
    before = fp.desc_forces_fused.launches
    E_f, F_f = Predictor(model, fast=True).predict(ds["R"][held])
    assert fp.desc_forces_fused.launches > before
    E_x, F_x = Predictor(model).predict(ds["R"][held])
    assert np.abs(F_f - F_x).max() <= MODEL_RTOL * np.abs(F_x).max()
    assert np.abs(E_f - E_x).max() <= \
        MODEL_RTOL * np.abs(E_x - model["c"]).max()


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
                                   (257, 4), (32648, 1536)])
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


def _random_caches(n_atoms=5, n_train=14, seed=0):
    """The random geometry of tests/test_torch_zoo.py on the card and on
    the CPU."""
    R = np.random.default_rng(seed).normal(size=(n_train, n_atoms, 3)) * 1.5
    spec = dsc.make_spec(n_atoms)
    caches = []
    for dev in ("cuda", "cpu"):
        X, Jc = dsc.descriptors_from_R(spec, torch.as_tensor(R, device=dev))
        caches.append(knl.build_cache(
            X, Jc, dsc.incidence_matrix(spec, device=dev),
            dsc.desc_perms(np.arange(n_atoms)[None, :]), SIG, 1e-10,
            device=dev))
    return spec, caches[0], caches[1]


def test_greedy_pivoted_cholesky_on_card_matches_cpu(small):
    spec, c_gpu, c_cpu = _random_caches()
    res_g, info_g = pch.pivoted_cholesky(spec, c_gpu, 40)
    res_c, info_c = pch.pivoted_cholesky(spec, c_cpu, 40)
    assert res_g.L.is_cuda and res_g.pivots.is_cuda
    np.testing.assert_array_equal(info_g["pivots"], info_c["pivots"])
    assert _rel_err(res_g.L.cpu(), res_c.L) <= RTOL
    assert _rel_err(res_g.remaining_diag.cpu(), res_c.remaining_diag) <= RTOL
    assert info_g["min_pivot"] > 0


def test_greedy_loop_reads_nothing_back_per_step(small):
    """The loop runs under PyTorch's synchronization debug mode, which
    raises on an operation that waits for the device (a ``.item()``, a
    ``bool()`` of a device tensor, a copy to the host)."""
    spec, c_gpu, _ = _random_caches()
    diag = knl.kernel_diag(spec.dim_i, c_gpu)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = pch._pivoted_cholesky_device(spec.dim_i, c_gpu, diag, 24)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float(res.pivot_values.min()) > 0


def test_df64_apply_of_a_cholesky_factor_launches_both_kernels(small):
    """apply_impl="df64" with str_preconditioner="cholesky": the factor's
    apply runs the two df64 kernels and agrees with the f64 apply."""
    spec, c_gpu, _ = _random_caches()
    v = torch.as_tensor(np.random.default_rng(4).normal(size=c_gpu.n),
                        device="cuda")
    P64, _, _ = tit.build_preconditioner(
        spec, c_gpu, "cholesky", 40, 1e-10, np.random.default_rng(7))
    Pdf, _, _ = tit.build_preconditioner(
        spec, c_gpu, "cholesky", 40, 1e-10, np.random.default_rng(7),
        task={"apply_impl": "df64"})
    before = (df64_gemv.df64_bt_v.launches, df64_gemv.df64_b_x.launches)
    got = Pdf(v)
    torch.cuda.synchronize()
    assert df64_gemv.df64_bt_v.launches == before[0] + 1
    assert df64_gemv.df64_b_x.launches == before[1] + 1
    assert _rel_err(got, P64(v)) <= DF64_RTOL


def test_constrained_matvec_and_blocks_on_card_match_cpu(small):
    spec, c_gpu, c_cpu = _random_caches()
    n_ext = c_cpu.n + c_cpu.n_train
    v = np.random.default_rng(6).normal(size=n_ext)
    got = knl.matvec_psd_ecstr(c_gpu, torch.as_tensor(v, device="cuda"))
    assert got.is_cuda
    assert _rel_err(got.cpu(), knl.matvec_psd_ecstr(
        c_cpu, torch.as_tensor(v))) <= 1e-12
    for g, c in zip(knl.assemble_ecstr_blocks(spec.dim_i, c_gpu),
                    knl.assemble_ecstr_blocks(spec.dim_i, c_cpu)):
        assert _rel_err(g.cpu(), c) <= 1e-12


def test_constrained_greedy_loop_on_card_matches_cpu(small):
    """Energy pivots included; the loop queues its steps without a host
    read (synchronization debug mode, as for the force-only loop)."""
    spec, c_gpu, c_cpu = _random_caches()
    res_g, info_g = pch.pivoted_cholesky(spec, c_gpu, 40, use_E_cstr=True)
    res_c, info_c = pch.pivoted_cholesky(spec, c_cpu, 40, use_E_cstr=True)
    np.testing.assert_array_equal(info_g["pivots"], info_c["pivots"])
    assert (info_c["pivots"] >= c_cpu.n).any()
    assert _rel_err(res_g.L.cpu(), res_c.L) <= RTOL
    diag = knl.kernel_diag_ecstr(spec.dim_i, c_gpu)
    K_fe, K_ee = knl.assemble_ecstr_blocks(spec.dim_i, c_gpu)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = pch._pivoted_cholesky_device_ecstr(spec.dim_i, c_gpu, diag,
                                                 K_fe, K_ee, 24)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float(res.pivot_values.min()) > 0


def _cache_on(cache, dev):
    """The same cache fields, bit for bit, on ``dev``."""
    import dataclasses
    return dataclasses.replace(cache, **{
        f.name: getattr(cache, f.name).to(dev)
        for f in dataclasses.fields(cache)
        if torch.is_tensor(getattr(cache, f.name))})


@pytest.mark.parametrize("pattern", ["all_plus", "alternating", "random"])
def test_ozaki_digit_products_are_exact_on_the_card(small, pattern):
    """Digits of +-256 over 256-deep segments reach the 2^24 bound of the
    exact f32 sum; the card's f32 products (cuBLAS, TF32 off) equal an
    int64 product of the same digits."""
    from mlff_tpu_torch.ops import ozaki

    rng = np.random.default_rng(3)
    n, K, m = 64, 4 * 256, 48
    if pattern == "all_plus":
        a, b = np.full((n, K), 256), np.full((K, m), 256)
    elif pattern == "alternating":
        sign = np.where(np.arange(K) % 2 == 0, 1, -1)
        a = np.full((n, K), 256) * sign[None, :]
        b = np.full((K, m), -256) * sign[:, None]
    else:
        a = rng.choice([-256, 256], size=(n, K))
        b = rng.choice([-256, 256], size=(K, m))
    want = (a.reshape(n, 4, 256).transpose(1, 0, 2)
            @ b.reshape(4, 256, m)).sum(axis=0)            # int64
    got = ozaki._seg_matmul(
        ozaki._f32(torch.as_tensor(a, dtype=torch.bfloat16, device="cuda")),
        ozaki._f32(torch.as_tensor(b, dtype=torch.bfloat16, device="cuda")),
        4)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.astype(np.float64))


def test_f32_products_raise_with_tf32_on(small):
    from mlff_tpu_torch.ops import ozaki

    A = torch.ones((8, 300), dtype=torch.float64, device="cuda")
    _, c_gpu, _ = _random_caches()
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            ozaki.gemm(A, A.T)
        with pytest.raises(RuntimeError, match="TF32"):
            knl.matvec_psd_mixed(c_gpu, torch.ones(c_gpu.n, device="cuda",
                                                   dtype=torch.float64))
        with pytest.raises(RuntimeError, match="TF32"):
            knl.matvec_psd(knl.downcast_cache(c_gpu),
                           torch.ones(c_gpu.n, device="cuda",
                                      dtype=torch.float64))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("pairwise", [True, False], ids=["cached", "otf"])
def test_ozaki_matvec_on_card_matches_cpu(small, pairwise):
    """The same cache bits on both devices: the exact digit products leave
    only the f64 parts' rounding order, 1e-15 of the norm."""
    ds, perms = small
    spec = dsc.make_spec(9)
    X, Jc = dsc.descriptors_from_R(spec, torch.as_tensor(ds["R"][:30]))
    c_cpu = knl.build_cache(X, Jc, dsc.incidence_matrix(spec),
                            dsc.desc_perms(perms), SIG, 1e-10,
                            pairwise=pairwise, device="cpu")
    c_gpu = _cache_on(c_cpu, "cuda")
    v = np.random.default_rng(8).normal(size=c_cpu.n)
    want = knl.matvec_psd_ozaki(knl.ozaki_matvec_state(c_cpu),
                                torch.as_tensor(v))
    got = knl.matvec_psd_ozaki(knl.ozaki_matvec_state(c_gpu),
                               torch.as_tensor(v, device="cuda")).cpu()
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) \
        <= 1e-15


def test_ozaki_apply_on_card_matches_cpu(small):
    from mlff_tpu_torch.solvers import preconditioners as pc

    rng = np.random.default_rng(0)
    n, m = 4099, 256
    U = np.linalg.qr(rng.normal(size=(n, m)))[0]
    B = U * np.exp(-np.linspace(0, 8, m))[None, :]
    W2 = np.linalg.cholesky(np.linalg.inv(B.T @ B + 1e-10 * np.eye(m)))
    v = rng.normal(size=n)
    out = []
    for dev in ("cpu", "cuda"):
        P = pc.ozaki_from_split(pc.WoodburySplitPreconditioner(
            B=torch.as_tensor(B, device=dev),
            W2=torch.as_tensor(W2, device=dev), lam=1e-10, info={}))
        out.append(P(torch.as_tensor(v, device=dev)).cpu())
    want, got = out
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) \
        <= 1e-15
