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
matvec, one fused-kernel call on the card, and the square matvec are held
to the cached packed matvec (1e-12, 1e-10); the wide route's on-the-fly
matvec to the CPU's tile loop (1e-12), and a graphed on-the-fly PCG solve
to the CPU's (iterations within 2, solutions within 1e-10).  The greedy pivoted Cholesky on the card is held to the port's own
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
order).  The row-sharded operator runs on a one-rank NCCL group in this
process: its matvec equals the unsharded one to 1e-12 and its Nystrom
apply (f64 and df64) to 1e-10; its PCG solve, graphed with its
collectives, gives the eager solve's iterate bit for bit on the pairwise
(f64 and df64 apply), on-the-fly and square operators, and two or four NCCL
ranks take the one-card solve's iterations within 2 and its solution within
1e-10; a gloo group stages CUDA tensors through host memory and gives them
back on the card.  The profiler reader
(``utils/timing.py::device_profile``) reads a device spin as busy (share
>= 0.9), a host sleep between two launches as idle (>= 0.5), names both
df64 kernels once per apply, and raises when the profiler records no
device activity.  The tracer (``utils/trace.py``): a recorded span holds
its ``aten::mm`` and kernel on the profiler's clock within 50 us, and a
recorded training leaves the profiler's device records as they are.
"""

import dataclasses
import time

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
from mlff_tpu_torch.utils import trace  # noqa: E402

SIG = 10.0
BT_V, B_X = df64_gemv.LAUNCHES["bt_v"], df64_gemv.LAUNCHES["b_x"]
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
    before = trace.counter(fp.LAUNCHES)
    F_k, E_k = fp.desc_forces_fused(*args, SIG)
    F_r, E_r = fp.desc_forces_fused_ref(*args, SIG)
    torch.cuda.synchronize()
    assert trace.counter(fp.LAUNCHES) == before + 1
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
    before = trace.counter(fp.LAUNCHES)
    F_k, E_k = fp.desc_forces_fused(*args, SIG)
    F_r, E_r = fp.desc_forces_fused_ref(*args, SIG)
    torch.cuda.synchronize()
    assert trace.counter(fp.LAUNCHES) == before + 1
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
    before = trace.counter(fp.LAUNCHES)
    F_k, E_k = fp.desc_forces_fused(*args, SIG)
    F_r, E_r = fp.desc_forces_fused_ref(*args, SIG)
    torch.cuda.synchronize()
    assert trace.counter(fp.LAUNCHES) == before + 1
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


def _with_ksplit(p, n_ksplit: int, D: int):
    """``p`` with D cut into ``n_ksplit`` slices of whole stages (fewer where
    D has fewer stages) for every tile of pass 1."""
    steps = -(-D // p.geometry.depth)
    cols = -(-steps // min(n_ksplit, steps)) * p.geometry.depth
    n_ksplit = -(-D // cols)
    return dataclasses.replace(
        p, n_ksplit=n_ksplit, cols_per_slice=cols,
        n_whole=0 if n_ksplit > 1 else p.n_qtiles * p.n_mtiles)


@pytest.mark.parametrize("n_ksplit", [1, 2, 5, 9, 64])
@pytest.mark.parametrize("B", [1, 7])
@pytest.mark.parametrize("D", [130, 210, 3828])
def test_wide_kernel_at_each_split_of_d(by_wide_width, D, B, n_ksplit):
    """Pass 1 with every tile's D cut into 1, 2, 5, 9 or 64 slices (D = 130
    has 9 stages), ragged D and M (M not a multiple of the 64-row tile):
    within 1e-12 of the plain version, the same bits twice."""
    Xq, Xqt, wt = by_wide_width[D]
    args = (Xq[:B].contiguous(), Xqt, wt)
    p = _with_ksplit(fp.plan(B, Xqt.shape[0], D, fp._sm_count(0)), n_ksplit,
                     D)
    assert (p.n_ksplit > 1) == (n_ksplit > 1)
    lib = fp._library()
    F_k, E_k = fp._launch_wide(lib, *args, SIG, p)
    F_2, E_2 = fp._launch_wide(lib, *args, SIG, p)
    F_r, E_r = fp.desc_forces_fused_ref(*args, SIG)
    torch.cuda.synchronize()
    assert Xqt.shape[0] % 64 != 0
    assert _rel_err(F_k, F_r) <= 1e-12 and _rel_err(E_k, E_r) <= 1e-12
    assert torch.equal(F_k, F_2) and torch.equal(E_k, E_2)


@pytest.mark.parametrize("D,n_sm", [(210, 7), (3828, 4)])
def test_wide_kernel_splits_only_the_last_waves_tiles(by_wide_width, D,
                                                      n_sm):
    """513 queries against a ragged M, planned for a card of a few SMs:
    pass 1 runs whole waves of whole tiles and splits the tiles of the last
    wave; within 1e-12 of the plain version and of the unsplit plan."""
    Xq, Xqt, wt = by_wide_width[D]
    M = Xqt.shape[0]
    p = fp.wide_plan(513, M, D, n_sm)
    assert p.n_whole > 0 and p.n_tail > 0 and p.n_ksplit > 1
    lib = fp._library()
    F_k, E_k = fp._launch_wide(lib, Xq, Xqt, wt, SIG, p)
    F_1, E_1 = fp._launch_wide(lib, Xq, Xqt, wt, SIG, _with_ksplit(p, 1, D))
    F_r, E_r = fp.desc_forces_fused_ref(Xq, Xqt, wt, SIG)
    torch.cuda.synchronize()
    assert _rel_err(F_k, F_r) <= 1e-12 and _rel_err(E_k, E_r) <= 1e-12
    assert _rel_err(F_k, F_1) <= 1e-12 and _rel_err(E_k, E_1) <= 1e-12


def test_wide_kernel_chunks_the_queries(by_wide_width, monkeypatch):
    """A call whose weights pass the budget goes in chunks of queries, the
    last one ragged.  The weights' rows are M rounded up to even."""
    Xq, Xqt, wt = by_wide_width[210]
    M = Xqt.shape[0]
    monkeypatch.setattr(fp, "WIDE_WEIGHT_DOUBLES", 2 * 128 * (M + M % 2))
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
    assert fp.wide_geometry_matches(wide)
    assert wide[:10] + wide[12:] == fp.WIDE.library_tuple()
    assert min(wide[10:12]) >= fp.WIDE.blocks_per_sm


def _otf_counts():
    return [trace.counter(c) for c in (knl.OTF_FUSED, knl.OTF_TILES,
                                       fp.LAUNCHES)]


def _counted_since(before):
    return [now - b for now, b in zip(_otf_counts(), before)]


def test_otf_matvec_matches_the_cached_matvec(small):
    """The on-the-fly matvec on the card, all 300 rows in one call of the
    fused kernel (no tile loop), against the cached matvec at 1e-12."""
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
    before = _otf_counts()
    got = knl.matvec_psd(otf, v)
    assert _counted_since(before) == [1, 0, 1]
    assert _rel_err(got, knl.matvec_psd(cached, v)) <= 1e-12


def test_wide_otf_matvec_matches_the_plain_tile_loop(small):
    """A molecule past the narrow route (21 atoms, D = 210, a random
    geometry, N = 40, P = 1): the on-the-fly matvec on the card is one call
    of the wide route, within 1e-12 of the plain tile loop on the CPU on the
    same cache bits."""
    _, _, cached = _random_caches(n_atoms=21, n_train=40)
    otf_cpu = dataclasses.replace(cached, A_exp=None, A_exp1=None)
    otf = _cache_on(otf_cpu, "cuda")
    assert fp.geometry_for(otf.Xq.shape[1]) is fp.WIDE
    v = np.random.default_rng(6).normal(size=otf.n)
    before = _otf_counts()
    got = knl.matvec_psd(otf, torch.as_tensor(v, device="cuda"))
    assert _counted_since(before) == [1, 0, 1]
    want = knl.matvec_psd(otf_cpu, torch.as_tensor(v))
    assert _counted_since(before) == [1, 1, 1]
    assert _rel_err(got.cpu(), want) <= 1e-12


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
    before = trace.counter(fp.LAUNCHES)
    E_f, F_f = Predictor(model, fast=True).predict(ds["R"][held])
    assert trace.counter(fp.LAUNCHES) > before
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
    before = trace.counter(fp.LAUNCHES)
    E_f, F_f = Predictor(model, fast=True).predict(ds["R"][held])
    assert trace.counter(fp.LAUNCHES) > before
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
    before = trace.counter(df64_gemv.LAUNCHES[kernel])
    got = wrapper(Bh, Bl, vec)
    ref = plain(Bh, Bl, vec)
    torch.cuda.synchronize()
    assert trace.counter(df64_gemv.LAUNCHES[kernel]) == before + 1
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


@pytest.mark.parametrize("bad", ["misaligned", "non_contiguous"])
@pytest.mark.parametrize("kernel", ["bt_v", "b_x"])
def test_df64_kernel_takes_a_misaligned_or_non_contiguous_b(small, kernel,
                                                           bad):
    """A B that is not 16-byte aligned, or not contiguous, gives the same
    bits as the aligned contiguous B: the wrapper hands the kernel a copy."""
    n, m = 1030, 516
    gen = torch.Generator(device="cuda").manual_seed(9)
    B = torch.randn((n, m), generator=gen, dtype=torch.float64, device="cuda")
    Bh, Bl = df64.split_f64(B)
    if bad == "misaligned":
        flat = torch.zeros(n * m + 1, dtype=torch.float32, device="cuda")
        flat[1:] = Bh.reshape(-1)
        Bh_bad = flat[1:].view(n, m)
        assert Bh_bad.is_contiguous() and Bh_bad.data_ptr() % 16 != 0
    else:
        Bh_bad = torch.cat([Bh, Bh], dim=1)[:, :m]
        assert not Bh_bad.is_contiguous()
    vec = torch.randn(n if kernel == "bt_v" else m, generator=gen,
                      dtype=torch.float64, device="cuda")
    wrapper = getattr(df64_gemv, f"df64_{kernel}")
    before = trace.counter(df64_gemv.LAUNCHES[kernel])
    got = wrapper(Bh_bad, Bl, vec)
    want = wrapper(Bh, Bl, vec)
    torch.cuda.synchronize()
    assert trace.counter(df64_gemv.LAUNCHES[kernel]) == before + 2
    assert torch.equal(got, want)


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
    before = (trace.counter(BT_V), trace.counter(B_X))
    m_gpu = Trainer().train(task, **kw)
    assert trace.counter(BT_V) > before[0]
    assert trace.counter(B_X) > before[1]
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
    before = (trace.counter(BT_V), trace.counter(B_X))
    got = Pdf(v)
    torch.cuda.synchronize()
    assert trace.counter(BT_V) == before[0] + 1
    assert trace.counter(B_X) == before[1] + 1
    assert _rel_err(got, P64(v)) <= DF64_RTOL


def test_preconditioner_time_covers_the_device_work_it_queued(
        small, monkeypatch):
    """A device spin of known length queued as the build's last work is
    charged to ``total_time_preconditioner``: the build's clock stops on a
    synchronized device, not when the host has queued the work.  A first
    build pays the first-use costs, and the same build without the spin
    must take far less than the spin, or the check could not tell."""
    spec, c_gpu, _ = _random_caches()

    def build_s():
        _, _, info = tit.build_preconditioner(
            spec, c_gpu, "cholesky", 40, 1e-10, np.random.default_rng(7))
        return info["total_time_preconditioner"]

    build_s()
    plain_s = build_s()
    cycles = 1_000_000_000
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    spin_s = start.elapsed_time(end) / 1e3
    woodbury = tit.pc.woodbury_from_factor

    def woodbury_then_spin(*args, **kwargs):
        P = woodbury(*args, **kwargs)
        torch.cuda._sleep(cycles)
        return P

    monkeypatch.setattr(tit.pc, "woodbury_from_factor", woodbury_then_spin)
    assert plain_s < 0.5 * spin_s
    assert build_s() >= 0.9 * spin_s


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


@pytest.fixture(scope="module")
def nccl_mesh(small, tmp_path_factory):
    """A one-rank NCCL group in this process (file store), torn down after
    the module: the row-sharded operator's real collectives on CUDA
    tensors, with one card."""
    import torch.distributed as dist

    from mlff_tpu_torch.parallel import distributed as pdist
    from mlff_tpu_torch.parallel import mesh as pmesh

    store = tmp_path_factory.mktemp("nccl") / "store"
    pdist.init_distributed(backend="nccl", init_method=f"file://{store}",
                           world_size=1, rank=0)
    yield pmesh.make_mesh()
    dist.destroy_process_group()


def test_one_rank_nccl_sharded_matvec_matches_unsharded(nccl_mesh):
    """The sharded matvec through NCCL's all-gather equals the unsharded
    one (one rank: the same rows, the same sums)."""
    from mlff_tpu_torch.parallel import mesh as pmesh

    spec, c_gpu, _ = _random_caches()
    sh = pmesh.shard_cache(c_gpu, nccl_mesh)
    assert sh.shard.backend == "nccl" and sh.shard.world == 1
    v = torch.as_tensor(np.random.default_rng(9).normal(size=c_gpu.n),
                        device="cuda")
    calls = trace.counter("mesh.collectives")
    got = knl.matvec_psd(sh, pmesh.shard_vector(v, nccl_mesh))
    assert got.is_cuda and trace.counter("mesh.collectives") == calls + 1
    assert _rel_err(got, knl.matvec_psd(c_gpu, v)) <= 1e-12


@pytest.mark.parametrize("apply_impl", ["xla", "df64"])
def test_one_rank_nccl_sharded_apply_matches_unsharded(nccl_mesh,
                                                       apply_impl):
    """A Nystrom preconditioner built on the sharded cache (all-reduced
    Gram, K_mm gathered from its owner) applies as the unsharded one; the
    df64 form launches both kernels on its row slice."""
    from mlff_tpu_torch.parallel import mesh as pmesh
    from mlff_tpu_torch.solvers import preconditioners as tpc

    spec, c_gpu, _ = _random_caches()
    idxs = np.sort(np.random.default_rng(3).choice(c_gpu.n, 40,
                                                   replace=False))
    v = torch.as_tensor(np.random.default_rng(4).normal(size=c_gpu.n),
                        device="cuda")
    P = tpc.nystrom_preconditioner(spec, c_gpu, idxs, 1e-10,
                                   apply_impl=apply_impl)
    P_sh = tpc.nystrom_preconditioner(
        spec, pmesh.shard_cache(c_gpu, nccl_mesh), idxs, 1e-10,
        apply_impl=apply_impl)
    assert P_sh.layout is not None
    assert not P_sh.info["gram_guard_fired"]
    before = (trace.counter(BT_V), trace.counter(B_X))
    got = P_sh(v)
    torch.cuda.synchronize()
    if apply_impl == "df64":
        assert trace.counter(BT_V) == before[0] + 1
        assert trace.counter(B_X) == before[1] + 1
    assert _rel_err(got, P(v)) <= 1e-10


def test_gloo_group_stages_cuda_tensors(nccl_mesh):
    """A gloo group takes CUDA tensors through host memory: the results
    come back on the card, equal."""
    import torch.distributed as dist

    from mlff_tpu_torch.parallel import mesh as pmesh

    sh = pmesh.RowShard(dist.new_group(backend="gloo"))
    assert sh.backend == "gloo"
    t = torch.arange(6, dtype=torch.float64, device="cuda")
    got = sh.gather(t)
    assert got.is_cuda and torch.equal(got, t)
    assert torch.equal(sh.all_reduce(t), t) and torch.equal(t, torch.arange(
        6, dtype=torch.float64, device="cuda"))


# -- the profiler reader (utils/timing.py::device_profile) -------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the profiler reads the card")


def test_device_profile_reads_a_spin_as_busy(card):
    """One long device spin per call: the card is busy nearly the whole
    window, one launch per call."""
    from mlff_tpu_torch.utils.timing import device_profile

    prof = device_profile(torch, lambda: torch.cuda._sleep(50_000_000),
                          warmup=1, reps=3, device="cuda")
    assert prof["busy_share"] >= 0.9
    assert prof["device_busy_ms"] <= 1.05 * prof["window_ms"]
    assert prof["launches"] == 1


def test_device_profile_reads_a_host_sleep_as_idle(card):
    """Two tiny launches with 10 ms of host sleep between them: the card
    waits most of the window."""
    from mlff_tpu_torch.utils.timing import device_profile

    x = torch.zeros(16, device="cuda")

    def call():
        x.add_(1.0)
        time.sleep(0.01)
        x.add_(1.0)
        return x

    prof = device_profile(torch, call, warmup=1, reps=3)
    assert prof["idle_share"] >= 0.5
    assert prof["launches"] == 2


def test_device_profile_names_the_df64_kernels(card):
    """One df64 apply: both hand-written kernels appear among the top
    kernels, once each per call."""
    from mlff_tpu_torch.solvers import preconditioners as pc
    from mlff_tpu_torch.utils.timing import device_profile

    rng = np.random.default_rng(2)
    n, m = 4099, 256
    P = pc.WoodburySplitPreconditioner(
        B=torch.as_tensor(rng.normal(size=(n, m)) / np.sqrt(n),
                          device="cuda"),
        W2=torch.as_tensor(rng.normal(size=(m, m)) / m, device="cuda"),
        lam=1e-10, info={})
    P64 = pc.df64_from_split(P)
    v = torch.as_tensor(rng.normal(size=n), device="cuda")
    prof = device_profile(torch, lambda: pc.df64_woodbury_apply(P64, v),
                          warmup=1, reps=1)
    names = {k["name"]: k["calls"] for k in prof["top_kernels"]}
    for kernel in df64_gemv.KERNEL_NAMES.values():
        assert [c for name, c in names.items() if kernel in name] == [1.0]


def test_device_profile_raises_without_device_activity(card, monkeypatch):
    """A profile that records no device activity raises: it never reads as
    an idle card."""
    from mlff_tpu_torch.utils import timing

    monkeypatch.setattr(timing, "_device_events", lambda prof: [])
    x = torch.zeros(16, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA activity"):
        timing.device_profile(torch, lambda: x.add_(1.0), warmup=1, reps=2)


# -- the tracer (utils/trace.py) on the profiler's clock ---------------------

SHARED_CLOCK_S = 50e-6


def _kineto_events(prof):
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())
    on_card = [e for e in events if e.device_type() == DeviceType.CUDA]
    return [e for e in events if e not in on_card], on_card


def test_recorded_span_holds_its_profiler_records(card):
    """A recorded span around a matmul that ends in a synchronize holds, on
    the profiler's Unix-epoch clock, the host record of its ``aten::mm``
    and the end of its device kernel, within 50 us."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(2048, 2048, dtype=torch.float64, device="cuda")
    a @ a
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with trace.recording() as rec:
            with trace.span("mm"):
                a @ a
                torch.cuda.synchronize()
    (s,) = rec.named("mm")
    lo = rec.epoch(s.start) - SHARED_CLOCK_S
    hi = rec.epoch(s.end) + SHARED_CLOCK_S
    host, on_card = _kineto_events(prof)
    (mm,) = [e for e in host if e.name() == "aten::mm"]
    kernels = [e for e in on_card
               if not e.name().startswith(("Memcpy", "Memset"))]
    assert kernels
    assert lo <= mm.start_ns() * 1e-9 and mm.end_ns() * 1e-9 <= hi
    for e in kernels:
        assert lo <= e.end_ns() * 1e-9 <= hi, (
            e.name(), e.end_ns() * 1e-9 - rec.epoch(s.end))


def test_recording_leaves_the_profiled_device_records_as_they_are(card):
    """``devtrace.profile`` of a recorded training holds the same device
    record names, each as often, as one of the same training not
    recorded: no span reaches the device's timeline."""
    import collections

    from benchmark import devtrace

    ds, perms = make_benchmark_dataset("ethanol", n_samples=70, seed=11,
                                       n_train=30)
    task = create_task(ds, 30, ds, n_valid=5, sig=SIG, solver="cg",
                       perms=perms)
    tr = Trainer()
    kw = dict(n_columns=200, str_preconditioner="lev_random")
    tr.train(task, **kw)

    def recorded():
        with trace.recording():
            tr.train(task, **kw)

    def names(t):
        return collections.Counter(n for n, _, _ in t.device)

    plain = devtrace.profile(torch, lambda: tr.train(task, **kw))
    assert names(devtrace.profile(torch, recorded)) == names(plain)


def test_profiled_device_records_carry_their_launch(card):
    """``benchmark/spans.py``'s profile links every device record of a
    recorded training to the host call that launched it, and each launch
    lies inside the training's request span on the shared clock."""
    from benchmark import spans

    ds, perms = make_benchmark_dataset("ethanol", n_samples=70, seed=11,
                                       n_train=30)
    task = create_task(ds, 30, ds, n_valid=5, sig=SIG, solver="cg",
                       perms=perms)
    tr = Trainer()
    kw = dict(n_columns=200, str_preconditioner="lev_random")
    tr.train(task, **kw)
    held = {}

    def recorded():
        with trace.recording() as rec:
            tr.train(task, **kw)
        held["rec"] = rec

    profiled, launched = spans.profile(torch, recorded)
    rec = held["rec"]
    (root,) = rec.roots()
    lo = rec.epoch(root.start) - SHARED_CLOCK_S
    hi = rec.epoch(root.end) + SHARED_CLOCK_S
    assert len(launched) == len(profiled.device) > 0
    assert all(t is not None and lo <= t <= hi for t in launched)


# -- the PCG iteration replayed as a CUDA graph (solvers/cg.py) --------------

GRAPH_SLACK_BYTES = 16 * 2**20


def _eager(monkeypatch):
    """Every later solve in the test runs the eager step on the card."""
    from mlff_tpu_torch.solvers import cg

    monkeypatch.setattr(cg, "_graphed", lambda b, layout: False)


def _graph_counts():
    from mlff_tpu_torch.solvers import cg

    return trace.counter(cg.GRAPH_CAPTURES), trace.counter(cg.GRAPH_ITERS)


def _calibrated_task(n_train=30, **options):
    ds, perms = make_benchmark_dataset("ethanol", n_samples=n_train + 40,
                                       seed=11, n_train=n_train)
    task = create_task(ds, n_train, ds, n_valid=5, sig=SIG, solver="cg",
                       perms=perms)
    task.update(options)
    return task


def test_graphed_chunks_match_the_eager_run(card, monkeypatch):
    """On the calibrated test task with its Nystrom preconditioner, three
    chunks of 25 from one state: the first (warm-up, capture, 24 replays)
    and the next two replayed give the eager step's iterate, residual and
    log bit for bit, and the counters count 74 replayed iterations."""
    from mlff_tpu_torch.solvers import cg

    task = _calibrated_task()
    tr = Trainer()
    spec, S, X, Jc, P_idx = tr.build_kernel_inputs(task)
    cache = knl.build_cache(X, Jc, S, P_idx, SIG, task["lam"],
                            device="cuda")
    P, _, _ = tit.build_preconditioner(spec, cache, "lev_random", 200,
                                       task["lam"],
                                       np.random.default_rng(7))
    b = torch.as_tensor(np.asarray(task["F_train"]).ravel(), device="cuda")
    b = b / torch.linalg.norm(b)

    def three_chunks():
        solver = cg.PCGSolver(lambda v: knl.matvec_psd(cache, v), P,
                              chunk=25)
        state = cg.CGState(
            x=torch.zeros_like(b), r=b.clone(), p=torch.zeros_like(b),
            rho=torch.ones((), dtype=b.dtype, device="cuda"),
            resid=torch.linalg.norm(b),
            it=torch.zeros((), dtype=torch.int64, device="cuda"),
            done=torch.zeros((), dtype=torch.bool, device="cuda"))
        logs = []
        threshold = torch.zeros((), dtype=b.dtype, device="cuda")
        for _ in range(3):
            state, log = solver._run(state, threshold, 25)
            logs.append(log.clone())
        return state, torch.cat(logs)

    before = _graph_counts()
    got, got_log = three_chunks()
    torch.cuda.synchronize()
    assert _graph_counts()[0] == before[0] + 1
    _eager(monkeypatch)
    want, want_log = three_chunks()
    assert int(got.it) == int(want.it) == 75
    assert torch.equal(got.x, want.x) and torch.equal(got.r, want.r)
    assert torch.equal(got_log, want_log)


def test_graphed_training_matches_eager(card, monkeypatch):
    """A whole ``Trainer.train``: one capture, every iteration but the
    warm-up replayed, and the eager training's iterations and residual."""
    task = _calibrated_task()
    kw = dict(n_columns=200, str_preconditioner="lev_random")
    tr = Trainer()
    tr.train(task, **kw)
    before = _graph_counts()
    graphed = tr.train(task, **kw)
    captures, replayed = (a - b for a, b in zip(_graph_counts(), before))
    iters = int(graphed["solver_iters"])
    assert (captures, replayed) == (1, iters - 1) and iters > 25
    _eager(monkeypatch)
    eager = tr.train(task, **kw)
    assert _graph_counts()[0] == before[0] + 1
    assert int(eager["solver_iters"]) == iters
    assert float(eager["solver_resid"]) == float(graphed["solver_resid"])


def test_graphed_df64_training_counts_every_replayed_kernel(card,
                                                            monkeypatch):
    """``apply_impl="df64"``: the df64 kernels counted in a graphed training
    equal those of the eager one (the capture's own counts are taken back
    out, and each replay's added)."""
    task = _calibrated_task(apply_impl="df64")
    kw = dict(n_columns=200, str_preconditioner="lev_random")
    tr = Trainer()
    tr.train(task, **kw)

    def launches():
        before = (trace.counter(BT_V), trace.counter(B_X))
        model = tr.train(task, **kw)
        return (trace.counter(BT_V) - before[0],
                trace.counter(B_X) - before[1], int(model["solver_iters"]))

    graphed = launches()
    _eager(monkeypatch)
    eager = launches()
    assert graphed == eager and eager[0] > eager[2]


def test_graphed_solve_memory_holds_over_trainings(card, monkeypatch):
    """The peak allocated memory of a graphed training is the eager one's
    within 16 MB, and ten graphed trainings back to back leave allocated
    and reserved memory where the first left them (16 MB of room)."""
    task = _calibrated_task(n_train=400)
    kw = dict(n_columns=800, str_preconditioner="lev_random")
    tr = Trainer()
    tr.train(task, **kw)

    def trained():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tr.train(task, **kw)
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated(),
                torch.cuda.memory_allocated(), torch.cuda.memory_reserved())

    runs = [trained() for _ in range(10)]
    with monkeypatch.context() as m:
        _eager(m)
        eager_peak = trained()[0]
    assert abs(runs[0][0] - eager_peak) <= GRAPH_SLACK_BYTES
    for peak, allocated, reserved in runs[1:]:
        assert peak <= runs[0][0] + GRAPH_SLACK_BYTES
        assert allocated <= runs[0][1] + GRAPH_SLACK_BYTES
        assert reserved <= runs[0][2] + GRAPH_SLACK_BYTES


def _otf_system():
    """(CPU on-the-fly cache, its Nystrom preconditioner, b; the same cache
    and preconditioner bits on the card): ethanol at lam = 1e-5 with 20
    Nystrom columns, b the normalized forces."""
    from mlff_tpu_torch.solvers import preconditioners as tpc

    ds = make_dataset("ethanol", n_samples=30, seed=3)
    spec = dsc.make_spec(9)
    X, Jc = dsc.descriptors_from_R(spec, torch.as_tensor(ds["R"]))
    otf_cpu = knl.build_cache(X, Jc, dsc.incidence_matrix(spec, device="cpu"),
                              dsc.desc_perms(benchmark_perms("ethanol")),
                              SIG, 1e-5, pairwise=False, device="cpu")
    P_cpu = tpc.nystrom_preconditioner(spec, otf_cpu, _otf_columns(otf_cpu.n),
                                       otf_cpu.lam)
    P = dataclasses.replace(P_cpu, B=P_cpu.B.cuda(), W2=P_cpu.W2.cuda())
    b = torch.as_tensor(np.asarray(ds["F"]).ravel())
    return otf_cpu, P_cpu, b / torch.linalg.norm(b), _cache_on(otf_cpu,
                                                               "cuda"), P


def _otf_columns(n):
    return np.sort(np.random.default_rng(3).choice(n, 20, replace=False))


def test_graphed_otf_solve_matches_the_plain_loop(card):
    """A one-card PCG solve on an on-the-fly cache captures and replays the
    fused kernel (its scratch is made in the eager warm-up, outside the
    capture), and takes the iterations of the same solve through the plain
    tile loop on the CPU, on the same cache and preconditioner bits, within
    2; the solutions agree within 1e-10 relative.  lam = 1e-5 and 20
    Nystrom columns give ~13 iterations of a system conditioned well enough
    that rounding moves the solution ~1e-13 (a CPU run with 1e-15 relative
    noise on every matvec entry: 3.4e-13); at lam = 1e-10 the same noise
    moves it ~2e-9."""
    from mlff_tpu_torch.solvers import cg

    otf_cpu, P_cpu, b, otf, P = _otf_system()
    graph_before, before = _graph_counts(), _otf_counts()
    got = cg.pcg(lambda u: knl.matvec_psd(otf, u), b.cuda(), precon=P,
                 tol=1e-8)
    captures, replayed = (a - c for a, c in zip(_graph_counts(),
                                                graph_before))
    fused, tiles, launches = _counted_since(before)
    want = cg.pcg(lambda u: knl.matvec_psd(otf_cpu, u), b, precon=P_cpu,
                  tol=1e-8)
    assert got.converged and want.converged and want.num_iters > 5
    assert (captures, replayed) == (1, got.num_iters - 1)
    assert fused == launches > got.num_iters and tiles == 0
    assert abs(got.num_iters - want.num_iters) <= 2
    assert np.abs(got.x - want.x).max() <= 1e-10 * np.abs(want.x).max()


# the row-sharded systems a sharded training solves: the pairwise cache
# with the f64 and the df64 apply, the on-the-fly cache, the square layout
SHARDED_SYSTEMS = ("cached", "df64", "otf", "square")


def _sharded_system(system, mesh):
    """``system`` on the card and on the one-rank ``mesh``: ((sharded
    matvec, b, preconditioner, layout), (unsharded matvec, b,
    preconditioner), tol).  The random pairwise cache with a 40-column
    Nystrom preconditioner built on it (lam = 1e-10; f64 or df64 apply), the
    on-the-fly system of ``_otf_system``, or the catcher's square layout with
    a 200-column preconditioner built on its packed cache (lam = 1e-10), as
    ``solvers/iterative.py`` builds it; b random but on the on-the-fly
    system."""
    from mlff_tpu_torch.parallel import mesh as pmesh
    from mlff_tpu_torch.solvers import preconditioners as tpc

    def psd(cache):
        return lambda u: knl.matvec_psd(cache, u)

    if system == "otf":
        _, _, b, cache, P = _otf_system()
        sh = pmesh.shard_cache(cache, mesh)
        b = b.cuda()
        return ((psd(sh), pmesh.shard_vector(b, mesh),
                 pmesh.shard_preconditioner(P, mesh), knl.vector_layout(sh)),
                (psd(cache), b, P), 1e-8)
    if system == "square":
        ds, _ = make_benchmark_dataset("catcher", n_samples=6, seed=11,
                                       n_train=119)
        spec, perms = dsc.make_spec(88), np.arange(88)[None]
        R = torch.as_tensor(ds["R"], device="cuda")
        X, Jc = dsc.descriptors_from_R(spec, R)
        cache = knl.build_cache(X, Jc, dsc.incidence_matrix(spec,
                                                            device="cuda"),
                                dsc.desc_perms(perms), SIG, 1e-10, R=R,
                                device="cuda")
        sq = knl.build_cache_square(R, perms, SIG, 1e-10, device="cuda")
        sq_sh = pmesh.shard_square_cache(sq, mesh)
        matvecs = (lambda u: knl.matvec_psd_square(sq_sh, u),
                   lambda u: knl.matvec_psd_square(sq, u))
        k, apply_impl = 200, "xla"
    else:
        spec, cache, _ = _random_caches()
        k, apply_impl = 40, "xla" if system == "cached" else "df64"
    sh = pmesh.shard_cache(cache, mesh)
    if system != "square":
        matvecs = psd(sh), psd(cache)
    idxs = np.sort(np.random.default_rng(3).choice(cache.n, k,
                                                   replace=False))
    b = torch.as_tensor(np.random.default_rng(4).normal(size=cache.n),
                        device="cuda")
    P_sh, P = (tpc.nystrom_preconditioner(spec, c, idxs, 1e-10,
                                          apply_impl=apply_impl)
               for c in (sh, cache))
    return ((matvecs[0], pmesh.shard_vector(b, mesh), P_sh,
             knl.vector_layout(sh)), (matvecs[1], b, P), 1e-4)


@pytest.mark.parametrize("system", SHARDED_SYSTEMS)
def test_one_rank_nccl_sharded_solve_is_graphed(card, nccl_mesh,
                                                monkeypatch, system):
    """A row-sharded solve on the card (one NCCL rank) is captured with its
    collectives, on every operator a sharded training solves with
    (``_sharded_system``): one capture and every iteration but the warm-up
    replayed.  It gives the eager sharded solve's iterations and iterate
    bit for bit, and its counts of collectives, fused matvecs and df64
    kernels.  A recording of the solve keeps the ``matvec.otf``,
    ``precon.apply`` and ``mesh.collective`` spans of the calls that ran
    (the first residual's matvec and the warm-up) and none of the
    capture's, whose replays open none.  It takes the unsharded graphed
    solve's iterations within 2, and on the on-the-fly cache of
    ``test_graphed_otf_solve_matches_the_plain_loop`` (lam = 1e-5) its
    solution within 1e-10 relative."""
    from mlff_tpu_torch.solvers import cg

    (matvec, b_sh, P_sh, layout), (matvec_w, b, P), tol = _sharded_system(
        system, nccl_mesh)
    counters = ("mesh.collectives", knl.OTF_FUSED, BT_V, B_X,
                cg.GRAPH_CAPTURES, cg.GRAPH_ITERS)

    def solve():
        before = [trace.counter(c) for c in counters]
        with trace.recording() as rec:
            res = cg.pcg(matvec, b_sh, precon=P_sh, layout=layout, tol=tol)
        counted = {c: trace.counter(c) - n for c, n in zip(counters, before)}
        spans = {name: len(rec.named(name))
                 for name in ("matvec.otf", "precon.apply", "mesh.collective")}
        steps = sum(s.attrs["steps"] for s in rec.named("cg.chunk"))
        return res, counted, spans, steps

    got, counted, spans, steps = solve()
    assert got.converged and got.num_iters > 5
    assert counted[cg.GRAPH_CAPTURES] == 1
    assert counted[cg.GRAPH_ITERS] == got.num_iters - 1
    with monkeypatch.context() as m:
        _eager(m)
        eager, eager_counted, eager_spans, eager_steps = solve()
    assert (eager.num_iters, eager_steps) == (got.num_iters, steps)
    assert np.array_equal(eager.x, got.x)
    assert eager_counted == dict(counted, **{cg.GRAPH_CAPTURES: 0,
                                             cg.GRAPH_ITERS: 0})
    assert eager_spans["mesh.collective"] == counted["mesh.collectives"]
    # every step queued runs its matvec and its apply, the masked ones past
    # convergence too: the first residual's matvec, then one of each per
    # step; the df64 apply opens no span
    if system == "otf":
        assert counted[knl.OTF_FUSED] == 1 + steps
    if system == "df64":
        assert counted[BT_V] == counted[B_X] == steps
    # per step: its on-the-fly matvec, its f64 apply and five collectives
    # (the all-gather of w, the apply's all-reduce, three dot products)
    per_step = {"matvec.otf": int(system == "otf"),
                "precon.apply": int(system != "df64"), "mesh.collective": 5}
    for name, n in per_step.items():
        assert spans[name] == eager_spans[name] - n * (steps - 1), name
    assert spans["precon.apply"] == per_step["precon.apply"]
    assert spans["matvec.otf"] == 2 * per_step["matvec.otf"]
    want = cg.pcg(matvec_w, b, precon=P, tol=tol)
    assert abs(got.num_iters - want.num_iters) <= 2
    if system == "otf":
        assert np.abs(got.x - want.x).max() <= 1e-10 * np.abs(want.x).max()


def test_nccl_ranks_replay_the_sharded_solve_of_one_card(card):
    """Two or four NCCL ranks, one card each (``tests/torch_dist_worker.py``,
    scenario ``otf_pcg``): the graphed sharded PCG on an on-the-fly cache
    captures once on every rank, replays every iteration but the warm-up,
    and takes the one-card graphed solve's iterations within 2 and its
    solution within 1e-10 relative (lam = 1e-5, N = 40: a CPU solve with
    1e-15 relative noise on every matvec entry moves the solution 1e-13 to
    5e-13; at N = 32 the same noise moves it ~1e-10, too near the limit to
    tell the graph from rounding)."""
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two cards: NCCL refuses two ranks on one card")
    from .torch_dist_worker import run_group

    ds = make_dataset("ethanol", n_samples=40, seed=3)
    b = np.asarray(ds["F"]).ravel()
    ranks = run_group(4 if cards >= 4 else 2, [("otf_pcg", dict(
        R=np.asarray(ds["R"]), perms=benchmark_perms("ethanol"),
        b=b / np.linalg.norm(b), idxs=_otf_columns(b.size), sig=SIG))],
        backend="nccl")
    whole = ranks[0]["otf_pcg"]["whole"]
    assert whole["converged"] and whole["iters"] > 5
    assert (whole["captures"], whole["replayed"]) == (1, whole["iters"] - 1)
    for rank in ranks:
        got = rank["otf_pcg"]["sharded"]
        assert rank["otf_pcg"]["backend"] == "nccl" and got["converged"]
        assert (got["captures"], got["replayed"]) == (1, got["iters"] - 1)
        assert abs(got["iters"] - whole["iters"]) <= 2
        assert (np.abs(got["x"] - whole["x"]).max()
                <= 1e-10 * np.abs(whole["x"]).max())
