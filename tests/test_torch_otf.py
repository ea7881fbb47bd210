"""The on-the-fly (OTF) matvec of the port against the JAX package's.

Above 3 GB of (N, M) pairwise caches both packages build the kernel cache
with ``pairwise=False`` and recompute the weights per row tile of the
matvec.  Here the port's ``_otf_tile`` is held to the JAX rule on a grid of
(N, M), its 128-row floor and its warning included; the OTF matvec to the
JAX OTF matvec and to the port's cached one with the tile patched down to
the floor (several tiles, a ragged last one); off the card, and for an f32
copy, the plain tile loop and its counter (the card's f64 matvec goes
through the fused kernel, ``tests/test_torch_cuda.py``); ``matmat_psd``
and the chunked Woodbury apply to their JAX counterparts; a small
training with the cache switch forced to OTF to the cached training and to
the JAX package's OTF training; and the routes to the one contraction
(``ops/kernel.py::pair_weights`` and ``desc_forces``) to each other, bit
for bit.

Tolerances: the matvecs are f64 against f64 with the summation order as
the only difference, 1e-12 relative to the largest entry; the chunked apply
1e-10 relative to its 1/lam-amplified result (``tests/test_kernel.py``);
the trainings draw the same columns, take the same number of iterations and
predict held-out forces within 1e-4 of max |F|, the solve's tolerance.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mlff_tpu.data.synthetic import (  # noqa: E402
    benchmark_perms, make_benchmark_dataset, make_dataset)
from mlff_tpu.models.gdml import Trainer as JaxTrainer  # noqa: E402
from mlff_tpu.models.task import create_task  # noqa: E402
from mlff_tpu.ops import descriptor as jd  # noqa: E402
from mlff_tpu.ops import kernel as jk  # noqa: E402
from mlff_tpu.solvers import preconditioners as jpc  # noqa: E402
from mlff_tpu_torch.convert import kernel_cache_from_numpy  # noqa: E402
from mlff_tpu_torch.models.gdml import Trainer  # noqa: E402
from mlff_tpu_torch.models.predict import Predictor  # noqa: E402
from mlff_tpu_torch.ops import descriptor as td  # noqa: E402
from mlff_tpu_torch.ops import fused_predict as fp  # noqa: E402
from mlff_tpu_torch.ops import kernel as tk  # noqa: E402
from mlff_tpu_torch.solvers import preconditioners as tpc  # noqa: E402
from mlff_tpu_torch.utils import trace  # noqa: E402

MATVEC_RTOL = 1e-12
SIG, LAM = 10.0, 1e-10
N_OTF = 300       # > 2 tiles of the 128-row floor: tiles 128, 128, 44


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def caches():
    """Calibrated ethanol, N = 300, P = 6 (M = 1800): the JAX cached and
    OTF caches, the port's OTF cache built by the port and its cached one
    from the JAX fields."""
    ds, perms = make_benchmark_dataset("ethanol", n_samples=N_OTF, seed=11,
                                       n_train=N_OTF)
    spec_j = jd.make_spec(9)
    X, Jc = jd.descriptors_from_R(spec_j, jnp.asarray(ds["R"]))
    P = jnp.asarray(jd.desc_perms(perms), dtype=jnp.int32)
    S = jd.incidence_matrix(spec_j)
    cj = jk.build_cache(X, Jc, S, P, SIG, LAM)
    cj_otf = jk.build_cache(X, Jc, S, P, SIG, LAM, pairwise=False)
    spec_t = td.make_spec(9)
    Xt, Jct = td.descriptors_from_R(spec_t, torch.as_tensor(ds["R"]))
    ct_otf = tk.build_cache(Xt, Jct, td.incidence_matrix(spec_t),
                            td.desc_perms(perms), SIG, LAM, pairwise=False,
                            device="cpu")
    ct = kernel_cache_from_numpy(
        {k: (None if getattr(cj, k) is None else np.asarray(getattr(cj, k)))
         for k in ("X", "Jc", "S", "P_idx", "Xq", "Xqt", "A_exp", "A_exp1",
                   "sig", "lam")}, device="cpu")
    return cj, cj_otf, ct, ct_otf


OTF_GRID = [(N, M) for N in (1, 100, 1166, 5833, 20000)
            for M in (700, 6996, 34998, 300000)]


@pytest.mark.parametrize("N,M", OTF_GRID, ids=[f"N{n}-M{m}" for n, m in OTF_GRID])
def test_otf_tile_is_the_jax_rule(N, M):
    assert tk._OTF_TILE == jk._OTF_TILE
    assert tk._OTF_TILE_BUDGET == jk._OTF_TILE_BUDGET
    assert tk._otf_tile(N, M) == jk._otf_tile(N, M)


def test_otf_tile_floor_warns(caplog):
    """M = 300,000 columns leave the budget below one 128-row tile: the tile
    stays 128 and the port warns, as the JAX package does."""
    with caplog.at_level(logging.WARNING):
        assert tk._otf_tile(5000, 300000) == 128
    assert any("128-row tile floor exceeds the transient budget" in r.message
               for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        assert tk._otf_tile(5000, 6996) == 4096
    assert not caplog.records


def test_otf_cache_carries_no_pairwise_fields(caches):
    cj, cj_otf, _, ct_otf = caches
    assert cj_otf.A_exp is None and ct_otf.A_exp is None
    assert ct_otf.A_exp1 is None
    for name in ("X", "Jc", "Xq", "Xqt"):
        assert _rel(getattr(ct_otf, name), getattr(cj, name)) <= MATVEC_RTOL


@pytest.mark.parametrize("tile", [None, 128])
def test_otf_matvec_matches_jax_and_the_cached_matvec(caches, monkeypatch,
                                                      tile):
    """tile None: the rule's tile (one tile of all 300 rows); 128: three
    tiles, the last 44 rows long."""
    cj, cj_otf, ct, ct_otf = caches
    if tile is not None:
        monkeypatch.setattr(tk, "_OTF_TILE", tile)
        assert tk._otf_tile(N_OTF, ct_otf.Xqt.shape[0]) == tile
    v = np.random.default_rng(2).normal(size=ct.n)
    got = tk.matvec_psd(ct_otf, torch.as_tensor(v)).numpy()
    assert _rel(got, tk.matvec_psd(ct, torch.as_tensor(v))) <= MATVEC_RTOL
    assert _rel(got, jk.matvec_psd(cj_otf, jnp.asarray(v))) <= MATVEC_RTOL
    assert _rel(got, jk.matvec_psd(cj, jnp.asarray(v))) <= MATVEC_RTOL


@pytest.mark.parametrize("tile,tiles", [(None, 1), (128, 3)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_otf_matvec_off_the_card_runs_the_tile_loop(caches, monkeypatch,
                                                    dtype, tile, tiles):
    """A CPU cache, and its f32 ``downcast_cache`` copy, keep the plain tile
    loop: ``OTF_TILES`` counts the rule's tiles (one of all 300 rows, or
    128, 128, 44), and the fused kernel's counters do not move."""
    ct_otf = caches[3]
    cache = ct_otf if dtype == torch.float64 else tk.downcast_cache(ct_otf)
    if tile is not None:
        monkeypatch.setattr(tk, "_OTF_TILE", tile)
    counters = (tk.OTF_TILES, tk.OTF_FUSED, fp.LAUNCHES)
    before = [trace.counter(c) for c in counters]
    v = torch.as_tensor(np.random.default_rng(5).normal(size=ct_otf.n))
    out = tk.matvec_psd(cache, v)
    got = [trace.counter(c) - b for c, b in zip(counters, before)]
    assert cache.Xq.dtype == dtype and out.dtype == torch.float64
    assert got == [tiles, 0, 0]


@pytest.mark.parametrize("kind", ["cached", "otf"])
def test_matmat_psd_matches_jax(caches, kind):
    cj, _, ct, ct_otf = caches
    V = np.random.default_rng(4).normal(size=(ct.n, 5))
    got = tk.matmat_psd(ct if kind == "cached" else ct_otf,
                        torch.as_tensor(V)).numpy()
    want = np.asarray(jk.matmat_psd(cj, jnp.asarray(V)))
    assert got.shape == V.shape
    assert _rel(got, want) <= MATVEC_RTOL


@pytest.mark.parametrize("chunk", [128, 333, 1000, 4096])
def test_chunked_woodbury_apply_matches_jax(chunk):
    """n = 1000 rows in chunks with a ragged last one (128, 333), one chunk
    (1000) and a chunk longer than B (4096)."""
    rng = np.random.default_rng(0)
    n, m = 1000, 64
    B = rng.standard_normal((n, m))
    W2 = np.triu(rng.standard_normal((m, m))) * 0.1
    v = rng.standard_normal(n)
    Pj = jpc.WoodburySplitPreconditioner(B=jnp.asarray(B), W2=jnp.asarray(W2),
                                         lam=jnp.asarray(1e-8))
    want = np.asarray(jpc._woodbury_split_apply_chunked(Pj, jnp.asarray(v),
                                                        chunk=chunk))
    Pt = tpc.WoodburySplitPreconditioner(B=torch.as_tensor(B),
                                         W2=torch.as_tensor(W2), lam=1e-8,
                                         info={})
    got = tpc._woodbury_split_apply_chunked(Pt, torch.as_tensor(v),
                                            chunk=chunk).numpy()
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    plain = tpc.woodbury_split_apply(Pt, torch.as_tensor(v)).numpy()
    assert np.abs(got - plain).max() <= 1e-10 * np.abs(plain).max()


@pytest.fixture(scope="module")
def trainings():
    """N = 30 ethanol geometries of the plain generator (a well-conditioned
    kernel, ~15 iterations), k = 200 lev_random: the port cached, the port
    OTF and the JAX OTF training (the cache switch forced off)."""
    ds = make_dataset("ethanol", n_samples=40, seed=3)
    ds["z"] = np.asarray([6, 6, 8, 1, 1, 1, 1, 1, 1])
    perms = benchmark_perms("ethanol")
    task = create_task(ds, 30, ds, n_valid=5, sig=SIG, solver="cg",
                       perms=perms)
    kw = dict(n_columns=200, str_preconditioner="lev_random")
    held = np.setdiff1d(np.arange(40), task["idxs_train"])
    mp = pytest.MonkeyPatch()
    try:
        m_cached = Trainer(device="cpu").train(task, **kw)
        mp.setattr(tk, "pairwise_fits", lambda n_train, n_perms: False)
        off = staticmethod(lambda n_train, n_perms: False)
        mp.setattr(JaxTrainer, "_pairwise_fits", off)
        m_otf = Trainer(device="cpu").train(task, **kw)
        m_jax_otf = JaxTrainer().train(task, **kw)
    finally:
        mp.undo()
    return m_cached, m_otf, m_jax_otf, ds["R"][held]


@pytest.mark.parametrize("other", ["port_cached", "jax_otf"])
def test_otf_training_takes_the_same_iterations(trainings, other):
    """Same columns, same iterations, and held-out forces within 1e-4 of
    max |F|, the solve's own tolerance (the lam = 1e-10 coefficients
    themselves are determined to ~1e-5 only, see
    tests/test_torch_train_e2e.py)."""
    m_cached, m_otf, m_jax_otf, R_held = trainings
    m = m_cached if other == "port_cached" else m_jax_otf
    assert m_otf["is_conv"] and m["is_conv"]
    np.testing.assert_array_equal(m_otf["inducing_pts_idxs"],
                                  m["inducing_pts_idxs"])
    assert m_otf["solver_iters"] == m["solver_iters"]
    _, F_otf = Predictor(m_otf, device="cpu").predict(R_held)
    _, F = Predictor(m, device="cpu").predict(R_held)
    assert np.abs(F_otf - F).max() <= 1e-4 * np.abs(F).max()


def _ecstr_matvec_written_out(cache, v):
    """The energy-constrained matvec composed step by step from the cache's
    fields: the descriptor-force contraction, then the energy-coefficient
    force and energy terms (reference predict.py:207-218)."""
    N, A, P = cache.n_train, cache.S.shape[1], cache.n_perms
    q = tk.SQRT5 / cache.sig
    v_F, v_E = v[:N * A * 3], v[N * A * 3:]
    dist = cache.A_exp1 / cache.A_exp - 1.0
    K_ee = (1.0 + dist * (1.0 + dist / 3.0)) * (
        cache.A_exp * (3.0 * cache.sig**2 / 5.0))
    w = td.d_desc_dot_vec(cache.Jc, cache.S, v_F.reshape(N, A, 3))
    wt = tk.perm_expand_w(w, cache.P_idx)
    vE_lin = torch.repeat_interleave(v_E, P)
    dot = cache.Xq @ wt.T - torch.sum(cache.Xqt * wt, dim=-1)[None, :]
    G = cache.A_exp * dot
    F = (cache.Xq * torch.sum(G, dim=-1, keepdim=True) - G @ cache.Xqt
         - cache.A_exp1 @ wt)
    e_out = torch.sum(cache.A_exp1 * dot, dim=-1) / q
    H = cache.A_exp1 * vE_lin[None, :]
    F = F + (cache.Xq * torch.sum(H, dim=1, keepdim=True) - H @ cache.Xqt) / q
    out_F = td.vec_dot_d_desc(cache.Jc, cache.S, F)
    e_out = e_out + K_ee @ vE_lin
    return torch.cat([out_F.reshape(-1), -e_out])


@pytest.mark.parametrize("case", ["otf_one_tile", "fused_ref_is_predictor",
                                  "ecstr_energy_terms"])
def test_one_contraction_gives_the_same_bits(caches, trainings, case):
    """The three routes to the one Matern contraction agree bit for bit on
    the CPU: (otf_one_tile) the plain on-the-fly matvec, its one tile
    covering every row, against the cached ``matvec_ref`` built from the
    same inputs; (fused_ref_is_predictor) ``Predictor(fast=True)``, whose
    CPU route is ``desc_forces_fused_ref``, against the f64 Predictor;
    (ecstr_energy_terms) ``matvec_ref_ecstr`` against the contraction and
    its energy-coefficient terms written out step by step."""
    ct_otf = caches[3]
    cached = tk.build_cache(ct_otf.X, ct_otf.Jc, ct_otf.S, ct_otf.P_idx, SIG,
                            LAM, device="cpu")
    if case == "otf_one_tile":
        assert tk._otf_tile(N_OTF, ct_otf.Xqt.shape[0]) == N_OTF
        before = trace.counter(tk.OTF_TILES)
        v = torch.as_tensor(np.random.default_rng(3).normal(size=cached.n))
        got = tk.matvec_ref(ct_otf, v)
        assert trace.counter(tk.OTF_TILES) - before == 1
        assert torch.equal(got, tk.matvec_ref(cached, v))
    elif case == "fused_ref_is_predictor":
        m_cached, _, _, R_held = trainings
        E, F = Predictor(m_cached, device="cpu").predict(R_held)
        E_fast, F_fast = Predictor(m_cached, fast=True,
                                   device="cpu").predict(R_held)
        np.testing.assert_array_equal(F_fast, F)
        np.testing.assert_array_equal(E_fast, E)
    else:
        v = torch.as_tensor(np.random.default_rng(6).normal(
            size=cached.n + cached.n_train))
        got = tk.matvec_ref_ecstr(cached, v)
        assert torch.equal(got, _ecstr_matvec_written_out(cached, v))
