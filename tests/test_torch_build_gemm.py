"""The port's factor-build product engine (``MLFF_BUILD_GEMM``) against the
JAX package's: the counterparts of ``tests/test_build_gemm.py``.

The whiten product, the fused whiten + Gram, the pairwise column-block Gram
and the column-block whiten sweep, each with the f64 and the exact-slice
("ozaki", 7 digits) engine, on the same numpy factor problem.  Each result
is held to the f64 product within 1e-12 of its scale (that file's
contract: ~2^-56 of the operand scales, far inside the 0.1 lam guard), and
the ozaki results to the JAX package's ozaki results within 1e-14 of scale.
The engine is chosen as in the JAX package, except that the port's "auto"
Gram stays f64 at every row count (ROADMAP §3).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mlff_tpu.solvers import preconditioners as jpc  # noqa: E402
from mlff_tpu_torch.solvers import preconditioners as tpc  # noqa: E402

from .torch_threads import one_torch_thread  # noqa: E402,F401

IMPLS = ("f64", "ozaki")
CHUNK = 256   # full chunks and a ragged tail (700 % 256)
JAX_RTOL = 1e-14


@pytest.fixture(scope="module")
def factor_problem():
    rng = np.random.default_rng(3)
    n, m = 700, 96
    K_nm = rng.normal(size=(n, m)) * np.exp(rng.normal(size=(1, m)))
    # upper-triangular whitening factor, like chol-host W1 = L^-T
    W1 = np.triu(rng.normal(size=(m, m)) * 0.3 + np.eye(m))
    return K_nm, W1


def _of_scale(got, want) -> float:
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("impl", IMPLS)
def test_whiten_gram_parity(factor_problem, impl):
    K_nm, W1 = factor_problem
    m = K_nm.shape[1]
    B, inner = tpc._whiten_gram(torch.as_tensor(K_nm), torch.as_tensor(W1),
                                impl, chunk=CHUNK)
    B, inner = B.numpy(), inner.numpy()
    B_ref = K_nm @ W1
    assert _of_scale(B, B_ref) < 1e-12
    # self-consistency: inner is the stored factor's own Gram to ~lam
    G_ref = B_ref.T @ B_ref
    assert np.abs(inner - G_ref).max() < 1e-12 * max(np.abs(G_ref).max(), 1)
    tril = jnp.asarray(np.tril_indices(m))
    Bj, gj = jpc._whiten_gram_nm_tril(jnp.asarray(K_nm), jnp.asarray(W1),
                                      tril, CHUNK, impl)
    assert _of_scale(B, np.asarray(Bj)) < JAX_RTOL
    assert _of_scale(inner[np.tril_indices(m)], np.asarray(gj)) < JAX_RTOL


@pytest.mark.parametrize("impl", IMPLS)
def test_gram_pair_parity(factor_problem, impl):
    K_nm, _ = factor_problem
    Ba, Bb = K_nm[:, :64], K_nm[:, 64:]
    ref = Ba.T @ Bb
    G = tpc._gram_pair(torch.as_tensor(Ba), torch.as_tensor(Bb), impl,
                       chunk=CHUNK).numpy()
    assert np.abs(G - ref).max() < 1e-12 * max(np.abs(ref).max(), 1.0)
    Gj = jpc._gram_pair(jnp.asarray(Ba), jnp.asarray(Bb), CHUNK, impl)
    assert _of_scale(G, np.asarray(Gj)) < JAX_RTOL
    # the Gram of woodbury_from_factor, by the same engine
    G_full = tpc._gram(torch.as_tensor(K_nm), impl, chunk=CHUNK).numpy()
    ref_full = K_nm.T @ K_nm
    assert _of_scale(G_full, ref_full) < 1e-12
    Gj_full = jpc._gram_nm(jnp.asarray(K_nm), CHUNK, impl)
    assert _of_scale(G_full, np.asarray(Gj_full)) < JAX_RTOL


@pytest.mark.parametrize("impl", IMPLS)
def test_whiten_colblock_parity(factor_problem, impl):
    K_nm, W1 = factor_problem
    m = K_nm.shape[1]
    bc = 32
    offs = list(range(0, m, bc))
    ref = K_nm @ W1  # W1 upper triangular
    blocks = [torch.as_tensor(K_nm[:, o:o + bc].copy()) for o in offs]
    blocks_j = [jnp.asarray(K_nm[:, o:o + bc]) for o in offs]
    for c in reversed(range(len(blocks))):
        blocks[c] = tpc._whiten_colblock(
            blocks[c], blocks[:c], torch.as_tensor(W1), offs[c], offs[:c],
            chunk=CHUNK, impl=impl)
        blocks_j[c] = jpc._whiten_colblock(
            blocks_j[c], tuple(blocks_j[:c]), jnp.asarray(W1), offs[c],
            tuple(offs[:c]), CHUNK, impl)
    got = np.concatenate([b.numpy() for b in blocks], axis=1)
    assert _of_scale(got, ref) < 1e-12
    got_j = np.concatenate([np.asarray(b) for b in blocks_j], axis=1)
    assert _of_scale(got, got_j) < JAX_RTOL


def test_build_mode_selection(monkeypatch):
    """'auto' is f64 in both packages; the JAX package then sends the Gram
    to ozaki from 120,000 rows, the port keeps f64 at every n.  A forced
    engine is taken by both, and the mode is read once per process."""
    for pkg in (tpc, jpc):
        monkeypatch.setattr(pkg, "_BUILD_GEMM_MODE", None)
    monkeypatch.delenv("MLFF_BUILD_GEMM", raising=False)
    assert tpc._build_mode() == jpc._build_mode() == "f64"
    for n in (74_979, 158_004, 503_982):
        assert tpc._gram_impl_for(n) == "f64"
    assert jpc._gram_impl_for(74_979) == "f64"
    assert jpc._gram_impl_for(158_004) == jpc._gram_impl_for(503_982) \
        == "ozaki"
    monkeypatch.setenv("MLFF_BUILD_GEMM", "ozaki")
    assert tpc._build_mode() == "f64"          # cached until reset
    for mode in ("ozaki", "f64"):
        monkeypatch.setenv("MLFF_BUILD_GEMM", mode)
        for pkg in (tpc, jpc):
            monkeypatch.setattr(pkg, "_BUILD_GEMM_MODE", None)
            assert pkg._build_mode() == mode
            assert pkg._gram_impl_for(1_000) == mode
        assert tpc._gram_impl_for(503_982) == mode
    monkeypatch.setenv("MLFF_BUILD_GEMM", "int8")
    monkeypatch.setattr(tpc, "_BUILD_GEMM_MODE", None)
    with pytest.raises(ValueError, match="MLFF_BUILD_GEMM"):
        tpc._build_mode()
    for pkg in (tpc, jpc):
        monkeypatch.setattr(pkg, "_BUILD_GEMM_MODE", None)
