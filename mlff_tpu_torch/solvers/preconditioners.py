"""Nyström preconditioner with leverage-score column selection.

PyTorch port of the main slice of ``mlff_tpu.solvers.preconditioners``
(reference: sgdml/solvers/iterative_solver.py:447-552, 672-807):

  * column selection: 'random_scores', 'lev_scores', 'inverse_lev',
    'lev_random' (NumPy ``Generator`` draws identical to the JAX package's),
  * the split Nyström factorization B = K_nm W1, W2 W2^T = (B^T B + lam I)^-1
    with both m x m decompositions in host LAPACK (scipy),
  * the Woodbury apply through the SPLIT factors (B, W2), never a fused
    T = W2^T B^T: the fused product freezes its rounding noise, amplified by
    ||W2|| ~ lam^-1/2, into the operator and made P^-1 indefinite at n = 75k
    (see ``mlff_tpu.solvers.preconditioners.WoodburySplitPreconditioner``),
  * the column-blocked factor (``task["nystrom_block_cols"]``): B kept as
    column blocks, whitened in place block by block,
  * ``apply_impl="df64"``: B stored as f32 (hi, lo[, mid]) words and the two
    (n, m) passes of every apply run through the hand-written CUDA kernels
    of ``ops/df64_gemv.py``,
  * ``apply_impl="ozaki"``: B stored as 7 bf16 digit planes with per-column
    power-of-two scales (``ozaki_from_split``), each pass a sum of exact
    f32 digit products (``ops/ozaki.py``),
  * the factor-build engine (``MLFF_BUILD_GEMM=ozaki``): the whiten and Gram
    products of the split factor, plain or column-blocked, and the Gram of
    ``woodbury_from_factor`` through exact-slice products at 7 digits,
  * the automatic column-block switch above a per-buffer memory ceiling
    (``utils/hbm.py``: only when ``MLFF_TPU_HBM_CEILING_GB`` sets one).

  * ``woodbury_from_factor``: the split apply of P = L L^T + lam I for any
    low-rank factor L (the pivoted-Cholesky family, the eigenvector family),
  * ``method="chol"``: the fused-Cholesky Nystrom path with its escalating
    jitter ladders, applied through the fused T (kept for A/B comparison),
  * the dense small-n diagnostics: ``eigvec_preconditioner`` (three
    variants), ``rank_k_leverage_scores`` and ``jacobi_preconditioner``.  The
    dense kernel and its SVD stay on the cache's device.

All builders work in the PSD convention (K + lam*I).  With ``use_E_cstr`` the
Nystrom columns (force columns still) and the eigenvector family's dense
kernel span the energy-constrained system of n + N rows.

On a row-sharded cache (``parallel.mesh.shard_cache``) every builder
returns a sharded operator: B (and each column block, df64 word or Ozaki
digit plane) holds this rank's rows, the fused T its columns, W2 and lam
are replicated, and its ``layout`` (``parallel.mesh.VecLayout``) makes each
apply all-reduce its (m,) partial B^T v.  The Nystrom build all-reduces
its Gram, gathers K_mm from the rows' owners and probes the Gram of the
stored, sharded B; its host LAPACK runs on rank 0 alone, which broadcasts
each (m, m) factor (``_host_factor``); the dense diagnostics run
replicated on the gathered cache and keep their rows.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import scipy.linalg
import torch

from .. import resolve_device
from ..ops import df64
from ..ops import df64_gemv
from ..ops import kernel as knl
from ..ops import ozaki
from ..ops.descriptor import DescriptorSpec
from ..utils import trace
from ..utils.hbm import post_d2h_ceiling_bytes
from ..utils.log import get_logger

log = get_logger(__name__)

# rows per chunk of the column-blocked whitening and of the exact-slice
# build products (bounds their transients)
_GEMM_ROW_CHUNK = 4096

# ---------------------------------------------------------------------------
# Factor-build product engine.  The O(n m^2) whiten and Gram products run as
# cuBLAS f64 products ("f64") or through the Ozaki exact-slice engine
# ("ozaki", ops/ozaki.py, s = _BUILD_DIGITS: ~2^-56 of the operand scales).
# MLFF_BUILD_GEMM=f64|ozaki forces one engine; "auto" (the default) is f64,
# read once per process, as in the JAX package.
# ---------------------------------------------------------------------------
_BUILD_GEMM_MODE: str | None = None
_BUILD_DIGITS = int(os.environ.get("MLFF_BUILD_DIGITS", "7"))


def _build_mode() -> str:
    """The build engine, "f64" or "ozaki", from ``MLFF_BUILD_GEMM`` (cached
    on first use; reset ``_BUILD_GEMM_MODE`` to None to read it again)."""
    global _BUILD_GEMM_MODE
    if _BUILD_GEMM_MODE is None:
        mode = os.environ.get("MLFF_BUILD_GEMM", "auto")
        if mode == "auto":
            mode = "f64"
        if mode not in ("f64", "ozaki"):
            raise ValueError(f"unknown MLFF_BUILD_GEMM {mode!r}")
        _BUILD_GEMM_MODE = mode
    return _BUILD_GEMM_MODE


def _gram_impl_for(n_rows: int) -> str:
    """The Gram engine of a factor of ``n_rows`` rows: the build mode at
    every n.  The JAX package sends its "auto" Gram to ozaki from 120,000
    rows (``MLFF_OZAKI_GRAM_MIN_ROWS``) because its TPU's emulated f64 Gram
    carried a 4.09e-11 bias at n = 157,500, past the 0.1 lam guard; the
    port's Gram is a native f64 product, so the row count selects nothing
    here and that variable is not read."""
    return _build_mode()


def _rows_at(layout, t: torch.Tensor, idx) -> torch.Tensor:
    """t[idx] at global row indices: the rows themselves, or on a sharded
    layout gathered from their owners onto every rank."""
    idx = torch.as_tensor(np.asarray(idx), device=t.device)
    return t[idx] if layout is None else layout.take(t, idx)


def _sum_ranks(layout, t: torch.Tensor) -> torch.Tensor:
    """A per-rank partial sum over rows, summed over the ranks."""
    return t if layout is None else layout.shard.all_reduce(t)


def _host_factor(layout, fn, M: np.ndarray, *args, device) -> torch.Tensor:
    """``fn(M, *args)``, an (m, m) host-LAPACK factor of the replicated
    matrix M, as an f64 tensor on ``device``.  On a sharded layout rank 0
    alone computes it and broadcasts it: every rank holds the same bits,
    and the host's cores serve one LAPACK call rather than one per rank.
    A LAPACK failure on rank 0 is raised on every rank."""
    if layout is None:
        return torch.as_tensor(fn(M, *args), dtype=torch.float64,
                               device=device)
    shard = layout.shard
    F = err = None
    if shard.rank == 0:
        try:
            F = fn(M, *args)
        except np.linalg.LinAlgError as e:
            err = e
    if shard.any(err is not None):
        raise err or np.linalg.LinAlgError(
            "the host factorization failed on rank 0")
    buf = (torch.as_tensor(F, dtype=torch.float64, device=device)
           if F is not None else
           torch.empty(M.shape, dtype=torch.float64, device=device))
    return shard.broadcast(buf)


def _oz_slice_T(X: torch.Tensor, s: int):
    """One slicing pass serving both operands of a Gram X^T X: (left, right)
    with right = slice_digits(X, axis=0) and left its transpose (per-column
    scales of X are per-row scales of X^T)."""
    sc, dg = ozaki.slice_digits(X, axis=0, s=s)
    return (sc.T, [d.T for d in dg]), (sc, dg)


def _gram_acc_ozaki(acc: torch.Tensor, tr: torch.Tensor, s: int
                    ) -> torch.Tensor:
    """acc + tr^T tr through exact-slice products: error ~2^-(8s) of the
    column scales, independent of the row count."""
    left, right = _oz_slice_T(tr, s)
    return acc + ozaki.gemm_presliced(left, right)


def _gram_pair_acc_ozaki(acc, Ab, Bb, s: int):
    """acc + Ab^T Bb, exact-slice."""
    left, _ = _oz_slice_T(Ab, s)
    return acc + ozaki.gemm_presliced(left, ozaki.slice_digits(Bb, axis=0,
                                                               s=s))


def _gram(B: torch.Tensor, impl: str, chunk: int = _GEMM_ROW_CHUNK
          ) -> torch.Tensor:
    """B^T B (m, m): one f64 product, or exact-slice products over row
    chunks."""
    if impl == "f64":
        return B.T @ B
    acc = torch.zeros((B.shape[1], B.shape[1]), dtype=B.dtype,
                      device=B.device)
    for start in range(0, B.shape[0], chunk):
        acc = _gram_acc_ozaki(acc, B[start:start + chunk], _BUILD_DIGITS)
    return acc


def _whiten_gram(K_nm: torch.Tensor, W1: torch.Tensor, impl: str,
                 chunk: int = _GEMM_ROW_CHUNK):
    """B = K_nm W1 and inner = B^T B (the Gram of the stored B itself).
    "f64": two cuBLAS products.  "ozaki": over row chunks, W1 sliced once,
    each chunk's kernel rows sliced for the whiten and its whitened rows
    once for both Gram operands."""
    if impl == "f64":
        B = K_nm @ W1
        return B, B.T @ B
    s = _BUILD_DIGITS
    W1_sl = ozaki.slice_digits(W1, axis=0, s=s)
    B = torch.empty_like(K_nm)
    inner = torch.zeros((W1.shape[1], W1.shape[1]), dtype=K_nm.dtype,
                        device=K_nm.device)
    for start in range(0, K_nm.shape[0], chunk):
        tr = ozaki.gemm_presliced(
            ozaki.slice_digits(K_nm[start:start + chunk], axis=1, s=s), W1_sl)
        B[start:start + chunk] = tr
        inner = _gram_acc_ozaki(inner, tr, s)
    return B, inner


def _gram_probe(B: torch.Tensor, inner: np.ndarray, layout=None) -> float:
    """Max |inner - B^T B| over the full diagonal and 8 seeded cross
    entries, each from an independent f64 column dot: the guard of the
    split factor's self-consistency (on a sharded B, of the stored rows
    with the dots all-reduced)."""
    m = inner.shape[0]
    rng_p = np.random.default_rng(0)
    ii = np.concatenate([np.arange(m), rng_p.integers(0, m, size=min(8, m))])
    jj = np.concatenate([np.arange(m), rng_p.integers(0, m, size=min(8, m))])
    exact = torch.sum(B[:, torch.as_tensor(ii, device=B.device)]
                      * B[:, torch.as_tensor(jj, device=B.device)], dim=0)
    exact = _sum_ranks(layout, exact)
    return float(np.abs(inner[ii, jj] - exact.cpu().numpy()).max())


def _log_stages(what: str, seconds: dict) -> None:
    log.info("%s: %s", what,
             "  ".join(f"{k} {v:.2f}s" for k, v in seconds.items()))


@dataclass
class WoodburyPreconditioner:
    """P = L L^T + lam I with a precomputed fused T = chol(lam I + L^T L)^-1 L^T:

        P^-1 v = lam^-1 (v - T^T (T v))

    two (k, n) GEMVs and an axpy (reference iterative_cholesky.py:141-148).
    Only ``nystrom_preconditioner(method="chol")`` builds it; every other
    build function applies through the split factors (see
    ``WoodburySplitPreconditioner``).  T is padded with zero rows to a
    multiple of 128, which is inert in the apply."""

    T: torch.Tensor    # (k, n)
    lam: float
    info: dict
    layout: object = None   # parallel.mesh.VecLayout of a sharded T

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return woodbury_apply(self, v)


def woodbury_apply(P: WoodburyPreconditioner, v: torch.Tensor) -> torch.Tensor:
    """P^-1 v = lam^-1 (v - T^T (T v))."""
    return (v - P.T.T @ _sum_ranks(P.layout, P.T @ v)) / P.lam


def _pad_factor_rows(T: torch.Tensor) -> torch.Tensor:
    """Pad (k, n) -> (ceil(k/128)*128, n) with zero rows (inert in apply)."""
    k = T.shape[0]
    k_pad = -(-k // 128) * 128
    if k_pad == k:
        return T
    Tp = torch.zeros((k_pad, T.shape[1]), dtype=T.dtype, device=T.device)
    Tp[:k] = T
    return Tp


@dataclass
class WoodburySplitPreconditioner:
    """Woodbury apply through the split factors B (n, m) and W2 (m, m):

        P^-1 v = lam^-1 (v - B W2 (W2^T (B^T v)))

    The frozen operator is the exact symmetric contraction B W2 W2^T B^T;
    per-apply rounding is fresh, unamplified noise that PCG absorbs.  B is
    padded with zero columns (and W2 with zero rows/cols) to a multiple of
    128, which is inert in the apply.

    ``info`` carries the build's diagnostics: whether the Gram guard fired,
    its probe error and the stage times.
    """

    B: torch.Tensor    # (n, m) whitened columns
    W2: torch.Tensor   # (m, m) inner inverse-sqrt factor
    lam: float
    info: dict
    layout: object = None   # parallel.mesh.VecLayout of a sharded B

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return woodbury_split_apply(self, v)

    def fused_T(self) -> torch.Tensor:
        """(m, n) fused factor W2^T B^T: for diagnostics and
        ``solvers/ir_cg.py::ir_pcg_kernel`` only (the apply never forms it,
        see the class docstring)."""
        return (self.B @ self.W2).T


def woodbury_split_apply(P: WoodburySplitPreconditioner,
                         v: torch.Tensor) -> torch.Tensor:
    """lam^-1 (v - B W2 W2^T B^T v): two skinny (n, m) passes (DGEMV) and
    two small (m, m) ones.  On a sharded layout, while ``utils.trace``
    records, the apply is a span ``precon.apply`` (its all-reduce a
    ``mesh.collective`` inside it); on one card nothing is recorded."""
    with trace.NULL if P.layout is None else trace.span("precon.apply"):
        u = _sum_ranks(P.layout, P.B.T @ v)   # (m,)  == B^T v
        x = P.W2 @ (P.W2.T @ u)               # (m,)
        return (v - P.B @ x) / P.lam


# rows per pass of the chunked apply (the JAX package's _APPLY_CHUNK_ROWS)
_APPLY_CHUNK_ROWS = 16384


def _woodbury_split_apply_chunked(P: WoodburySplitPreconditioner,
                                  v: torch.Tensor,
                                  chunk: int = _APPLY_CHUNK_ROWS
                                  ) -> torch.Tensor:
    """``woodbury_split_apply`` over row chunks of B, the last one a shorter
    slice.  The JAX package takes this form above 2 GB of B because its
    broadcast-multiply passes build a transient the size of B; the port's
    apply is two matrix-vector products (``B.T @ v``, ``B @ x``) that build
    none, so ``woodbury_split_apply`` never routes here.  Kept for parity
    with the JAX function."""
    n = P.B.shape[0]
    u = torch.zeros(P.B.shape[1], dtype=v.dtype, device=v.device)
    for start in range(0, n, chunk):
        u += P.B[start:start + chunk].T @ v[start:start + chunk]
    u = _sum_ranks(P.layout, u)
    x = P.W2 @ (P.W2.T @ u)
    y = torch.empty_like(v)
    for start in range(0, n, chunk):
        y[start:start + chunk] = P.B[start:start + chunk] @ x
    return (v - y) / P.lam


def _pad_split(B: torch.Tensor, W2: torch.Tensor):
    """Pad B (n, m) with zero columns and W2 (m, m) with zero rows/cols to a
    multiple of 128 (inert in the split apply)."""
    m = B.shape[1]
    m_pad = -(-m // 128) * 128
    if m_pad == m:
        return B, W2
    Bp = torch.zeros((B.shape[0], m_pad), dtype=B.dtype, device=B.device)
    Bp[:, :m] = B
    return Bp, _pad_square(W2, m_pad)


def _pad_square(W2: torch.Tensor, m_pad: int) -> torch.Tensor:
    """W2 zero-padded to (m_pad, m_pad) (inert in the apply)."""
    if W2.shape[0] == m_pad:
        return W2
    Wp = torch.zeros((m_pad, m_pad), dtype=W2.dtype, device=W2.device)
    Wp[:W2.shape[0], :W2.shape[1]] = W2
    return Wp


@dataclass
class WoodburyColBlockPreconditioner:
    """Split Woodbury apply with B stored as column blocks (n, m_c):

        u_c = B_c^T v,  x = W2 (W2^T concat(u)),  y = sum_c B_c x_c,
        P^-1 v = lam^-1 (v - y)

    the same operator as ``WoodburySplitPreconditioner`` with
    B = concat(Bs, axis=1).  The last block is zero-column padded so that
    the total width is a multiple of 128 (inert)."""

    Bs: tuple          # of (n, m_c) f64 column blocks
    W2: torch.Tensor   # (m, m)
    lam: float
    info: dict
    layout: object = None   # parallel.mesh.VecLayout of sharded blocks

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return woodbury_colblock_apply(self, v)


def _block_pass1(B: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u = B^T v for one (n, m_c) block."""
    return B.T @ v


def _block_pass2(B: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = B x for one (n, m_c) block."""
    return B @ x


def woodbury_colblock_apply(P: WoodburyColBlockPreconditioner,
                            v: torch.Tensor) -> torch.Tensor:
    """lam^-1 (v - B W2 W2^T B^T v) over the column blocks of B."""
    u = _sum_ranks(P.layout, torch.cat([_block_pass1(B, v) for B in P.Bs]))
    x = P.W2 @ (P.W2.T @ u)
    y = torch.zeros_like(v)
    off = 0
    for B in P.Bs:
        y = y + _block_pass2(B, x[off:off + B.shape[1]])
        off += B.shape[1]
    return (v - y) / P.lam


@dataclass
class DF64WoodburyPreconditioner:
    """Split Woodbury apply with the two (n, m) passes through the df64 CUDA
    kernels (``ops/df64_gemv.py``).

    B is stored as an f32 (hi, lo) pair carrying 48 of f64's 53 mantissa
    bits; each pass reads 8 bytes per element, as an f64 GEMV does, and
    computes f64-class results in compensated f32 arithmetic.

    ``Bm`` (optional third component, f32(B - Bh - Bl), ~2^-48 |B|): the
    2^-48 quantization of the two-component form is frozen into the apply
    operator, ~2^-48 ||W2||^2 ~ 1e-10/lam-grade, which the JAX package
    measured as +10-15% CG iterations.  With the third component that
    error is gone; its contribution rides two plain f32 GEMVs (TF32 off,
    see ``df64_from_split``).  ``Bh.shape[0]`` may exceed the vectors'
    length n (zero rows, inert): the apply pads v to it."""

    Bh: torch.Tensor             # (n_rows, m) f32
    Bl: torch.Tensor             # (n_rows, m) f32
    W2: torch.Tensor             # (m, m) f64
    lam: float
    Bm: torch.Tensor | None = None   # (n_rows, m) f32
    info: dict | None = None
    layout: object = None   # parallel.mesh.VecLayout of sharded words

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return df64_woodbury_apply(self, v)


def df64_woodbury_apply(P: DF64WoodburyPreconditioner,
                        v: torch.Tensor) -> torch.Tensor:
    """lam^-1 (v - B W2 W2^T B^T v) with the (n, m) passes in df64."""
    n = v.shape[0]
    n_rows = P.Bh.shape[0]
    vp = v
    if n_rows != n:
        vp = torch.zeros(n_rows, dtype=v.dtype, device=v.device)
        vp[:n] = v
    u = df64_gemv.df64_bt_v(P.Bh, P.Bl, vp)            # (m,) f64
    if P.Bm is not None:
        # third-component correction: Bm ~ 2^-48 |B|, so a plain f32 GEMV
        # carries it at ~2^-72 overall
        u = u + (vp.to(torch.float32) @ P.Bm).to(torch.float64)
    u = _sum_ranks(P.layout, u)
    x = P.W2 @ (P.W2.T @ u)                             # small f64 GEMVs
    y = df64_gemv.df64_b_x(P.Bh, P.Bl, x)              # (n_rows,) f64
    if P.Bm is not None:
        y = y + (P.Bm @ x.to(torch.float32)).to(torch.float64)
    return (v - y[:n]) / P.lam


def _split_pad_b(B: torch.Tensor, n_pad: int, m_pad: int,
                 components: int = 3) -> tuple:
    """f64 B (n, m) -> f32 (hi, lo, mid or None), zero-padded to
    (n_pad, m_pad).  The split happens before any padding."""
    n, m = B.shape
    Bh, Bl = df64.split_f64(B)
    Bm = None
    if components >= 3:
        # the residual below the two-component form (~2^-48 scale): f64's
        # 53-bit mantissa leaves ~5 bits, which f32 carries exactly
        Bm = (B - Bh.to(B.dtype) - Bl.to(B.dtype)).to(torch.float32)
    out = []
    for comp in (Bh, Bl, Bm):
        if comp is not None and (n_pad, m_pad) != (n, m):
            padded = torch.zeros((n_pad, m_pad), dtype=torch.float32,
                                 device=B.device)
            padded[:n, :m] = comp
            comp = padded
        out.append(comp)
    return tuple(out)


# the conversion transient past which a df64 factor keeps 2 components
DF64_TRANSIENT_BYTES = int(8e9)


def df64_components(P: WoodburySplitPreconditioner) -> int:
    """The JAX package's rule, kept verbatim so that the same task builds
    the same operator: 3 components unless the conversion transient (f64 B
    + three f32 slices, ~20 bytes per element) passes 8 GB.  Counted on the
    factor's global rows: a row-sharded B holds this rank's only."""
    rows = P.B.shape[0] if P.layout is None else P.layout.n
    return 3 if rows * P.B.shape[1] * 20 < DF64_TRANSIENT_BYTES else 2


def df64_from_split(P: WoodburySplitPreconditioner, components: int = 3
                    ) -> DF64WoodburyPreconditioner:
    """The df64 form of a split preconditioner.  P is consumed: its f64 B
    is dropped after the split (``P.B`` becomes None).  ``components=3``
    keeps the third f32 slice of B (+50% factor memory, no frozen
    quantization); 2 drops it.  Nothing is padded beyond P's own 128-column
    padding.  On a CUDA device this switches TF32 off (``resolve_device``),
    which the f32 third-component GEMVs rely on."""
    if P.B.device.type == "cuda":
        resolve_device(P.B.device)
    n, m = P.B.shape
    Bh, Bl, Bm = _split_pad_b(P.B, n, m, components)
    P.B = None
    info = dict(P.info, apply_impl="df64", components=3 if Bm is not None
                else 2)
    return DF64WoodburyPreconditioner(Bh=Bh, Bl=Bl, W2=P.W2, lam=P.lam, Bm=Bm,
                                      info=info, layout=P.layout)


def _split_block_f32(B: torch.Tensor):
    """f64 column block -> (hi, lo) f32 pair."""
    return df64.split_f64(B)


def df64_from_colblocks(Bs, W2: torch.Tensor, lam: float,
                        info: dict | None = None, layout=None
                        ) -> DF64WoodburyPreconditioner:
    """Column-blocked f64 factor -> the monolithic 2-component df64 form:
    each block is split into its (hi, lo) pair, then the pieces are
    concatenated into (n, m) planes.  The JAX package keeps 2 components on
    this route because the third would not fit its HBM budget at the sizes
    that need column blocks; the port keeps the same operator."""
    his, los = zip(*(_split_block_f32(B) for B in Bs))
    Bh = torch.cat(his, dim=1)
    Bl = torch.cat(los, dim=1)
    del his, los
    m = Bh.shape[1]
    log.info("df64 colblock conversion: 2-component (n=%d, m=%d)",
             Bh.shape[0], m)
    return DF64WoodburyPreconditioner(
        Bh=Bh, Bl=Bl, W2=_pad_square(W2, m), lam=float(lam), Bm=None,
        info=dict(info or {}, apply_impl="df64", components=2), layout=layout)


@dataclass
class OzakiApplyPreconditioner:
    """Split Woodbury apply through an Ozaki digit decomposition of B.

    B is stored as s = 7 integer bf16 digit planes with per-column
    power-of-two scales: 56 bits, below f64's own 53-bit mantissa, so the
    frozen operator carries no quantization (unlike the 48-bit 2-component
    df64 apply).  Each pass contracts digit i of B against all needed digits
    of the (small, per-apply-sliced) vector in one segmented f32 product,
    exact by ``ops/ozaki.py``'s bounds.  Pass 2 folds the column scales into
    the small vector before slicing it, so its products sit on one grid per
    digit pair.  Rows are zero-padded to a multiple of 256 (inert); the f64
    B is not kept: the digits (~1.75x its bytes) replace it."""

    B_dig: tuple          # s x (n_pad, m) bf16 integer digits
    sB: torch.Tensor      # (m,) f64 per-column power-of-two scales
    W2: torch.Tensor      # (m, m)
    lam: float
    info: dict | None = None
    layout: object = None   # parallel.mesh.VecLayout of sharded digits

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return ozaki_woodbury_apply(self, v)


def ozaki_from_split(P: WoodburySplitPreconditioner, s: int = 7
                     ) -> OzakiApplyPreconditioner:
    """The Ozaki-digit form of a split preconditioner.  P is consumed: its
    f64 B is dropped after slicing (``P.B`` becomes None).  A sharded P's
    rows get per-rank column scales: each rank's digits represent its rows
    exactly, and its partial B^T v is scaled before the all-reduce."""
    n, m = P.B.shape
    n_pad = -(-n // 256) * 256
    B = torch.nn.functional.pad(P.B, (0, 0, 0, n_pad - n))
    P.B = None
    scale, digits = ozaki.slice_digits(B, axis=0, s=s)
    del B
    info = dict(P.info, apply_impl="ozaki", digits=s,
                digit_bytes=sum(d.numel() * d.element_size() for d in digits))
    return OzakiApplyPreconditioner(B_dig=tuple(digits),
                                    sB=scale.reshape(-1), W2=P.W2,
                                    lam=P.lam, info=info, layout=P.layout)


def _ozaki_gemv_digits(B_dig: tuple, x_dig: list, sx: torch.Tensor,
                       transpose: bool) -> torch.Tensor:
    """Sum over digit pairs (i, j), i + j < s, of 256^-(i+j+2) (B_i^T X_j)
    (``transpose``: contraction over rows) or 256^-(i+j+2) (B_i X_j)
    (contraction over columns), with exact 256-deep f32 segment sums and
    f64 sums across segments and pairs; times ``sx``.  ``x_dig`` entries
    are (len_contract, 1) integer digits.  Digit i of B is read once: all
    its partners stack into one product."""
    s = len(B_dig)
    n_pad, m = B_dig[0].shape
    out = None
    for i, Bi in enumerate(B_dig):
        J = s - i
        X = ozaki._f32(torch.cat([x_dig[j] for j in range(J)], dim=1))
        Bi = ozaki._f32(Bi)
        if transpose:
            # u_part[c, j] = sum_r Bi[r, c] X[r, j], segmented over r
            n_seg = n_pad // 256
            part = torch.bmm(Bi.reshape(n_seg, 256, m).transpose(1, 2),
                             X.reshape(n_seg, 256, J))     # (S, m, J)
        else:
            # y_part[r, j] = sum_c Bi[r, c] X[c, j], segmented over c
            m_seg = -(-m // 256)
            Bp = torch.nn.functional.pad(Bi, (0, m_seg * 256 - m))
            Xp = torch.nn.functional.pad(X, (0, 0, 0, m_seg * 256 - m))
            part = torch.bmm(Bp.reshape(n_pad, m_seg, 256).transpose(0, 1),
                             Xp.reshape(m_seg, 256, J))    # (S, n_pad, J)
        acc = torch.sum(part.to(torch.float64), dim=0)
        w = 256.0 ** -(i + 2.0 + torch.arange(J, dtype=torch.float64,
                                              device=acc.device))
        term = torch.sum(acc * w[None, :], dim=1)
        out = term if out is None else out + term
    return out * sx


def ozaki_woodbury_apply(P: OzakiApplyPreconditioner, v: torch.Tensor
                         ) -> torch.Tensor:
    """lam^-1 (v - B W2 W2^T B^T v) through the digit decomposition."""
    n = v.shape[0]
    n_pad = P.B_dig[0].shape[0]
    s = len(P.B_dig)
    vp = torch.nn.functional.pad(v, (0, n_pad - n))
    sv, v_dig = ozaki.slice_digits(vp[:, None], axis=0, s=s)
    u = _ozaki_gemv_digits(P.B_dig, v_dig, sv.reshape(()), True) * P.sB
    u = _sum_ranks(P.layout, u)
    x = P.W2 @ (P.W2.T @ u)
    # fold the column scales into the small vector (one grid per digit
    # pair for the exact segment sums)
    sx2, x_dig = ozaki.slice_digits((x * P.sB)[:, None], axis=0, s=s)
    y = _ozaki_gemv_digits(P.B_dig, x_dig, sx2.reshape(()), False)[:n]
    return (v - y) / P.lam


def _unpack_sym(packed: np.ndarray, m: int) -> np.ndarray:
    """Packed lower triangle -> full symmetric (m, m) on host."""
    M = np.zeros((m, m), dtype=packed.dtype)
    il = np.tril_indices(m)
    M[il] = packed
    M = M + M.T
    M[np.diag_indices(m)] /= 2.0
    return M


def _host_sym(M_dev: torch.Tensor) -> np.ndarray:
    """Device (m, m) -> host symmetric matrix built from its lower
    triangle (what the JAX package's packed d2h transfer hands LAPACK)."""
    M = M_dev.cpu().numpy()
    m = M.shape[0]
    return _unpack_sym(M[np.tril_indices(m)], m)


def _host_whiten_factor(M: np.ndarray, rank_tol: float, host_decomp: str):
    """Host-LAPACK W with W^T M W ~ I (pseudo-inverse whitening).

    'eigh': V diag(w^-1/2) with eigenvalues clamped at rank_tol * w_max.
    'chol': L^-T from a deterministic escalating-jitter Cholesky of
      M + j*I, j = rank_tol * diag_max * 4^i.
    """
    m = M.shape[0]
    if host_decomp == "eigh":
        w1, V1 = scipy.linalg.eigh(M, driver="evd", overwrite_a=True)
        tol1 = max(w1[-1], 0.0) * rank_tol
        wi = np.where(w1 > tol1, 1.0 / np.sqrt(np.maximum(w1, tol1)), 0.0)
        return V1 * wi[None, :]
    j0 = float(np.abs(np.diagonal(M)).max()) * rank_tol
    for i in range(16):
        try:
            L = scipy.linalg.cholesky(
                M + (j0 * 4.0**i) * np.eye(m), lower=True)
        except scipy.linalg.LinAlgError:
            continue
        if i:
            log.info("whiten chol: jitter escalated to %.1e rel",
                     rank_tol * 4.0**i)
        return scipy.linalg.lapack.dtrtri(L, lower=1)[0].T
    raise np.linalg.LinAlgError("whiten chol failed to regularize")


def _host_inner_isqrt(inner: np.ndarray, lam: float, host_decomp: str):
    """Host-LAPACK W2 with W2 W2^T ~ (inner + lam I)^-1.

    'eigh': V diag((max(w,0)+lam)^-1/2) — exact pseudo-inverse scaling.
    'chol': L^-T of inner + (lam + j) I with the ladder j = lam * 4^i."""
    m = inner.shape[0]
    if host_decomp == "eigh":
        w2, V2 = scipy.linalg.eigh(inner, driver="evd", overwrite_a=True)
        return V2 * (1.0 / np.sqrt(np.maximum(w2, 0.0) + lam))[None, :]
    for i in range(16):
        j = 0.0 if i == 0 else lam * 4.0 ** (i - 1)
        try:
            L = scipy.linalg.cholesky(
                inner + (lam + j) * np.eye(m), lower=True)
        except scipy.linalg.LinAlgError:
            continue
        if i:
            log.info("inner chol: extra jitter escalated to %.1e", j)
        return scipy.linalg.lapack.dtrtri(L, lower=1)[0].T
    raise np.linalg.LinAlgError("inner chol failed to regularize")


def cho_factor_stable(M: np.ndarray, max_tries: int = 20) -> np.ndarray:
    """Lower Cholesky factor with escalating diagonal regularization.

    Mirrors the reference's `_cho_factor_stable`
    (iterative_solver.py:554-618): shift the diagonal by the (negated)
    smallest eigenvalue when needed, then escalate jitter ~10x per failure.
    Host LAPACK: M is m x m.
    """
    M = np.asarray(M)
    m = M.shape[0]
    lo_eig = scipy.linalg.eigh(M, eigvals_only=True, subset_by_index=(0, 0))[0]
    shift = 1e-15 if lo_eig <= 0 else -1e-15
    A = M + shift * np.eye(m)
    jitter = 0.0
    for i in range(max_tries):
        try:
            return scipy.linalg.cholesky(A + jitter * np.eye(m), lower=True)
        except scipy.linalg.LinAlgError:
            jitter = max(abs(lo_eig) * 2.0, 1e-14) * (10.0**i)
            log.warning("cho_factor_stable: escalating jitter to %.2e", jitter)
    raise np.linalg.LinAlgError("cho_factor_stable failed to regularize matrix")


def woodbury_from_factor(L: torch.Tensor, lam: float, layout=None
                         ) -> WoodburySplitPreconditioner:
    """The Woodbury apply operator of a low-rank factor L (n, k):
    P^-1 = lam^-1 (I - L (lam I + L^T L)^-1 L^T), applied through the split
    factors B = L and W2 = chol(lam I + L^T L)^-T (host LAPACK on the (k, k)
    Gram, by the build engine).  The split apply never freezes a triangular
    solve's noise into a (k, n) product: see WoodburySplitPreconditioner.
    ``layout``: L holds this rank's rows of a sharded factor (the Gram is
    all-reduced)."""
    n_rows = L.shape[0] if layout is None else layout.n
    inner = _host_sym(_sum_ranks(layout, _gram(L, _gram_impl_for(n_rows))))
    W2 = _host_factor(layout, _host_inner_isqrt, inner, lam, "chol",
                      device=L.device)
    B, W2 = _pad_split(L, W2)
    return WoodburySplitPreconditioner(B=B, W2=W2, lam=float(lam),
                                       info={"apply_impl": "xla"},
                                       layout=layout)


def _nystrom_factor_split(
    K_nm: torch.Tensor, inducing_idxs: np.ndarray, lam: float,
    rank_tol: float, host_decomp: str = "eigh", layout=None,
) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Split Nyström factorization (B (n, m), W2 (m, m), info) with
    B = K_nm W1 and W2 W2^T = (B^T B + lam I)^+.

    SELF-CONSISTENCY IS LOAD-BEARING: the inner matrix is the Gram of the
    stored B itself (``B.T @ B`` of the same tensor), never a congruence
    W1^T (K_nm^T K_nm) W1 evaluated elsewhere.  With lam = 1e-10 the
    (w2 + lam)^-1/2 scaling needs ``inner`` to match B's true Gram to ~lam
    absolute in its small eigenvalues.  On a sharded layout (K_nm this
    rank's rows) K_mm is gathered from its rows' owners, and the inner
    matrix is the all-reduced Gram of the stored, sharded B, probed on
    that same B.
    """
    dev = K_nm.device
    m = len(inducing_idxs)
    with trace.stages("precon.nystrom", sync=dev) as t:
        K_mm = _host_sym(_rows_at(layout, K_nm, inducing_idxs))
        t.mark("gather_Kmm")
        W1 = _host_factor(layout, _host_whiten_factor, K_mm, rank_tol,
                          host_decomp, device=dev)
        t.mark("host_W1")
        # the Gram engine is the build mode at every n (_gram_impl_for)
        impl = _build_mode()
        B, inner_dev = _whiten_gram(K_nm, W1, impl)      # (n, m), B^T B
        t.mark("whiten_gram")
        inner = _host_sym(_sum_ranks(layout, inner_dev))
        # GUARD: inner must match B's true Gram to ~lam ABSOLUTE, or the
        # (w2 + lam)^-1/2 scaling silently stops preconditioning.  Probe the
        # full diagonal and a few random cross entries with independent
        # column dots; on failure recompute the whole Gram on host from the
        # factor.
        probe_err = _gram_probe(B, inner, layout)
        fired = probe_err > max(0.1 * lam, 1e-12)
        if fired:
            log.warning(
                "device Gram failed the spot check (max abs err %.2e vs lam = "
                "%.0e): recomputing inner on host from the factor (%d x %d)",
                probe_err, lam, B.shape[0], m)
            B_host = (B if layout is None else layout.gather(B)).cpu().numpy()
            inner = B_host.T @ B_host
        t.mark("gram_probe")
        W2 = _host_factor(layout, _host_inner_isqrt, inner, lam,
                          host_decomp, device=dev)
        t.mark("host_W2")
    _log_stages("nystrom factor stages", t.seconds)
    info = {"gram_guard_fired": bool(fired), "gram_probe_err": probe_err,
            "stages": t.seconds, "build_gemm": impl}
    return B, W2, info


def _nystrom_factor_eigh(
    K_nm: torch.Tensor, inducing_idxs: np.ndarray, lam: float,
    rank_tol: float, host_decomp: str = "eigh", layout=None,
) -> torch.Tensor:
    """Fused factor T = W2^T B^T (m, n) — for leverage scores only; the
    preconditioner apply never materializes it (see module docstring)."""
    B, W2, _ = _nystrom_factor_split(K_nm, inducing_idxs, lam, rank_tol,
                                     host_decomp, layout)
    return (B @ W2).T


def _whiten_colblock(K_c: torch.Tensor, K_prev, W1: torch.Tensor, off_c: int,
                     offs_prev, chunk: int = _GEMM_ROW_CHUNK,
                     impl: str = "f64") -> torch.Tensor:
    """B_c = sum_{j<=c} K_j W1[j-block, c-block], written over K_c row chunk
    by row chunk (each chunk's product is formed before it overwrites the
    chunk), by the build engine ``impl``.  Correct because W1 is upper
    triangular (chol whitening, L^-T): block c of B depends only on K
    blocks j <= c, so a descending-c sweep may overwrite block c while
    blocks j < c still hold kernel columns."""
    mc = K_c.shape[1]
    W = [W1[off_c:off_c + mc, off_c:off_c + mc]] + [
        W1[oj:oj + Kj.shape[1], off_c:off_c + mc]
        for Kj, oj in zip(K_prev, offs_prev)]
    if impl == "ozaki":
        s = _BUILD_DIGITS
        W = [ozaki.slice_digits(Wj, axis=0, s=s) for Wj in W]

        def prod(rows, Wj):
            return ozaki.gemm_presliced(
                ozaki.slice_digits(rows, axis=1, s=s), Wj)
    else:
        def prod(rows, Wj):
            return rows @ Wj
    for start in range(0, K_c.shape[0], chunk):
        rows = slice(start, start + chunk)
        blk = prod(K_c[rows], W[0])
        for Kj, W_jc in zip(K_prev, W[1:]):
            blk += prod(Kj[rows], W_jc)
        K_c[rows] = blk
    return K_c


def _gram_pair(Ba: torch.Tensor, Bb: torch.Tensor, impl: str = "f64",
               chunk: int = _GEMM_ROW_CHUNK) -> torch.Tensor:
    """Ba^T Bb (m_a, m_b): one f64 GEMM (true f64 at any depth on the card;
    the JAX package caps the depth because TPU f64 emulation degrades past
    1024), or exact-slice products over row chunks (``impl="ozaki"``)."""
    if impl == "f64":
        return Ba.T @ Bb
    acc = torch.zeros((Ba.shape[1], Bb.shape[1]), dtype=Ba.dtype,
                      device=Ba.device)
    for start in range(0, Ba.shape[0], chunk):
        acc = _gram_pair_acc_ozaki(acc, Ba[start:start + chunk],
                                   Bb[start:start + chunk], _BUILD_DIGITS)
    return acc


def _nystrom_factor_split_colblocked(
    spec: DescriptorSpec,
    cache: knl.KernelCache,
    inducing_idxs: np.ndarray,
    lam: float,
    rank_tol: float,
    block_cols: int,
    use_E_cstr: bool = False,
    layout=None,
) -> tuple[tuple, torch.Tensor, dict]:
    """Column-blocked variant of ``_nystrom_factor_split``: K_nm is
    assembled, whitened in place and kept as column blocks of <= block_cols,
    never one (n, m) buffer.  Same math and the same self-consistency
    discipline (the inner matrix is the Gram of the stored blocks, guarded
    by a probe of every diagonal entry with a plain f64 column dot).  Only
    'chol' whitening: the in-place sweep needs W1 upper triangular.  With
    ``use_E_cstr`` the blocks are columns of the energy-constrained system,
    its (n, N) cross block assembled once for all of them.
    Returns (blocks, W2, info)."""
    inducing_idxs = np.sort(np.asarray(inducing_idxs))
    m = len(inducing_idxs)
    dev = cache.device
    offs = list(range(0, m, block_cols))
    with trace.stages("precon.nystrom", sync=dev) as t:
        if use_E_cstr:
            K_fe, _ = knl.assemble_ecstr_blocks(spec.dim_i, cache)
            blocks = [knl.assemble_columns_ecstr(
                spec, cache, inducing_idxs[off:off + block_cols], K_fe=K_fe)
                for off in offs]
            del K_fe
        else:
            blocks = [knl.assemble_columns(spec, cache,
                                           inducing_idxs[off:off + block_cols])
                      for off in offs]
        t.mark("assemble")
        K_mm = np.concatenate(
            [_rows_at(layout, K_c, inducing_idxs).cpu().numpy()
             for K_c in blocks], axis=1)
        t.mark("gather_Kmm")
        W1 = _host_factor(layout, _host_whiten_factor, K_mm, rank_tol,
                          "chol", device=dev)
        t.mark("host_W1")
        mode = _build_mode()
        gram_impl = _gram_impl_for(blocks[0].shape[0] if layout is None
                                   else layout.n)
        for c in reversed(range(len(blocks))):
            blocks[c] = _whiten_colblock(blocks[c], blocks[:c], W1, offs[c],
                                         offs[:c], impl=mode)
        t.mark("whiten")
        inner = np.zeros((m, m))
        for a in range(len(blocks)):
            for b in range(a, len(blocks)):
                G = _sum_ranks(layout, _gram_pair(blocks[a], blocks[b],
                                                  gram_impl)).cpu().numpy()
                inner[offs[a]:offs[a] + G.shape[0],
                      offs[b]:offs[b] + G.shape[1]] = G
                if b != a:
                    inner[offs[b]:offs[b] + G.shape[1],
                          offs[a]:offs[a] + G.shape[0]] = G.T
        t.mark("gram")
        # GUARD (same contract as _nystrom_factor_split's): every diagonal
        # entry of every block against an independent column dot
        probe_err = 0.0
        for a, B_a in enumerate(blocks):
            exact = _sum_ranks(layout,
                               torch.sum(B_a * B_a, dim=0)).cpu().numpy()
            diag = np.diagonal(inner)[offs[a]:offs[a] + B_a.shape[1]]
            probe_err = max(probe_err, float(np.abs(diag - exact).max()))
        fired = probe_err > max(0.1 * lam, 1e-12)
        if fired:
            log.warning(
                "colblock device Gram failed the spot check (max abs err "
                "%.2e vs lam = %.0e): recomputing inner on host from the "
                "blocks",
                probe_err, lam)
            B_host = np.concatenate(
                [(B_c if layout is None else layout.gather(B_c)).cpu().numpy()
                 for B_c in blocks], axis=1)
            inner = B_host.T @ B_host
        t.mark("gram_probe")
        W2 = _host_factor(layout, _host_inner_isqrt, inner, lam, "chol",
                          device=dev)
        t.mark("host_W2")
    _log_stages("nystrom colblock factor stages", t.seconds)
    info = {"gram_guard_fired": bool(fired), "gram_probe_err": probe_err,
            "stages": t.seconds, "block_cols": int(block_cols),
            "n_blocks": len(blocks), "build_gemm": mode}
    return tuple(blocks), W2, info


def _chol_failed(info: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether a ``cholesky_ex`` broke down (``info != 0``) or what was
    computed from its factor holds a non-finite value: the rung of a jitter
    ladder failed.  One host read."""
    return bool((info != 0) | ~torch.isfinite(torch.sum(out)))


def _nystrom_factor_chol(K_nm: torch.Tensor, inducing_idxs: np.ndarray,
                         lam: float, layout=None) -> torch.Tensor:
    """The fused-Cholesky path, T (m, n): two stages, each retried up an
    escalating jitter ladder (8 and 14 rungs).  On a sharded layout T holds
    this rank's columns, the Gram is all-reduced and every rank takes the
    same rung."""
    K_mm = _rows_at(layout, K_nm, inducing_idxs)
    B = None
    for i in range(8):
        B, failed = _nystrom_whiten_fused(K_nm, K_mm, 10.0**i)
        if layout is not None:
            failed = layout.shard.any(failed)
        if not failed:
            break
        log.warning("nystrom whiten failed at jitter boost 1e%d; escalating", i)
    # the expensive (m^2 n) Gram, once
    inner = _sum_ranks(layout, _nystrom_inner_gram(B))
    G = None
    for i in range(14):
        # fine ladder: the retries repeat only the (m, m) factorization, and
        # the smallest working regularization gives the best quality
        G, failed = _chol_with_reg(inner, lam, 10.0**i)
        if not failed:
            break
        if i > 4:
            log.warning("nystrom inner chol failed at boost 1e%d; escalating",
                        i)
    return _trsm_fused(G, B)


def _nystrom_whiten_fused(K_nm: torch.Tensor, K_mm: torch.Tensor,
                          boost: float):
    """Stage 1: B = chol(K_mm + jitter)^-1 K_mn, (m, n).  Base jitter is
    1e-10 of the spectral scale (the reference also shifts the K_mm diagonal
    unconditionally, iterative_solver.py:576-579); ``boost`` multiplies it
    on retries."""
    scale = torch.max(torch.abs(torch.diagonal(K_mm)))
    eye = torch.eye(K_mm.shape[0], dtype=K_nm.dtype, device=K_nm.device)
    L_mm, info = torch.linalg.cholesky_ex(K_mm + (scale * 1e-10 * boost) * eye)
    B = torch.linalg.solve_triangular(L_mm, K_nm.T, upper=False)
    return B, _chol_failed(info, B)


def _nystrom_inner_gram(B: torch.Tensor) -> torch.Tensor:
    """Stage 2a: the (m, m) Gram matrix B B^T."""
    return B @ B.T


def _chol_with_reg(inner: torch.Tensor, lam: float, boost: float):
    """Stage 2b: chol(inner + reg I).  Base regularization is lam; on a
    retry the whitened Gram's spectral scale enters at 1e-16 * boost
    (roundoff makes the PSD Gram slightly indefinite at ~eps * ||B B^T||,
    which for near-singular whitening exceeds lam by orders of magnitude;
    the reference's _cho_factor_stable ladders identically,
    iterative_solver.py:600-618)."""
    eye = torch.eye(inner.shape[0], dtype=inner.dtype, device=inner.device)
    scale = torch.max(torch.abs(torch.diagonal(inner)))
    reg = lam + (scale * 1e-16 * boost if boost > 1.0 else 0.0)
    G, info = torch.linalg.cholesky_ex(inner + reg * eye)
    return G, _chol_failed(info, G)


def _trsm_fused(G: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Stage 2c: T = G^-1 B."""
    return torch.linalg.solve_triangular(G, B, upper=False)


def _pad_colblocks(Bs: tuple, W2: torch.Tensor):
    """Zero-column-pad the last block (and W2's rows and columns) so that
    the total width is a multiple of 128 (inert in the apply)."""
    m = sum(B.shape[1] for B in Bs)
    m_pad = -(-m // 128) * 128
    if m_pad == m:
        return Bs, W2
    last = Bs[-1]
    lp = torch.zeros((last.shape[0], last.shape[1] + m_pad - m),
                     dtype=last.dtype, device=last.device)
    lp[:, :last.shape[1]] = last
    return (*Bs[:-1], lp), _pad_square(W2, m_pad)


def nystrom_preconditioner(
    spec: DescriptorSpec,
    cache: knl.KernelCache,
    inducing_idxs: np.ndarray,
    lam: float,
    use_E_cstr: bool = False,
    method: str = "chol_host",
    rank_tol: float = 1e-10,
    apply_impl: str = "xla",
    block_cols: int | None = None,
):
    """Nyström preconditioner P = K_nm K_mm^+ K_mn + lam I from a column
    subset, whitened form, applied through the Woodbury identity
    (reference iterative_solver.py:218-254, 370-374).

    ``method``: 'chol_host' (Cholesky + triangular inverse on host, the
    default), 'eigh' (host eigendecompositions with clamping) or 'chol' (the
    fused-Cholesky path with jitter ladders on the device, applied through
    a fused T in f64 whatever ``apply_impl`` says; kept for A/B comparison).
    ``apply_impl``: 'xla' names the plain f64 apply, as in the JAX package;
    'df64' the apply through the df64 CUDA kernels, with 3 components
    unless the JAX package's memory rule asks for 2; 'ozaki' the apply
    through 7 exact-slice digit planes of B (``OzakiApplyPreconditioner``).
    ``block_cols``: keep B as column blocks of this width ('chol' whitening;
    with 'df64' the blocks become one 2-component df64 factor; 'ozaki' has
    no column-blocked form).  Without it, a factor above 0.9 of the
    per-buffer ceiling of ``utils/hbm.py`` switches to blocks on its own
    ('chol_host' or 'eigh' with the 'xla' apply), as in the JAX package; on
    the card there is a ceiling only when ``MLFF_TPU_HBM_CEILING_GB`` sets
    one.  The whiten and Gram products run by the build engine
    (``MLFF_BUILD_GEMM``, ``_build_mode``).
    ``use_E_cstr``: the columns span the energy-constrained system (n + N
    rows); the inducing columns stay force columns.  On a row-sharded cache
    the result is sharded (module docstring); the column-block switch
    decides on the global factor size, as every rank must.
    """
    if method not in ("chol_host", "eigh", "chol"):
        raise ValueError(f"unknown nystrom method {method!r}")
    if apply_impl not in ("xla", "df64", "ozaki"):
        raise ValueError(f"unknown apply_impl {apply_impl!r}")
    _build_mode()          # an unknown MLFF_BUILD_GEMM raises before work
    inducing_idxs = np.sort(np.asarray(inducing_idxs))
    layout = knl.vector_layout(cache, use_E_cstr)
    ceiling = post_d2h_ceiling_bytes()
    n = cache.n_global
    factor_bytes = n * len(inducing_idxs) * 8
    if (block_cols is None and ceiling is not None
            and factor_bytes > 0.9 * ceiling
            and method in ("chol_host", "eigh") and apply_impl == "xla"):
        # past the per-buffer ceiling: store B as column blocks, of a width
        # on the JAX package's 512-column grid
        width = int(0.45 * ceiling / (n * 8)) // 512 * 512
        block_cols = max(512, width)
        log.info(
            "Nystrom factor (n=%d, m=%d, %.1f GB) exceeds the %.1f GB "
            "per-buffer post-d2h ceiling — using column blocks of %d",
            n, len(inducing_idxs), factor_bytes / 1e9,
            ceiling / 1e9, block_cols)
    with trace.stages("precon.nystrom") as t:
        if block_cols is not None:
            if method == "chol":
                raise ValueError(
                    "nystrom method 'chol' has no column-blocked form")
            if apply_impl == "ozaki":
                raise ValueError(
                    f"apply_impl {apply_impl!r} unsupported with column "
                    "blocks")
            Bs, W2, info = _nystrom_factor_split_colblocked(
                spec, cache, inducing_idxs, lam, rank_tol, block_cols,
                use_E_cstr=use_E_cstr, layout=layout)
            Bs, W2 = _pad_colblocks(Bs, W2)
            t.mark("factor")
            info = dict(info, factorization_s=t.seconds["factor"])
            log.info("nystrom build (colblock x%d): %.2fs", len(Bs),
                     info["factorization_s"])
            if apply_impl == "df64":
                return df64_from_colblocks(Bs, W2, lam, info, layout=layout)
            return WoodburyColBlockPreconditioner(
                Bs=Bs, W2=W2, lam=float(lam),
                info=dict(info, apply_impl="xla"), layout=layout)
        if use_E_cstr:
            K_nm = knl.assemble_columns_ecstr(spec, cache, inducing_idxs)
        else:
            K_nm = knl.assemble_columns(spec, cache, inducing_idxs)  # (n, m)
        if cache.device.type == "cuda":
            torch.cuda.synchronize(cache.device)
        t.mark("columns")
        if method == "chol":
            T = _pad_factor_rows(_nystrom_factor_chol(K_nm, inducing_idxs,
                                                      lam, layout))
            t.mark("factor")
            info = {"columns_s": t.seconds["columns"], "apply_impl": "xla",
                    "factorization_s": t.seconds["factor"]}
            log.info("nystrom build (chol): columns %.2fs, factorization "
                     "%.2fs", info["columns_s"], info["factorization_s"])
            return WoodburyPreconditioner(T=T, lam=float(lam), info=info,
                                          layout=layout)
        B, W2, info = _nystrom_factor_split(
            K_nm, inducing_idxs, lam, rank_tol,
            host_decomp="chol" if method == "chol_host" else "eigh",
            layout=layout)
        del K_nm
        B, W2 = _pad_split(B, W2)
        t.mark("factor")
    info = dict(info, columns_s=t.seconds["columns"],
                factorization_s=t.seconds["factor"])
    log.info("nystrom build (%s): columns %.2fs, factorization %.2fs",
             method, info["columns_s"], info["factorization_s"])
    P = WoodburySplitPreconditioner(B=B, W2=W2, lam=float(lam),
                                    info=dict(info, apply_impl="xla"),
                                    layout=layout)
    del B
    if apply_impl == "df64":
        P = df64_from_split(P, components=df64_components(P))
    elif apply_impl == "ozaki":
        P = ozaki_from_split(P)
    return P


def select_random(n: int, k: int, rng: np.random.Generator) -> np.ndarray:
    """'random_scores': uniform column subset (iterative_solver.py:683-686)."""
    return np.sort(rng.choice(n, size=k, replace=False))


def leverage_scores(
    spec: DescriptorSpec,
    cache: knl.KernelCache,
    lam: float,
    n_inducing_pts: int,
    rng: np.random.Generator,
    idxs_ordered_by_lev_score: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Approximate ridge leverage scores for all n columns (reference
    `_lev_scores`, iterative_solver.py:447-552): sample
    m = max(1, n_ind//4)*dim_i columns, and take the column sums-of-squares
    of the Nyström factor T = (B B^T + lam I)^-1/2 B.  On a row-sharded
    cache every rank draws the same columns and gets the whole score vector.
    Returns (lev_scores, argsort(lev_scores))."""
    n = cache.n_train_global * spec.dim_i
    layout = knl.vector_layout(cache)
    dim_m = max(1, n_inducing_pts // 4) * spec.dim_i

    if idxs_ordered_by_lev_score is None:
        lev_approx_idxs = np.sort(rng.choice(n, size=dim_m, replace=False))
    else:
        if len(idxs_ordered_by_lev_score) != n:
            raise ValueError("idxs_ordered_by_lev_score must cover all n")
        lev_approx_idxs = np.sort(idxs_ordered_by_lev_score[-dim_m:])

    with trace.stages("precon.leverage") as t:
        K_nm = knl.assemble_columns(spec, cache, lev_approx_idxs)  # (n, m)
        t.mark("columns")
        T = _nystrom_factor_eigh(K_nm, lev_approx_idxs, lam, rank_tol=1e-10,
                                 host_decomp="chol", layout=layout)
        lev = torch.sum(T * T, dim=0)
        lev = (lev if layout is None else layout.gather(lev)).cpu().numpy()
        t.mark("factor")
    log.info("lev scores (m=%d): columns %.2fs, factor+scores %.2fs",
             len(lev_approx_idxs), t.seconds["columns"], t.seconds["factor"])
    return lev, np.argsort(lev)


def select_by_leverage(
    strategy: str,
    lev: np.ndarray,
    order: np.ndarray,
    k: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Deterministic / inverse / probabilistic leverage-score selection
    (iterative_solver.py:736-753)."""
    if strategy == "lev_scores":
        return np.sort(order[-k:])
    if strategy == "inverse_lev":
        return np.sort(order[:k])
    if strategy == "lev_random":
        p = lev / lev.sum()
        return np.sort(rng.choice(len(lev), size=k, replace=False, p=p))
    raise ValueError(strategy)


def _guard_dense_diagnostic(name: str, n: int) -> None:
    """The eigvec / rank-k-lev families materialize the dense K and take its
    SVD: O(n^2) memory, O(n^3) flops.  They are small-n diagnostics
    (reference iterative_solver.py:1110-1175, 1177-1348), capped below the
    production operating points (n >= 30k).  The cap can be raised through
    MLFF_TPU_DENSE_DIAG_MAX_N."""
    max_n = int(os.environ.get("MLFF_TPU_DENSE_DIAG_MAX_N", 20_000))
    if n > max_n:
        raise ValueError(
            f"{name} materializes the dense {n}x{n} kernel "
            f"({n * n * 8 / 1e9:.1f} GB) and takes its SVD; it is a small-n "
            f"diagnostic capped at n <= {max_n}. Use a Nystrom/Cholesky "
            f"strategy at this size, or raise MLFF_TPU_DENSE_DIAG_MAX_N."
        )


def rank_k_leverage_scores(
    spec: DescriptorSpec,
    cache: knl.KernelCache,
    k: int,
) -> np.ndarray:
    """Rank-k subspace leverage scores from a full SVD of K
    (reference `_rank_k_leverage_scores`, iterative_solver.py:1110-1175;
    Def. 1 of arXiv:2201.07017).  Small-n diagnostic: materializes K."""
    _guard_dense_diagnostic("rank_k_lev_scores", cache.n_global)
    U, _, _ = torch.linalg.svd(knl.assemble_full(spec, cache))
    return torch.linalg.norm(U[:, :k], dim=1).cpu().numpy()


def _masked_kernel(K: torch.Tensor, variant: str, T: int,
                   n_F: int) -> torch.Tensor:
    """K with the entries a variant of ``eigvec_preconditioner`` drops set
    to zero.  Rows and columns from ``n_F`` on are the energy-constraint
    rows of the extended system (none without energy constraints)."""
    idx = torch.arange(K.shape[0], device=K.device)
    is_F = idx < n_F
    if variant == "eigvec_precon":
        return K
    if variant == "eigvec_precon_block_diagonal":
        # energy row i belongs to point i: it keeps the point's force
        # coupling and its own diagonal
        point = torch.where(is_F, idx // T, idx - n_F)
        keep = point[:, None] == point[None, :]
        return torch.where(keep, K, 0.0)
    if variant == "eigvec_precon_atomic_interactions":
        # zero entries below threshold except 3x3 atomic diagonal blocks;
        # each energy row is an atom of its own, so it keeps its diagonal
        absK = torch.abs(K)
        delete = absK < 1.0 * absK.max()
        atom = torch.where(is_F, (idx % T) // 3, -1 - (idx - n_F))
        delete &= atom[:, None] != atom[None, :]
        if not torch.equal(delete, delete.T):
            raise AssertionError("only symmetric deletes allowed")
        return torch.where(delete, 0.0, K)
    raise NotImplementedError(variant)


def eigvec_preconditioner(
    spec: DescriptorSpec,
    cache: knl.KernelCache,
    k: int,
    lam: float,
    variant: str = "eigvec_precon",
    svd_cache: dict | None = None,
    use_E_cstr: bool = False,
) -> WoodburySplitPreconditioner:
    """Truncated-SVD preconditioner P = U_k S_k U_k^T + lam I.

    Variants (reference iterative_solver.py:1238-1268):
      * 'eigvec_precon': plain truncated SVD of K,
      * 'eigvec_precon_block_diagonal': per-training-point block-diagonal
        K (3A x 3A blocks) before the SVD,
      * 'eigvec_precon_atomic_interactions': keep only 3x3 atomic
        self-interaction blocks.
    ``svd_cache`` (optional dict) memoizes (U, s), as tensors on the cache's
    device, across k-sweeps the way the reference's glob_U/glob_s module
    globals do (iterative_solver.py:1291-1303), but explicitly, per caller.

    The decomposition is an SVD, not ``eigh``: the masked variants can be
    indefinite, and L = U_k sqrt(s_k) uses singular values.  As in the JAX
    package, 'eigvec_precon_block_diagonal' keeps the per-point diagonal
    blocks (the reference's version zeroes the entire matrix,
    iterative_solver.py:1259-1262), and with ``use_E_cstr`` the masks extend
    over the energy rows (the reference's (n, n) masks crash against the
    extended matrix, iterative_solver.py:1241-1252): 'block_diagonal' keeps
    each point's force block, its force-to-own-energy coupling and the
    energy diagonal; 'atomic_interactions' the atomic 3x3 blocks and the
    energy diagonal.  On a row-sharded cache the dense kernel and its SVD
    are formed on every rank (replicated), and the factor keeps this rank's
    rows.
    """
    key = ("svd", variant, use_E_cstr)
    if svd_cache is not None and key in svd_cache:
        U, s = svd_cache[key]
    else:
        _guard_dense_diagnostic(
            variant, cache.n_global + (cache.n_train_global if use_E_cstr
                                       else 0))
        K = (knl.assemble_full_ecstr(spec, cache) if use_E_cstr
             else knl.assemble_full(spec, cache))
        K = _masked_kernel(K, variant, spec.dim_i, cache.n_global)
        U, s, _ = torch.linalg.svd(K)
        if svd_cache is not None:
            svd_cache[key] = (U, s)
    L = U[:, :k] * torch.sqrt(s[:k])[None, :]
    # (a memoized SVD may come without a cache)
    layout = None if cache is None else knl.vector_layout(cache, use_E_cstr)
    if layout is not None:
        L = L[torch.as_tensor(layout.local_index(), device=L.device)]
    return woodbury_from_factor(L, lam, layout)


def jacobi_preconditioner(diag: torch.Tensor, lam: float):
    """Plain diagonal (Jacobi) preconditioner: a cheap baseline."""
    d = diag + lam

    def apply(v):
        return v / d

    return apply
