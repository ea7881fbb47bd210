"""Fused descriptor-space force/energy contraction for prediction and for
the on-the-fly training matvec.

The CUDA kernel ``csrc/fused_predict.cu`` replaces the TPU kernel
``mlff_tpu/ops/pallas_predict.py::_contract_kernel`` and the Gram-trick
distances computed before it.  For a batch of query descriptors against the
permuted training set it computes

    dist  = ||q x_b - q x~_m||            (f64 Gram trick, clamped at 0)
    a     = 5/(3 sig^2) exp(-dist)
    dot   = (q x_b - q x~_m) . w~_m
    F     = sum_m a [ dot (q x_b - q x~_m) - (1 + dist) w~_m ]
    E     = sum_m a (1 + dist) dot / q

without any (B, M) array in device memory for D <= 129: the four products
run on the FP64 tensor cores inside the kernel, distances and weights on
their tiles.  Wider descriptors (molecules of 17 atoms and more) take the
kernel's wide route: two passes of hand-written FP64 tensor-core products
that meet in a (B, M) pair of f64 weights (G = a dot and a1) in device
memory, as the TPU kernel's caller meets it in an f64 (B, M) distance
array; where the training set is small the first pass also splits the
descriptor axis across the SMs.
The arithmetic is f64, not the TPU kernel's f32: the cotangents w~ of a
lam = 1e-10 ridge solve are orders of magnitude larger than the forces they
sum to, and an f32 contraction of a trained model misses the f64 forces by
far more than the tolerance of the f32 path
(``tests/test_torch_fused_predict.py`` shows it on the JAX kernel itself).

``plan`` holds the launch geometry (which of the kernel's three widths takes
D, or the wide route, the query tiles, the slabs of the training axis and,
on the wide route, the slices of the descriptor axis); the
kernel source mirrors its constants and the wrapper holds the two against
each other when the library is loaded.  ``desc_forces_fused`` launches the kernel for CUDA
tensors (or raises) and runs the plain PyTorch version
``desc_forces_fused_ref`` for CPU tensors.  The counter ``LAUNCHES`` of
``utils.trace`` counts the calls that launched the kernel.

Two callers share it: the fast Predictor (``models/predict.py``), and the
on-the-fly matvec of a training whose (N, M) weights do not fit
(``ops/kernel.py::_matvec_ref_otf``), which takes F alone and calls it
once per CG iteration over all its N rows, queries being training points.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from ..utils import trace
from . import cuda_build
from .kernel import SQRT5, desc_forces, pair_weights, pairwise_dist_gram

# the counter of ``utils.trace`` of the calls that launched the kernel
LAUNCHES = "launches.fused_predict"

# the launch geometry of csrc/fused_predict.cu
TM = 16                  # training rows in a shared-memory stage
STAGES = 4               # stages in the ring
MAX_GRID_Y = 65535
# the widest descriptor of the three narrow instantiations (molecules of up
# to 16 atoms, D = 120); wider ones take the wide route
MAX_D = 129


@dataclass(frozen=True)
class Geometry:
    """One instantiation of the kernel: it takes D <= ``width``."""

    width: int           # padded descriptor width, a multiple of 8
    queries: int         # queries per block: 8 or 16 per warp
    threads: int
    blocks_per_sm: int   # blocks the plan counts on per SM

    @property
    def row_pitch(self) -> int:
        """Doubles between staged rows: 4 mod 8 keeps the fragment loads of
        a quad's 4 k-values x 8 rows on distinct banks."""
        return self.width + 4

    @property
    def smem_bytes(self) -> int:
        """xt and wt stages, and the two row terms of every staged row."""
        return 8 * (2 * STAGES * TM * self.row_pitch + 2 * STAGES * TM)


GEOMETRIES = (Geometry(40, 64, 128, 3), Geometry(72, 64, 128, 2),
              Geometry(136, 64, 256, 1))


@dataclass(frozen=True)
class Plan:
    """Launch geometry of one call: block (i, s) takes query tile i and the
    training rows [s * rows_per_split, (s + 1) * rows_per_split)."""

    geometry: Geometry
    n_qtiles: int
    n_split: int
    rows_per_split: int   # whole stages of TM rows


@dataclass(frozen=True)
class WideGeometry:
    """The wide route (D > MAX_D).  Pass 1: tiles of ``queries`` x ``tile``
    pairs, ``depth`` descriptor columns per stage; pass 2: tiles of
    ``queries`` x ``cols`` forces, ``rows`` training rows per stage; each a
    ring of ``stages`` stages, ``threads`` threads a block,
    ``blocks_per_sm`` blocks resident per SM.  ``combine_queries``: queries
    per block of the combine kernel."""

    queries: int = 64
    tile: int = 64
    depth: int = 16
    cols: int = 128
    rows: int = 8
    stages: int = 3
    threads: int = 128
    combine_queries: int = 8
    blocks_per_sm: int = 2

    @property
    def smem_weights(self) -> int:
        """Dynamic shared bytes of pass 1: the ring of xq, xt, wt stages
        (rows of ``depth + 4`` doubles), the row terms and the tile's row
        sums."""
        return 8 * (self.stages * (self.queries + 2 * self.tile)
                    * (self.depth + 4) + self.queries + 2 * self.tile
                    + 4 * self.queries)

    @property
    def smem_forces(self) -> int:
        """Dynamic shared bytes of pass 2: the ring of G, a1 stages (rows of
        ``rows + 4`` doubles) and xt, wt stages (rows of ``cols + 4``), and
        the queries' sums of G."""
        return 8 * (self.stages * (2 * self.queries * (self.rows + 4)
                                   + 2 * self.rows * (self.cols + 4))
                    + self.queries)

    def library_tuple(self) -> tuple[int, ...]:
        """What ``library_wide_geometry`` reports but the resident blocks."""
        return (self.queries, self.tile, self.depth, self.stages, self.cols,
                self.rows, self.stages, self.threads, self.smem_weights,
                self.smem_forces, self.combine_queries)


WIDE = WideGeometry()
# (B, M) f64 weights of one wide pass, two arrays: queries go in chunks whose
# weights stay within this many doubles (~268 MB)
WIDE_WEIGHT_DOUBLES = 2**25


def _even(n: int) -> int:
    return n + (n & 1)


@dataclass(frozen=True)
class WidePlan:
    """Launch geometry of one wide pass over ``b_chunk`` queries at most.
    Pass 1's tiles, n_qtiles x n_mtiles in order t = query tile + n_qtiles
    training tile: the first ``n_whole`` over all of D, each later one (the
    last, partial wave's) in ``n_ksplit`` slices of ``cols_per_slice``
    descriptor columns (slice y: [y cols_per_slice, (y + 1)
    cols_per_slice)).  Pass 2 on (n_dtiles, n_qtiles, n_split) blocks, slab
    s the training rows [s rows_per_split, (s + 1) rows_per_split)."""

    geometry: WideGeometry
    b_chunk: int
    n_qtiles: int
    n_mtiles: int
    n_whole: int
    n_ksplit: int
    cols_per_slice: int   # whole stages of ``depth`` columns
    n_dtiles: int
    n_split: int
    rows_per_split: int   # whole stages of ``rows`` rows

    @property
    def n_tail(self) -> int:
        """Pass 1's split tiles."""
        return self.n_qtiles * self.n_mtiles - self.n_whole

    def scratch_doubles(self, B: int, M: int, D: int) -> int:
        """Scratch of a pass over B <= b_chunk queries, as the kernel lays it
        out (ldm = M rounded up to even): the two (B, ldm) weights; the two
        (n_mtiles, B) row partials and sum G (B), each rounded up to even;
        a partial S, Gram and row terms per slice of each split tile; with
        several slabs their (B, D) force partials."""
        geo = self.geometry
        part = 2 * geo.queries * geo.tile + geo.queries + 2 * geo.tile
        return (2 * B * _even(M) + 2 * _even(self.n_mtiles * B) + _even(B)
                + self.n_tail * self.n_ksplit * part
                + (self.n_split * B * D if self.n_split > 1 else 0))


def geometry_for(D: int) -> Geometry | WideGeometry:
    if D < 1:
        raise ValueError(f"descriptor dimension {D} is not positive")
    if D > MAX_D:
        return WIDE
    return next(g for g in GEOMETRIES if D <= g.width)


def wide_plan(B: int, M: int, D: int, n_sm: int,
              geo: WideGeometry = WIDE) -> WidePlan:
    """The wide route for B >= 1 queries: chunks of queries whose weights fit
    WIDE_WEIGHT_DOUBLES.  A wave is ``n_sm`` SMs of ``geo.blocks_per_sm``
    blocks.  Pass 1: the tiles of the last wave, where it is not full (all
    tiles, where they fill less than one), are each cut into as many slices
    of D as fill that wave; pass 2: where its tiles fill less than a wave,
    slabs of the training rows likewise."""
    wave = n_sm * geo.blocks_per_sm
    b_chunk = max(geo.queries, min(WIDE_WEIGHT_DOUBLES // (2 * _even(M)),
                                   MAX_GRID_Y * geo.queries)
                  // geo.queries * geo.queries)
    Bc = min(B, b_chunk)
    n_qtiles = -(-Bc // geo.queries)
    n_mtiles = -(-M // geo.tile)
    tiles = n_qtiles * n_mtiles
    tail = tiles % wave
    k_steps = -(-D // geo.depth)
    n_ksplit = max(1, min(k_steps, wave // tail)) if tail else 1
    cols = -(-k_steps // n_ksplit) * geo.depth
    n_ksplit = -(-D // cols)
    n_dtiles = -(-D // geo.cols)
    m_steps = -(-M // geo.rows)
    n_split = max(1, min(m_steps, wave // (n_qtiles * n_dtiles), MAX_GRID_Y))
    rows = -(-m_steps // n_split) * geo.rows
    return WidePlan(geometry=geo, b_chunk=b_chunk, n_qtiles=n_qtiles,
                    n_mtiles=n_mtiles,
                    n_whole=tiles - tail if n_ksplit > 1 else tiles,
                    n_ksplit=n_ksplit, cols_per_slice=cols,
                    n_dtiles=n_dtiles, n_split=-(-M // rows),
                    rows_per_split=rows)


def plan_for(geo: Geometry, B: int, M: int, n_sm: int) -> Plan:
    """The plan for one instantiation of the kernel: the training axis is
    cut into as many slabs of whole stages as give every SM its
    ``blocks_per_sm`` blocks in one wave, for one query as for thousands."""
    n_qtiles = -(-B // geo.queries)
    n_stages = -(-M // TM)
    n_split = max(1, min(n_stages, geo.blocks_per_sm * n_sm // n_qtiles,
                         MAX_GRID_Y))
    rows = -(-n_stages // n_split) * TM
    return Plan(geometry=geo, n_qtiles=n_qtiles, n_split=-(-M // rows),
                rows_per_split=rows)


@functools.lru_cache(maxsize=64)
def plan(B: int, M: int, D: int, n_sm: int) -> Plan | WidePlan:
    """The geometry for B >= 1 queries against M >= 1 training rows of width
    D >= 1 on a card with ``n_sm`` SMs."""
    geo = geometry_for(D)
    if geo is WIDE:
        return wide_plan(B, M, D, n_sm)
    return plan_for(geo, B, M, n_sm)


def _check(Xq_query: torch.Tensor, Xqt: torch.Tensor, wt: torch.Tensor):
    for name, t in (("Xq_query", Xq_query), ("Xqt", Xqt), ("wt", wt)):
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != Xq_query.device:
            raise ValueError(f"{name} is on {t.device}, Xq_query on "
                             f"{Xq_query.device}")
    if Xqt.shape != wt.shape or Xq_query.shape[1] != Xqt.shape[1]:
        raise ValueError(f"shape mismatch: Xq_query {tuple(Xq_query.shape)}, "
                         f"Xqt {tuple(Xqt.shape)}, wt {tuple(wt.shape)}")


def desc_forces_fused_ref(Xq_query: torch.Tensor, Xqt: torch.Tensor,
                          wt: torch.Tensor, sig: float):
    """Plain PyTorch version of the kernel, f64: the distances, the
    ``pair_weights`` and the contraction ``desc_forces`` of
    ``ops/kernel.py``, the f64 Predictor's steps.  Returns
    (F_desc (B, D), E (B,))."""
    A_exp, A_exp1 = pair_weights(pairwise_dist_gram(Xq_query, Xqt), sig)
    return desc_forces(Xqt, sig, Xq_query, A_exp, A_exp1, wt)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of csrc/fused_predict.cu on a loaded
    library."""
    lib.mlff_fused_predict.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
        + [ctypes.c_double, ctypes.c_double, ctypes.c_void_p])
    lib.mlff_fused_predict.restype = ctypes.c_int
    lib.mlff_fused_predict_geometry.argtypes = [ctypes.c_int,
                                                ctypes.c_void_p]
    lib.mlff_fused_predict_geometry.restype = ctypes.c_int
    lib.mlff_fused_predict_wide.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
        + [ctypes.c_double, ctypes.c_double, ctypes.c_void_p])
    lib.mlff_fused_predict_wide.restype = ctypes.c_int
    lib.mlff_fused_predict_wide_geometry.argtypes = [ctypes.c_void_p]
    lib.mlff_fused_predict_wide_geometry.restype = ctypes.c_int
    return lib


def library_geometry(lib: ctypes.CDLL, D: int) -> tuple[int, int, int, int]:
    """(queries per block, threads, shared-memory bytes, resident blocks per
    SM) of the instantiation of ``lib`` that takes width D, on the current
    card."""
    out = (ctypes.c_int * 4)()
    err = lib.mlff_fused_predict_geometry(D, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"fused_predict geometry query failed: CUDA error "
                           f"{err}")
    return tuple(out)


def library_wide_geometry(lib: ctypes.CDLL) -> tuple[int, ...]:
    """The wide route of ``lib`` on the current card: (queries per tile;
    pass 1's training rows per tile, columns per stage, stages; pass 2's
    columns per tile, training rows per stage, stages; threads; dynamic
    shared bytes of pass 1 and pass 2; resident blocks per SM of pass 1 and
    pass 2; queries per block of the combine)."""
    out = (ctypes.c_int * 13)()
    err = lib.mlff_fused_predict_wide_geometry(ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"fused_predict wide geometry query failed: CUDA "
                           f"error {err}")
    return tuple(out)


def wide_geometry_matches(reported: tuple[int, ...]) -> bool:
    """Whether a library's ``library_wide_geometry`` is ``WIDE`` with at
    least one block of each pass resident per SM."""
    return (reported[:10] + reported[12:] == WIDE.library_tuple()
            and min(reported[10:12]) >= 1)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built library, once its constants are known to be ``GEOMETRIES``
    and ``WIDE``: a plan made for other tiles would leave rows or queries
    out."""
    lib = _bind(cuda_build.load("fused_predict"))
    wide = library_wide_geometry(lib)
    if not wide_geometry_matches(wide):
        raise RuntimeError(f"csrc/fused_predict.cu and ops/fused_predict.py "
                           f"disagree on the wide route: kernel {wide}, plan "
                           f"{WIDE}")
    for geo in GEOMETRIES:
        queries, threads, smem, resident = library_geometry(lib, geo.width)
        if ((queries, threads, smem) != (geo.queries, geo.threads,
                                         geo.smem_bytes) or resident < 1):
            raise RuntimeError(
                f"csrc/fused_predict.cu and ops/fused_predict.py disagree at "
                f"width {geo.width}: kernel {(queries, threads, smem)} with "
                f"{resident} resident blocks per SM, plan {geo}")
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def desc_forces_fused(Xq_query: torch.Tensor, Xqt: torch.Tensor,
                      wt: torch.Tensor, sig: float):
    """Fused (F_desc (B, D), E (B,)) contraction in f64.

    Xq_query (B, D): q-scaled query descriptors; Xqt (M, D): q-scaled
    permuted training descriptors; wt (M, D): permuted cotangents.  All f64,
    contiguous, on one device.  CUDA tensors go through the kernel (a failed
    build or launch raises); CPU tensors through ``desc_forces_fused_ref``.
    """
    _check(Xq_query, Xqt, wt)
    dev = Xq_query.device
    if dev.type == "cpu":
        return desc_forces_fused_ref(Xq_query, Xqt, wt, sig)
    if dev.type != "cuda":
        raise ValueError(f"desc_forces_fused runs on cuda or cpu, not {dev}")
    B, D = Xq_query.shape
    M = Xqt.shape[0]
    if B == 0 or M == 0:
        geometry_for(D)      # an empty call still refuses a width below 1
        return (torch.zeros((B, D), dtype=torch.float64, device=dev),
                torch.zeros((B,), dtype=torch.float64, device=dev))
    p = plan(B, M, D, _sm_count(dev.index))
    launch = _launch_wide if isinstance(p, WidePlan) else _launch
    if torch.cuda.current_device() == dev.index:
        F, E = launch(_library(), Xq_query, Xqt, wt, sig, p)
    else:
        with torch.cuda.device(dev):
            F, E = launch(_library(), Xq_query, Xqt, wt, sig, p)
    trace.count(LAUNCHES)
    return F, E


@functools.lru_cache(maxsize=8)
def _scratch(index: int, stream: int, doubles: int) -> torch.Tensor:
    """The slabs' partials of one device and stream: calls on one stream run
    in order, so they share it."""
    return torch.empty(doubles, dtype=torch.float64,
                       device=torch.device("cuda", index))


def _launch(lib: ctypes.CDLL, Xq_query, Xqt, wt, sig: float, p: Plan):
    """Both launches of one call on the current stream of the tensors'
    device (the caller has made it the current device)."""
    (B, D), M, dev = Xq_query.shape, Xqt.shape[0], Xq_query.device
    # what torch.cuda.current_stream(dev).cuda_stream gives, without
    # building the Stream object
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    f_out = torch.empty((B, D), dtype=torch.float64, device=dev)
    e_out = torch.empty((B,), dtype=torch.float64, device=dev)
    part = _scratch(dev.index, stream, p.n_split * (B * D + B))
    err = lib.mlff_fused_predict(
        Xq_query.data_ptr(), Xqt.data_ptr(), wt.data_ptr(), part.data_ptr(),
        f_out.data_ptr(), e_out.data_ptr(), B, M, D, p.n_split,
        p.rows_per_split, 5.0 / (3.0 * sig**2), SQRT5 / sig, stream)
    if err != 0:
        raise RuntimeError(f"fused_predict kernel launch failed: CUDA error "
                           f"{err}")
    return f_out, e_out


def _launch_wide(lib: ctypes.CDLL, Xq_query, Xqt, wt, sig: float,
                 p: WidePlan):
    """The wide route of one call, one pass per chunk of ``p.b_chunk``
    queries, on the current stream of the tensors' device: a call that fits
    one chunk runs as ``p`` says, the chunks of a larger one as their own
    plans say."""
    (B, D), M, dev = Xq_query.shape, Xqt.shape[0], Xq_query.device
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    f_out = torch.empty((B, D), dtype=torch.float64, device=dev)
    e_out = torch.empty((B,), dtype=torch.float64, device=dev)
    for b0 in range(0, B, p.b_chunk):
        Bc = min(p.b_chunk, B - b0)
        pc = p if Bc == B else plan(Bc, M, D, _sm_count(dev.index))
        scratch = _scratch(dev.index, stream, pc.scratch_doubles(Bc, M, D))
        err = lib.mlff_fused_predict_wide(
            Xq_query[b0:].data_ptr(), Xqt.data_ptr(), wt.data_ptr(),
            scratch.data_ptr(), f_out[b0:].data_ptr(), e_out[b0:].data_ptr(),
            Bc, M, D, pc.n_whole, pc.n_ksplit, pc.cols_per_slice,
            pc.n_split, pc.rows_per_split, 5.0 / (3.0 * sig**2), SQRT5 / sig,
            stream)
        if err != 0:
            raise RuntimeError(f"fused_predict wide launch failed: CUDA "
                               f"error {err}")
    return f_out, e_out


def bound_seconds(B: int, M: int, D: int, f64_peak: float,
                  mem_rate: float) -> tuple[float, str]:
    """(least time, "operations" or "bytes") of one ``desc_forces_fused``
    call on a card with the given f64 peak (FLOP/s) and memory rate
    (bytes/s).  Operations: the Gram distances (2 B M D), the contraction
    (dot 2 B M D, forces 4 B M D) and ~10 B M elementwise, exp counted as
    one.  Bytes: each input read once, each output written once."""
    t_ops = (8.0 * B * M * D + 10.0 * B * M) / f64_peak
    t_bytes = 8.0 * (B * D + 2 * M * D + B * D + B) / mem_rate
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
