"""Fused descriptor-space force/energy contraction for prediction.

The CUDA kernel ``csrc/fused_predict.cu`` replaces the TPU kernel
``mlff_tpu/ops/pallas_predict.py::_contract_kernel``.  For a batch of query
descriptors against the permuted training set it computes

    dist  = ||q x_b - q x~_m||            (f64 Gram trick, outside the kernel)
    a     = 5/(3 sig^2) exp(-dist)
    dot   = (q x_b - q x~_m) . w~_m
    F     = sum_m a [ dot (q x_b - q x~_m) - (1 + dist) w~_m ]
    E     = sum_m a (1 + dist) dot / q

without writing the (B, M) intermediates other than ``dist`` to device
memory.  The arithmetic is f64, not the TPU kernel's f32: the cotangents w~
of a lam = 1e-10 ridge solve are orders of magnitude larger than the forces
they sum to, and an f32 contraction of a trained model misses the f64
forces by far more than the tolerance of the f32 path
(``tests/test_torch_fused_predict.py`` shows it on the JAX kernel itself).

``desc_forces_fused`` launches the kernel for CUDA tensors (or raises) and
runs the plain PyTorch version ``desc_forces_fused_ref`` for CPU tensors.
``desc_forces_fused.launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .kernel import SQRT5, pairwise_dist_gram

# tile sizes of csrc/fused_predict.cu
TB, TM = 32, 64
# the kernel stages 2 TB D + 2 TM (D + 1) + 2 TB (TM + 1) f64 values in
# shared memory; 227 KB per block bounds D
SMEM_LIMIT = 232448
MAX_D = (SMEM_LIMIT // 8 - 2 * TM - 2 * TB * (TM + 1)) // (2 * TB + 2 * TM)


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
    """Plain PyTorch version of the kernel, f64.  Returns
    (F_desc (B, D), E (B,))."""
    dist = pairwise_dist_gram(Xq_query, Xqt)
    a = (5.0 / (3.0 * sig**2)) * torch.exp(-dist)
    ct = torch.sum(Xqt * wt, dim=1)
    dot = Xq_query @ wt.T - ct[None, :]
    G = a * dot
    a1 = a * (1.0 + dist)
    F = Xq_query * torch.sum(G, dim=1, keepdim=True) - G @ Xqt - a1 @ wt
    E = torch.sum(a1 * dot, dim=1) / (SQRT5 / sig)
    return F, E


def split_plan(B: int, M: int, n_sm: int) -> tuple[int, int]:
    """(n_split, rows_per_split): slabs of the training axis per query tile,
    chosen so the grid fills the card in one wave of at most 2 blocks per SM
    (the shared-memory limit at D = 36); slabs are whole TM tiles."""
    n_btiles = -(-B // TB)
    n_tiles = -(-M // TM)
    n_split = max(1, min(n_tiles, 2 * n_sm // n_btiles))
    rows = -(-n_tiles // n_split) * TM
    return -(-M // rows), rows


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("fused_predict")
    fn = lib.mlff_fused_predict
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_double, ctypes.c_double, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


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
    if D > MAX_D:
        raise ValueError(f"descriptor dimension {D} exceeds the kernel's "
                         f"shared-memory limit of {MAX_D}")
    f_out = torch.zeros((B, D), dtype=torch.float64, device=dev)
    e_out = torch.zeros((B,), dtype=torch.float64, device=dev)
    if B == 0 or M == 0:
        return f_out, e_out
    lib = _library()
    with torch.cuda.device(dev):
        dist = pairwise_dist_gram(Xq_query, Xqt)             # (B, M) f64
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        n_split, rows = split_plan(B, M, n_sm)
        f_part = torch.empty((n_split, B, D), dtype=torch.float64, device=dev)
        e_part = torch.empty((n_split, B), dtype=torch.float64, device=dev)
        err = lib.mlff_fused_predict(
            Xq_query.data_ptr(), Xqt.data_ptr(), wt.data_ptr(),
            dist.data_ptr(), f_part.data_ptr(), e_part.data_ptr(),
            f_out.data_ptr(), e_out.data_ptr(), B, M, D, n_split, rows,
            5.0 / (3.0 * sig**2), SQRT5 / sig,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_predict kernel launch failed: CUDA error "
                           f"{err}")
    desc_forces_fused.launches += 1
    return f_out, e_out


desc_forces_fused.launches = 0


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
