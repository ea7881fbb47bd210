"""Double-f32 (df64) GEMV passes of the Woodbury preconditioner apply.

The CUDA kernels in ``csrc/df64_gemv.cu`` replace the TPU kernels
``mlff_tpu/ops/pallas_df64.py::_bt_v_kernel`` (``u = B^T v``) and
``::_b_x_kernel`` (``y = B x``).  B (n, m) is an f32 (hi, lo) pair, the
vector and the result are f64.  Each product is an error-free hi*hi product
plus the cross terms, summed in compensated df64 arithmetic: ~2^-48
relative, f64-class for the solver, from B stored in f32 words.

``df64_bt_v`` and ``df64_b_x`` launch the kernels for CUDA tensors (a failed
build or launch raises) and run the plain PyTorch versions
``df64_bt_v_ref`` / ``df64_b_x_ref`` (``ops/df64.py``) for CPU tensors.
Each wrapper counts its launches in ``.launches``.  Nothing is padded: any
(n, m) is taken as it is.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from . import df64

BT_SLAB = 256   # rows per bt_v block (csrc/df64_gemv.cu)
SMEM_LIMIT = 232448
MAX_M = SMEM_LIMIT // 8   # b_x stages x as (hi, lo) in shared memory
# f32 operations per element in either pass: hi*hi product and its fmaf
# error (3), cross terms (4), df64 accumulation (11)
OPS_PER_ELEMENT = 18


def _check(Bh: torch.Tensor, Bl: torch.Tensor, vec: torch.Tensor, axis: int):
    for name, t in (("Bh", Bh), ("Bl", Bl)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
    if vec.dtype != torch.float64 or vec.dim() != 1:
        raise TypeError(f"the vector must be 1-D float64, got {vec.dtype} "
                        f"with shape {tuple(vec.shape)}")
    if Bl.shape != Bh.shape or vec.shape[0] != Bh.shape[axis]:
        raise ValueError(f"shape mismatch: Bh {tuple(Bh.shape)}, Bl "
                         f"{tuple(Bl.shape)}, vector {tuple(vec.shape)}")
    if Bl.device != Bh.device or vec.device != Bh.device:
        raise ValueError("Bh, Bl and the vector must lie on one device")
    if Bh.device.type not in ("cpu", "cuda"):
        raise ValueError(f"df64 passes run on cuda or cpu, not {Bh.device}")


def df64_bt_v_ref(Bh: torch.Tensor, Bl: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``df64_bt_v``: pairwise-tree reduction over
    all rows.  f64 (m,)."""
    vh, vl = df64.split_f64(v)
    return df64.join_f64(*df64.df64_dot_bv(Bh, Bl, vh, vl))


def df64_b_x_ref(Bh: torch.Tensor, Bl: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``df64_b_x``.  f64 (n,)."""
    xh, xl = df64.split_f64(x)
    return df64.join_f64(*df64.df64_dot_bx(Bh, Bl, xh, xl))


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("df64_gemv")
    lib.mlff_df64_bt_v.argtypes = ([ctypes.c_void_p] * 6
                                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.mlff_df64_bt_v.restype = ctypes.c_int
    lib.mlff_df64_b_x.argtypes = ([ctypes.c_void_p] * 4
                                  + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.mlff_df64_b_x.restype = ctypes.c_int
    return lib


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def df64_bt_v(Bh: torch.Tensor, Bl: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """u = B^T v (f64 (m,)) for B (n, m) given as the f32 pair (Bh, Bl) and
    v (n,) f64.  CUDA tensors go through the kernel, CPU tensors through
    ``df64_bt_v_ref``."""
    _check(Bh, Bl, v, axis=0)
    if Bh.device.type == "cpu":
        return df64_bt_v_ref(Bh, Bl, v)
    n, m = Bh.shape
    dev = Bh.device
    u = torch.zeros(m, dtype=torch.float64, device=dev)
    if n == 0 or m == 0:
        return u
    n_slab = -(-n // BT_SLAB)
    if n_slab > 65535:
        raise ValueError(f"{n} rows exceed the kernel's grid ({65535 * BT_SLAB})")
    lib = _library()
    v = v.contiguous()
    with torch.cuda.device(dev):
        part_h = torch.empty((n_slab, m), dtype=torch.float32, device=dev)
        part_l = torch.empty_like(part_h)
        err = lib.mlff_df64_bt_v(
            Bh.data_ptr(), Bl.data_ptr(), v.data_ptr(),
            part_h.data_ptr(), part_l.data_ptr(), u.data_ptr(), n, m,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "df64_bt_v")
    df64_bt_v.launches += 1
    return u


def df64_b_x(Bh: torch.Tensor, Bl: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """y = B x (f64 (n,)) for B (n, m) given as the f32 pair (Bh, Bl) and
    x (m,) f64.  CUDA tensors go through the kernel, CPU tensors through
    ``df64_b_x_ref``."""
    _check(Bh, Bl, x, axis=1)
    if Bh.device.type == "cpu":
        return df64_b_x_ref(Bh, Bl, x)
    n, m = Bh.shape
    dev = Bh.device
    y = torch.zeros(n, dtype=torch.float64, device=dev)
    if n == 0 or m == 0:
        return y
    if m > MAX_M:
        raise ValueError(f"{m} columns exceed the kernel's shared-memory "
                         f"limit of {MAX_M}")
    lib = _library()
    x = x.contiguous()
    with torch.cuda.device(dev):
        err = lib.mlff_df64_b_x(
            Bh.data_ptr(), Bl.data_ptr(), x.data_ptr(),
            y.data_ptr(), n, m, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "df64_b_x")
    df64_b_x.launches += 1
    return y


df64_bt_v.launches = 0
df64_b_x.launches = 0


def bound_seconds(n: int, m: int, f32_peak: float,
                  mem_rate: float) -> tuple[float, str]:
    """(least time, "operations" or "bytes") of one pass, either direction,
    over B (n, m) on a card with the given f32 peak (FLOP/s) and memory rate
    (bytes/s).  Operations: ``OPS_PER_ELEMENT`` f32 per element of B.
    Bytes: Bh and Bl read once, the f64 vector read and the f64 result
    written once."""
    t_ops = OPS_PER_ELEMENT * n * m / f32_peak
    t_bytes = (8.0 * n * m + 8.0 * (n + m)) / mem_rate
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
