"""The yardstick's constants and counts: the card's peaks, and the f64
operations and bytes of each layer a roofline or mfu metric reads, from
shapes alone.

Peaks: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet): 67
TFLOP/s in f64 on the tensor cores (DMMA, which cuBLAS's DGEMM and the
fused prediction kernel use) and 3.35 TB/s of HBM3.  A roofline share is
the least time these allow over the measured time; each input is counted
read once and each output written once.
"""

from __future__ import annotations

F64_PEAK = 67e12      # FLOP/s
MEM_RATE = 3.35e12    # bytes/s
F8 = 8                # bytes of an f64


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time of ``ops`` f64 operations over ``nbytes`` of memory
    traffic: the larger of the two bounds."""
    return max(ops / F64_PEAK, nbytes / MEM_RATE)


# -- the fused prediction kernel: a frozen copy of
#    mlff_tpu_torch/ops/fused_predict.py::bound_seconds ------------------

def fused_predict_ops(B: int, M: int, D: int) -> float:
    """Operations of one fused contraction of B queries against M permuted
    training descriptors of width D: the Gram distances (2 B M D), the
    contraction (dot 2 B M D, forces 4 B M D) and ~10 B M elementwise, exp
    counted as one."""
    return 8.0 * B * M * D + 10.0 * B * M


def fused_predict_bytes(B: int, M: int, D: int) -> float:
    """Bytes of one fused contraction: the queries and both (M, D) inputs
    read once, the (B, D) forces and (B,) energies written once."""
    return F8 * (B * D + 2 * M * D + B * D + B)


def fused_predict_seconds(B: int, M: int, D: int) -> float:
    return least_seconds(fused_predict_ops(B, M, D),
                         fused_predict_bytes(B, M, D))


# -- the cached kernel matvec (K + lam I) v ------------------------------

def matvec_ops(N: int, M: int, D: int) -> float:
    """Three (N, M) x (M, D) products: 6 N M D."""
    return 6.0 * N * M * D


def matvec_bytes(N: int, M: int, D: int, A: int) -> float:
    """The two (N, M) f64 weight arrays, the (M, D) permuted and (N, D)
    scaled descriptors, the (N, D, 3) Jacobians, the (D, A) incidence
    matrix, the operand and the output (n = 3 A N each), each once."""
    n = 3 * A * N
    return F8 * (2 * N * M + M * D + N * D + 3 * N * D + D * A + 2 * n)


def matvec_seconds(N: int, M: int, D: int, A: int) -> float:
    return least_seconds(matvec_ops(N, M, D), matvec_bytes(N, M, D, A))


# -- the Woodbury preconditioner apply over the (n, k) factor ------------

def apply_ops(n: int, k: int) -> float:
    """Two passes over B (B^T v and B x): 4 n k."""
    return 4.0 * n * k


def apply_bytes(n: int, k: int) -> float:
    """B (n, k) read once, the operand read and the output written."""
    return F8 * (n * k + 2 * n)


def apply_seconds(n: int, k: int) -> float:
    return least_seconds(apply_ops(n, k), apply_bytes(n, k))


# -- one PCG iteration ----------------------------------------------------

CG_VECTOR_OPS_PER_N = 10   # two dots, three axpys: 2 n each


def cg_iteration_ops(N: int, M: int, D: int, A: int, k: int) -> float:
    """The matvec, the apply and the vector operations of one PCG
    iteration."""
    n = 3 * A * N
    return (matvec_ops(N, M, D) + apply_ops(n, k)
            + CG_VECTOR_OPS_PER_N * n)
