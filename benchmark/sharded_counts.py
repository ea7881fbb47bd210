"""The f64 operations and bytes of the row-sharded training's layers, from
shapes alone, for the readers of a cell on more than one card
(``peaks.py`` keeps the peaks and the single-card counts).

The on-the-fly matvec (``ops/kernel.py::_matvec_ref_otf``) recomputes the
pairwise weights of its ``rows`` rows against all M permuted training
descriptors in every call: per row tile one (tile, D) x (D, M) distance
Gram, exp and the (1 + dist) weight, then the three products of the
contraction.  Each rank runs rows = N / ranks of them.
"""

from __future__ import annotations

from benchmark import peaks


def otf_matvec_ops(rows: int, M: int, D: int) -> float:
    """The distance Gram (2 rows M D) and the three products (6 rows M D),
    and ~10 rows M elementwise (the Gram's assembly, sqrt, exp, the
    weights and the contraction's scaling; exp counted as one)."""
    return 8.0 * rows * M * D + 10.0 * rows * M


def otf_matvec_bytes(rows: int, M: int, D: int) -> float:
    """The tile loop's inputs read once (the rank's (rows, D) scaled
    descriptors, the (M, D) permuted descriptors and the (M, D) permuted
    cotangents) and its (rows, D) output written once: nothing (rows, M)
    need leave the chip."""
    return peaks.F8 * (rows * D + 2 * M * D + rows * D)


def otf_matvec_seconds(rows: int, M: int, D: int) -> float:
    return peaks.least_seconds(otf_matvec_ops(rows, M, D),
                               otf_matvec_bytes(rows, M, D))


def sharded_cg_iteration_ops(N: int, M: int, D: int, n: int,
                             k: int) -> float:
    """One PCG iteration on all ranks together: the on-the-fly matvec over
    all N rows, the apply's 4 n k and the vector operations' 10 n."""
    return (otf_matvec_ops(N, M, D) + peaks.apply_ops(n, k)
            + peaks.CG_VECTOR_OPS_PER_N * n)
