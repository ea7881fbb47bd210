"""The whole PCG iteration's share of the f64 peak, %: the f64
operations of one iteration counted from shapes (``peaks.
cg_iteration_ops``: the matvec's 6 N M D, the apply's 4 n k, the vector
operations) over the milliseconds per iteration (``train.cg_ms_per_iter``)."""

from benchmark import peaks
from benchmark.readers import spans


def read(ctx):
    s = ctx.session.shapes
    per_iter_s = sum(spans(ctx, "total_time_cg")) / sum(
        spans(ctx, "solver_iters"))
    ops = peaks.cg_iteration_ops(s["N"], s["M"], s["D"], s["A"], s["k"])
    return 100.0 * ops / per_iter_s / peaks.F64_PEAK
