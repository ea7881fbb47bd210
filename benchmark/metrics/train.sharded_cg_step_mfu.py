"""The sharded PCG iteration's share of the cards' f64 peak, %: the f64
operations of one iteration on all ranks (``sharded_counts.
sharded_cg_iteration_ops``: the on-the-fly matvec's 8 N M D + 10 N M, the
apply's 4 n k, the vector operations' 10 n) over the milliseconds per
iteration (the window's ``total_time_cg`` over its ``solver_iters``), over
``chips`` times one card's peak."""

from benchmark import peaks, sharded_counts
from benchmark.readers import spans


def read(ctx):
    s = ctx.session.shapes
    per_iter_s = sum(spans(ctx, "total_time_cg")) / sum(
        spans(ctx, "solver_iters"))
    ops = sharded_counts.sharded_cg_iteration_ops(s["N"], s["M"], s["D"],
                                                  s["n"], s["k"])
    return 100.0 * ops / per_iter_s / (ctx.cell.chips * peaks.F64_PEAK)
