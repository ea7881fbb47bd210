"""The row-sharded preconditioner apply's share of its roofline on one
rank, %: the least time of a rank's apply (``peaks.apply_seconds`` at its
n / chips rows of B: 4 r k operations, its (r, k) block read once) over
the card's time per call, the union of the device intervals of the
profiler's records launched inside the profiled training's
``precon.apply`` spans but outside the ``mesh.collective`` in them (the
all-reduce of B^T v, which holds NCCL's wait for the slowest rank), over
their count (``benchmark/spans.py``).  Two passes over B make 50% its
ceiling.  Rank 0's card.  None off the card, or for a program without the
span."""

from benchmark import peaks, sharded_spans, spans


def read(ctx):
    got = spans.profiled(ctx)
    if got is None:
        return None
    rec = got[0]
    calls = rec.named("precon.apply")
    if not calls:
        return None
    per_call = sharded_spans.device_seconds(sharded_spans.launched_in(
        got, calls, outside=rec.named("mesh.collective"))) / len(calls)
    if per_call <= 0:
        return None
    s = ctx.session.shapes
    return 100.0 * peaks.apply_seconds(s["n"] // ctx.cell.chips,
                                       s["k"]) / per_call
