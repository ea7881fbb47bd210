"""The on-the-fly matvec's share of its roofline on one rank, %: the least
time of a rank's tile loop (``sharded_counts.otf_matvec_seconds`` at its
N / chips rows: 8 rows M D + 10 rows M operations; its inputs read and
its output written once) over the card's time per call, the union of the
device intervals of the profiler's records launched inside the profiled
training's ``matvec.otf`` spans over their count (``benchmark/spans.py``).
Rank 0's card.  None off the card, or for a program without the span."""

from benchmark import sharded_counts, sharded_spans, spans


def read(ctx):
    got = spans.profiled(ctx)
    if got is None:
        return None
    calls = got[0].named("matvec.otf")
    if not calls:
        return None
    s = ctx.session.shapes
    per_call = sharded_spans.device_seconds(
        sharded_spans.launched_in(got, calls)) / len(calls)
    if per_call <= 0:
        return None
    rows = s["N"] // ctx.cell.chips
    return 100.0 * sharded_counts.otf_matvec_seconds(
        rows, s["M"], s["D"]) / per_call
