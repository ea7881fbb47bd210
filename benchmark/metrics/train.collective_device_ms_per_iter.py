"""The card's time in the sharded CG loop's collectives, ms per
iteration: the union of the device intervals of the profiler's records
launched inside ``mesh.collective`` spans within the profiled training's
``cg`` span (``benchmark/spans.py``'s launch placement), over its
iterations: NCCL's kernel, one per collective, and the copies around it.
NCCL's kernels run until the slowest rank arrives, so this holds the wait
for it, as the loop pays it.  Rank 0's card.  None off the card, or with
no collective."""

from benchmark import sharded_spans, spans


def read(ctx):
    got = spans.profiled(ctx)
    if got is None:
        return None
    rec = got[0]
    calls = sharded_spans.inside_cg(rec, "mesh.collective")
    iters = spans.solver_iters(rec)
    if not calls or not iters:
        return None
    return 1e3 * sharded_spans.device_seconds(
        sharded_spans.launched_in(got, calls)) / iters
