"""The collectives a sharded CG iteration issues: the ``mesh.collective``
spans inside the recorded training's ``cg`` span (each collective opens
one and counts one ``mesh.collectives``), over its iterations
(``benchmark/spans.py`` records the training).  None for a training that
issues none: an unsharded one."""

from benchmark import sharded_spans, spans


def read(ctx):
    rec = spans.recorded(ctx)
    if rec is None:
        return None
    calls = sharded_spans.inside_cg(rec, "mesh.collective")
    iters = spans.solver_iters(rec)
    return len(calls) / iters if calls and iters else None
