"""The share of the recorded training's CG iterations that ran by
replaying the captured iteration (a CUDA graph): what the counter
``cg.graph_iters`` added while recording, over the ``cg`` spans'
``iters`` (``benchmark/spans.py`` records the training).  0 off the
card; None for a program that captures no iteration."""

from benchmark import spans


def _graph_counter():
    """The program's counter of the CG iterations that ran by replaying a
    captured iteration; None for a program that captures none."""
    try:
        from mlff_tpu_torch.solvers import cg
    except ImportError:
        return None
    return getattr(cg, "GRAPH_ITERS", None)


def read(ctx):
    name = _graph_counter()
    if name is None:
        return None
    rec = spans.recorded(ctx)
    if rec is None:
        return None
    iters = sum(s.attrs["iters"] for s in rec.named("cg"))
    return rec.counted(name) / iters if iters else None
