"""The Nystrom build's host stages of one training, s: the spans
``precon.nystrom.{gather_Kmm, host_W1, gram_probe, host_W2}`` of a
recorded training's factor, those of the leverage scores' small factor
left out (``benchmark/spans.py``)."""

from benchmark import spans

NAMES = {f"precon.nystrom.{stage}"
         for stage in ("gather_Kmm", "host_W1", "gram_probe", "host_W2")}


def read(ctx):
    rec = spans.recorded(ctx)
    if rec is None:
        return None
    return float(sum(s.seconds for s in rec.spans if s.name in NAMES
                     and not rec.under(s, "precon.leverage")))
