"""The whole predict call's share of the f64 peak, %: the fused
contraction's operations (``peaks.fused_predict_ops``) for every batch of
every call of the window, over the window's seconds."""

from benchmark import peaks


def read(ctx):
    s = ctx.session.shapes
    g, b = s["g"], s["batch"]
    whole, rest = divmod(g, b)
    per_call = whole * peaks.fused_predict_ops(b, s["M"], s["D"])
    if rest:
        per_call += peaks.fused_predict_ops(rest, s["M"], s["D"])
    return 100.0 * per_call * len(ctx.records) / ctx.window_s / peaks.F64_PEAK
