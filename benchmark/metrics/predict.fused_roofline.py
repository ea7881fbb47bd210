"""The fused prediction kernel's share of its roofline, %: the least time
of one batch (``peaks.fused_predict_seconds``) over the profiler's summed
time of the fused kernels per batch of the traced calls.  None when the
trace holds no fused kernel."""

from benchmark import peaks

# the kernels of mlff_tpu_torch/csrc/fused_predict.cu: the narrow route's
# two, the wide route's four
FUSED = ("contract_partial", "sum_splits", "wide_weights", "wide_combine",
         "wide_forces", "wide_finish")


def read(ctx):
    if ctx.trace is None:
        return None
    seconds, count = ctx.trace.seconds_of(FUSED)
    if count == 0:
        return None
    s = ctx.session.shapes
    g, b = s["g"], s["batch"]
    if g % b:
        return None
    batches = int(ctx.cell.mix["trace_calls"]) * (g // b)
    return 100.0 * peaks.fused_predict_seconds(b, s["M"], s["D"]) / (
        seconds / batches)
