"""The program's own spans, read by the per-layer metrics of the layers
they bound.

The port's tracer (``mlff_tpu_torch.utils.trace``) records spans at the
layer boundaries of ``Trainer.train`` and ``Predictor.predict``.  This
module runs the session's frozen ``traced`` work (one training, or the
mix's ``trace_calls`` calls; never ``request``, so a prediction cell's
kept answers are not touched) inside a recording, once per run:

  * ``recorded``: with no profiler, for the host-time metrics;
  * ``profiled``: on the card, once more under the profiler (the stretch
    of ``devtrace.profile``), for the device records of each span.  The
    recorder's spans are placed on the profiler's Unix-epoch clock.

A device record belongs to the span that holds the host call that
launched it (the CUDA API record, ``cu*``, of the same correlation id),
not to the span its device time falls in: on one card the profiler's
device timeline was seen shifted against its host timeline by 0.1-0.6 ms
over a whole profile of 100 prediction calls and by ~4.3 ms over most of
a training, while its host records stayed within ~0.2 ms of the spans.  An idle gap of the device is placed
on the host's clock by the launch of the work that ends it.

Each is memoized on the session.  A program without the tracer gives
None, and so does ``profiled`` off the card; a reader then returns None.
The spans open no profiler range, so the profiled records are those of an
untraced program (``tests/test_torch_cuda.py`` checks it on the card).
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import devtrace


def _trace():
    try:
        from mlff_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def recorded(ctx):
    """The recorder of the session's traced work, run once with no
    profiler; None without the tracer."""
    s = ctx.session
    if not hasattr(s, "_spans_recorded"):
        trace = _trace()
        rec = None
        if trace is not None:
            with trace.recording() as rec:
                s.traced()
        s._spans_recorded = rec
    return s._spans_recorded


def profiled(ctx):
    """(recorder, ``devtrace.Trace``, launched) of the traced work run once
    more under the profiler, ``launched[i]`` the Unix-epoch start of the
    host call that launched ``trace.device[i]`` (None when the profiler
    linked none); None off the card or without the tracer."""
    s = ctx.session
    if not hasattr(s, "_spans_profiled"):
        trace = _trace()
        out = None
        if trace is not None and ctx.device.type == "cuda":
            import torch

            held = {}

            def work():
                with trace.recording() as rec:
                    s.traced()
                held["rec"] = rec

            tr, launched = profile(torch, work)
            out = (held["rec"], tr, launched)
        s._spans_profiled = out
    return s._spans_profiled


def profile(torch, fn):
    """``devtrace.profile``'s stretch, keeping each device record's launch:
    (``devtrace.Trace``, the launching host call's start for each device
    record, or None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    device, dev_corr, host, host_at = [], [], [], {}
    for e in prof.profiler.kineto_results.events():
        rec = (e.name(), e.start_ns() * 1e-9, e.end_ns() * 1e-9)
        if e.device_type() == DeviceType.CUDA:
            if not any(w in rec[0] for w in devtrace.NOT_WORK):
                device.append(rec)
                dev_corr.append(e.correlation_id())
        else:
            host.append(rec)
            # the CUDA API calls (cudaLaunchKernel, cuLaunchKernel,
            # cudaMemcpyAsync, ...) share the device records' ids; the
            # torch ops ("aten::...") number theirs on their own
            if rec[0].startswith("cu"):
                host_at[e.correlation_id()] = rec[1]
    if not device:
        raise RuntimeError("torch.profiler recorded no device activity")
    launched = [host_at.get(c) if c else None for c in dev_corr]
    return devtrace.Trace(window_s=window_s, device=device,
                          host=host), launched


def seconds(rec, name: str) -> float:
    """The summed seconds of the spans named ``name``."""
    return float(sum(s.seconds for s in rec.named(name)))


def solver_iters(rec) -> int:
    """The CG iterations of the recorded work (the chunks' ``iters``)."""
    return sum(s.attrs["iters"] for s in rec.named("cg.chunk"))


def calls(rec) -> int:
    """The ``predict`` requests of the recorded work."""
    return sum(1 for s in rec.roots() if s.name == "predict")


def train_seconds(ctx, name: str):
    """``seconds(name)`` of the recorded training; None without the
    tracer."""
    rec = recorded(ctx)
    return None if rec is None else seconds(rec, name)


def cg_ms_per_iter(ctx, name: str):
    """Milliseconds of the spans ``name`` per CG iteration of the recorded
    training."""
    rec = recorded(ctx)
    if rec is None or not solver_iters(rec):
        return None
    return 1e3 * seconds(rec, name) / solver_iters(rec)


def ms_per_call(ctx, name: str):
    """Milliseconds of the spans ``name`` per recorded ``predict`` call."""
    rec = recorded(ctx)
    if rec is None or not calls(rec):
        return None
    return 1e3 * seconds(rec, name) / calls(rec)


def self_seconds(s, children) -> float:
    """A span's duration less the union of its children's intervals, each
    clipped to it."""
    inside = [(max(c.start, s.start), min(c.end, s.end)) for c in children]
    return s.seconds - devtrace.union_seconds(
        (a, b) for a, b in inside if b > a)


def host_ms_per_call(ctx):
    """Per recorded ``predict`` call, the summed self time of the call's
    spans but ``predict.d2h`` (the wait for the device and the copy
    back): the host's time queueing the call's work, ms."""
    rec = recorded(ctx)
    if rec is None or not calls(rec):
        return None
    kids: dict = {}
    for s in rec.spans:
        kids.setdefault(s.parent, []).append(s)
    host = sum(self_seconds(s, kids.get(s.id, ())) for s in rec.spans
               if s.request is not None and s.name != "predict.d2h")
    return 1e3 * host / calls(rec)


def _launched_in(got, name: str) -> list:
    """The device records launched inside the spans ``name``."""
    rec, tr, launched = got
    spans = [(rec.epoch(s.start), rec.epoch(s.end)) for s in rec.named(name)]
    return [r for r, t in zip(tr.device, launched) if t is not None
            and any(a <= t < b for a, b in spans)]


def cg_device_ms_per_iter(ctx):
    """The union of the device intervals of the records launched inside
    the profiled training's ``cg`` span, ms per CG iteration."""
    got = profiled(ctx)
    if got is None:
        return None
    records = _launched_in(got, "cg")
    return 1e3 * devtrace.union_seconds(
        (s, e) for _, s, e in records) / solver_iters(got[0])


def cg_launches_per_iter(ctx):
    """The kernel records launched inside the profiled training's ``cg``
    span per iteration queued (the chunks' ``steps``: the last chunk's
    iterations past convergence are masked, and launch as the others), so
    that the count repeats from seed to seed."""
    got = profiled(ctx)
    if got is None:
        return None
    kernels = [r for r in _launched_in(got, "cg")
               if not r[0].startswith(devtrace.NOT_KERNEL)]
    steps = sum(s.attrs["steps"] for s in got[0].named("cg.chunk"))
    return len(kernels) / steps


def idle_unattributed_percent(ctx):
    """Of the device's idle seconds in the profiled stretch (from the
    first request's start to the last one's end), the share, %, in gaps
    whose midpoint lies in no span below a request root.  A gap ends where
    the device starts the next work; it is placed on the host's clock by
    that work's launch (the device started it once launched)."""
    got = profiled(ctx)
    if got is None:
        return None
    rec, tr, launched = got
    order = sorted(range(len(tr.device)), key=lambda i: tr.device[i][1])
    # busy intervals of the device, each with the lag of its first record
    # (device start less launch), which carries device time to host time
    busy = []
    for i in order:
        _, s, e = tr.device[i]
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            lag = s - launched[i] if launched[i] is not None else 0.0
            busy.append([s, e, lag])
    roots = rec.roots()
    lo = min(rec.epoch(r.start) for r in roots)
    hi = max(rec.epoch(r.end) for r in roots)
    gaps = []          # (host start, host end)
    prev_end = lo
    for s, e, lag in busy:
        gaps.append((max(prev_end, lo), min(s - lag, hi)))
        prev_end = e - lag
    gaps.append((max(prev_end, lo), hi))
    gaps = np.array([g for g in gaps if g[1] > g[0]])
    if gaps.size == 0:
        return 0.0
    named = devtrace.merged(
        (rec.epoch(s.start), rec.epoch(s.end)) for s in rec.spans
        if s.request is not None and s.id != s.request)
    mid = gaps.mean(axis=1)
    length = gaps[:, 1] - gaps[:, 0]
    covered = np.zeros(len(mid), dtype=bool)
    if named:
        starts = np.array([a for a, _ in named])
        ends = np.array([b for _, b in named])
        i = np.searchsorted(starts, mid, side="right") - 1
        covered = (i >= 0) & (mid <= ends[np.maximum(i, 0)])
    return 100.0 * float(length[~covered].sum() / length.sum())
