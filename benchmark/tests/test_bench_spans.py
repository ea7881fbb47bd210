"""The readers of the program's spans (``benchmark/spans.py``): rehearsed
on the CPU in every cell, their device arithmetic on a hand-made timeline,
and the spans' absence from the profiler's records."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import devtrace, harness, spans
from benchmark.tests import tiny
from mlff_tpu_torch.utils import trace

M = harness.load_json(harness.MANIFEST)
# the manifest's cells and the held-back ones, whose files stay
CELLS = [w["name"] for w in M["workloads"]] + tiny.HELD_CELLS
SPAN_METRICS = {"train.descriptors_s", "train.leverage_s",
                "train.nystrom_host_s", "train.cg_enqueue_ms_per_iter",
                "train.cg_read_ms_per_iter", "train.cg_device_ms_per_iter",
                "train.cg_launches_per_iter", "train.finalize_s",
                "predict.host_ms_per_call", "md.host_ms_per_call",
                "predict.descriptors_ms_per_call",
                "md.descriptors_ms_per_call", "predict.d2h_ms_per_call",
                "md.d2h_ms_per_call", "train.idle_unattributed_share",
                "predict.idle_unattributed_share",
                "md.idle_unattributed_share"}


@pytest.mark.parametrize("name", CELLS)
def test_span_readers_rehearsed(name):
    """A traced run on the CPU: every program_span metric of the spans is
    read and positive, every device_trace one left out."""
    c = tiny.cell(name)
    mine = [m for m in c.per_layer if m["name"] in SPAN_METRICS]
    assert mine
    out = tiny.run(c, trace=True)
    assert out["correct"] is True
    for m in mine:
        if m["source"] == "device_trace":
            assert m["name"] not in out["metrics"]
        else:
            assert out["metrics"][m["name"]]["value"] > 0, m["name"]


def test_span_metrics_are_in_the_manifest():
    """In ``BENCHMARK.json``, or in a held-back cell's entries."""
    assert SPAN_METRICS <= {m["name"] for m in tiny.manifest()["per_layer"]}


def scripted(monkeypatch, ticks):
    it = iter(ticks)
    monkeypatch.setattr(time, "perf_counter", lambda: next(it))


def profiled_ctx(rec, device, launched):
    tr = devtrace.Trace(window_s=10.0, device=device)
    session = SimpleNamespace(_spans_profiled=(rec, tr, launched))
    return SimpleNamespace(session=session, device=torch.device("cuda"))


def test_cg_device_readers_on_a_hand_made_timeline(monkeypatch):
    """A training whose ``cg`` span (1-9 s on the host) holds two chunks of
    2 and 1 iterations (4 queued).  Device records: k0 launched before
    ``cg``; k1 and k2 launched inside it and overlapping; k3 launched
    inside it but placed before it on a device timeline shifted against
    the host's; a copy launched inside it.  A record belongs to the span
    of its launch."""
    scripted(monkeypatch, [0.0, 1.0, 1.0, 2.0, 2.0, 3.0, 3.0, 4.0, 4.0, 5.0,
                           9.0, 10.0])
    with trace.recording() as rec:
        with trace.request("train"):
            with trace.span("cg") as cg:
                for iters in (2, 1):
                    with trace.span("cg.chunk") as c:
                        pass
                    c.set("iters", iters)
                    c.set("steps", 2)
                    with trace.span("cg.read"):
                        pass
            cg.set("iters", 3)
    rec.offset_s = 100.0
    device = [("k0", 100.5, 101.5), ("k1", 102.0, 103.0),
              ("k2", 102.5, 104.0), ("k3", 100.2, 100.4),
              ("Memcpy DtoH", 105.0, 106.0)]
    launched = [100.4, 101.5, 101.6, 101.8, 104.9]
    ctx = profiled_ctx(rec, device, launched)
    # k1..k3 and the copy: 2.0 + 0.2 + 1.0 s over 3 iterations
    assert spans.cg_device_ms_per_iter(ctx) == pytest.approx(3.2e3 / 3)
    # kernels k1, k2, k3 over 4 queued iterations
    assert spans.cg_launches_per_iter(ctx) == pytest.approx(3 / 4)


def test_idle_unattributed_on_a_hand_made_timeline(monkeypatch):
    """A request 0-10 s with one span 2-6 s.  The device works 1-3 and,
    on a timeline shifted 2 s early, 5-6, launched at 0.99 and 6.99: on
    the host's clock the gaps are 0-0.99 (unnamed), 2.99-6.99 (mid in the
    span) and 7.99-10 (unnamed), so 3 of 7 idle seconds are unnamed."""
    scripted(monkeypatch, [0.0, 2.0, 6.0, 10.0])
    with trace.recording() as rec:
        with trace.request("predict"):
            with trace.span("predict.contract"):
                pass
    rec.offset_s = 0.0
    ctx = profiled_ctx(rec, [("k", 1.0, 3.0), ("k", 5.0, 6.0)],
                       [0.99, 6.99])
    assert spans.idle_unattributed_percent(ctx) == pytest.approx(
        100.0 * 3 / 7)


def test_host_time_per_call_leaves_the_copy_back_out(monkeypatch):
    """Two calls of 0-4 s and 5-6 s, the first with a copy back of 1-3 s
    holding a span of 1.5-2 s: the first call's host time is its self time
    (4 - 2) and the inner span's (0.5), the second's 1 s."""
    scripted(monkeypatch, [0.0, 1.0, 1.5, 2.0, 3.0, 4.0, 5.0, 6.0])
    with trace.recording() as rec:
        with trace.request("predict"):
            with trace.span("predict.d2h"):
                with trace.span("x"):
                    pass
        with trace.request("predict"):
            pass
    ctx = SimpleNamespace(session=SimpleNamespace(_spans_recorded=rec))
    assert spans.host_ms_per_call(ctx) == pytest.approx(1e3 * (2 + 0.5 + 1)
                                                       / 2)
    assert spans.ms_per_call(ctx, "predict.d2h") == pytest.approx(1e3)


def test_no_span_is_a_profiler_record():
    """The spans open no profiler range: a recorded training (and the
    prediction inside it) under ``torch.profiler`` leaves no record, host or
    device, by a span's name.  On the card, ``tests/test_torch_cuda.py``
    holds the device records of a recorded training to an unrecorded one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from benchmark.kinds import train

    session = train.Session(tiny.cell("ethanol-n31k.train"), tiny.SEED,
                            tiny.CPU)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.recording() as rec:
            session.traced()
    names = {s.name for s in rec.spans}
    assert {"train", "cg", "cg.chunk", "predict.contract"} <= names
    events = list(prof.profiler.kineto_results.events())
    tr = devtrace.Trace(
        window_s=1.0,
        device=[(e.name(), 0, 0) for e in events
                if e.device_type() == DeviceType.CUDA],
        host=[(e.name(), 0, 0) for e in events
              if e.device_type() != DeviceType.CUDA])
    assert tr.host and not {n for n, _, _ in tr.host + tr.device} & names
