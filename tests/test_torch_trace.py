"""The port's tracer (``mlff_tpu_torch.utils.trace``): the off path reads
the clock only where a reported field needs it, spans nest under one
request, self time, and the spans of a small training and a batched
prediction.  CPU only; no JAX.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mlff_tpu_torch.data.synthetic import make_benchmark_dataset  # noqa: E402
from mlff_tpu_torch.models.gdml import Trainer  # noqa: E402
from mlff_tpu_torch.models.predict import Predictor  # noqa: E402
from mlff_tpu_torch.models.task import create_task  # noqa: E402
from mlff_tpu_torch.utils import trace  # noqa: E402

from .torch_threads import one_torch_thread  # noqa: F401,E402

TRAIN = dict(n_columns=200, str_preconditioner="lev_random")
BATCH_SPANS = ("predict.h2d", "predict.descriptors", "predict.contract",
               "predict.backproject", "predict.d2h")
# the fields that hold seconds: they differ from run to run
TIMES = ("cache_build_s", "total_time_preconditioner",
         "total_time_cholesky", "total_time_cg", "total_time_solve",
         "finalize_s")


@pytest.fixture(scope="module")
def task():
    ds, perms = make_benchmark_dataset("ethanol", n_samples=90, seed=11,
                                       n_train=30)
    return create_task(ds, 30, ds, n_valid=50, sig=10.0, solver="cg",
                       perms=perms)


@pytest.fixture(scope="module")
def recorded(task):
    """A warm training recorded, and its model."""
    tr = Trainer(device="cpu")
    tr.train(task, **TRAIN)
    with trace.recording() as rec:
        model = tr.train(task, **TRAIN)
    return rec, model


class Clock:
    """``time.perf_counter`` counted."""

    def __init__(self, monkeypatch):
        self.calls, real = 0, time.perf_counter

        def counted():
            self.calls += 1
            return real()

        monkeypatch.setattr(time, "perf_counter", counted)


class Spans:
    """``trace.Span`` objects made, counted."""

    def __init__(self, monkeypatch):
        self.made, real = [], trace.Span

        def made(name, *args, **kwargs):
            self.made.append(name)
            return real(name, *args, **kwargs)

        monkeypatch.setattr(trace, "Span", made)


def test_off_path_reads_the_clock_only_for_reported_fields(
        task, recorded, monkeypatch):
    """Not recording, a training reads the clock as its fields' timers
    always have: 30 times outside the CG loop (the descriptors' log line,
    the cache, the solve, the preconditioner, the leverage scores' and the
    Nystrom build's stages, finalize) and once per chunk (the checkpoint
    timer), and makes a span object only at the six boundaries of reported
    seconds; a prediction reads no clock and makes no span."""
    rec, _ = recorded
    chunks = len(rec.named("cg.chunk"))
    tr = Trainer(device="cpu")
    clock, spans = Clock(monkeypatch), Spans(monkeypatch)
    model = tr.train(task, **TRAIN)
    assert clock.calls == 30 + chunks
    assert sorted(spans.made) == sorted(["train.descriptors", "train.cache",
                                         "solve", "precon", "cg",
                                         "train.finalize"])
    clock.calls, spans.made[:] = 0, []
    Predictor(model, device="cpu").predict(np.asarray(task["R_train"]))
    assert clock.calls == 0 and spans.made == []
    assert trace.span("cg.chunk") is trace.NULL
    assert trace.request("predict") is trace.NULL


def test_spans_nest_under_one_request_and_self_time(monkeypatch):
    """On a scripted clock: a request holding a span with a child and a
    second span; a request opened inside it is part of it.  Self time by
    hand: the root 10 - (3 + 2) = 5, ``a`` 3 - 1 = 2."""
    ticks = iter([0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 5.5, 6.5, 7.0, 10.0])
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    with trace.recording() as rec:
        with trace.request("r"):
            with trace.span("a"):
                with trace.span("a.b") as b:
                    b.set("n", 3)
            with trace.span("c"):
                with trace.request("inner"):
                    pass
    by = {s.name: s for s in rec.spans}
    root = by["r"]
    assert [s.request for s in rec.spans] == [root.id] * 5
    assert rec.roots() == [root]
    assert (by["a"].parent, by["a.b"].parent, by["c"].parent,
            by["inner"].parent) == (root.id, by["a"].id, root.id, by["c"].id)
    assert by["a.b"].attrs == {"n": 3}
    assert rec.self_seconds(root) == 10.0 - (3.0 + 2.0)
    assert rec.self_seconds(by["a"]) == 3.0 - 1.0
    assert rec.self_seconds(by["c"]) == 2.0 - 1.0
    assert rec.under(by["a.b"], "r") and not rec.under(by["c"], "a")


def test_stages_and_counters_while_recording(monkeypatch):
    """A stage chain reads the clock once on entry and once per mark, and
    each stage is a span that parents what opens inside it; a counter
    counts at all times, and a recording gives what it added."""
    ticks = iter([0.0, 1.0, 1.5, 2.0, 4.0])
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    trace.count("test.n", 2)
    with trace.recording() as rec:
        with trace.stages("s") as st:
            st.mark("one")
            with trace.span("inside"):
                pass
            st.mark("two")
        trace.count("test.n")
    assert st.seconds == {"one": 1.0, "two": 3.0}
    by = {s.name: s for s in rec.spans}
    assert set(by) == {"s.one", "s.two", "inside"}
    assert by["inside"].parent == by["s.two"].id
    assert rec.counted("test.n") == 1 and trace.counter("test.n") == 3
    trace.reset("test.n")
    assert trace.counter("test.n") == 0


def test_spans_of_other_threads_are_not_kept():
    with trace.recording() as rec:
        t = threading.Thread(target=lambda: trace.span("other").__enter__())
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        with trace.span("mine"):
            pass
        with pytest.raises(RuntimeError, match="open already"):
            with trace.recording():
                pass
    assert [s.name for s in rec.spans] == ["mine"]


def test_training_children_cover_the_training(recorded):
    """The children of ``train`` (descriptors, cache, solve, finalize)
    cover at least 95% of it."""
    rec, _ = recorded
    (root,) = rec.roots()
    assert root.name == "train"
    assert {c.name for c in rec.children(root)} == {
        "train.descriptors", "train.cache", "solve", "train.finalize"}
    assert rec.self_seconds(root) <= 0.05 * root.seconds


def test_chunk_iterations_sum_to_the_solver_iterations(recorded):
    rec, model = recorded
    chunks = rec.named("cg.chunk")
    assert len(rec.named("cg.read")) == len(chunks)
    assert sum(s.attrs["iters"] for s in chunks) == model["solver_iters"]
    assert sum(s.attrs["steps"] for s in chunks) >= model["solver_iters"]
    (cg,) = rec.named("cg")
    assert cg.attrs["iters"] == model["solver_iters"]
    assert cg.seconds == model["total_time_cg"]
    (stage,) = [s for s in rec.named("precon.nystrom.host_W1")
                if not rec.under(s, "precon.leverage")]
    assert rec.under(stage, "precon")


def test_a_batched_call_opens_each_batch_span_per_batch(task, recorded):
    """1100 geometries at batch_size 512: three batches."""
    _, model = recorded
    R_train = np.asarray(task["R_train"])
    R = np.resize(R_train, (1100,) + R_train.shape[1:])
    pred = Predictor(model, batch_size=512, device="cpu")
    with trace.recording() as rec:
        E, F = pred.predict(R)
    assert E.shape == (1100,) and F.shape == (1100, 9, 3)
    for name in BATCH_SPANS:
        assert len(rec.named(name)) == 3
    (root,) = rec.roots()
    assert root.name == "predict" and len(rec.named("predict.input")) == 1


def test_model_is_the_same_with_recording_on_and_off(task, recorded):
    """Keys, and every value but the seconds, bit for bit."""
    _, on = recorded
    off = Trainer(device="cpu").train(task, **TRAIN)
    assert list(on) == list(off)
    for k in on:
        if k in TIMES:
            continue
        a, b = on[k], off[k]
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), k
        elif isinstance(a, float) and np.isnan(a):
            assert np.isnan(b), k
        else:
            assert a == b or (a != a and b != b), k
