"""The reader of ``train.cg_graph_share``: rehearsed on the CPU in both
training cells, and its arithmetic on a hand-made recording."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.tests import tiny
from mlff_tpu_torch.utils import trace

M = harness.load_json(harness.MANIFEST)
TRAIN_CELLS = [w["name"] for w in M["workloads"]
               if w["name"].endswith(".train")]
READER = harness.reader("train.cg_graph_share")


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_cg_graph_share_rehearsed(name):
    """A traced training on the CPU replays no iteration: the share reads
    0 in both training cells, and the manifest lists exactly them."""
    (m,) = [m for m in M["per_layer"] if m["name"] == "train.cg_graph_share"]
    assert m["workloads"] == TRAIN_CELLS
    out = tiny.run(tiny.cell(name), trace=True)
    assert out["correct"] is True
    assert out["metrics"]["train.cg_graph_share"]["value"] == 0.0


def test_cg_graph_share_counts_replayed_iterations(monkeypatch):
    """The counter's change while recording over the ``cg`` spans'
    iterations: two solves of 10 and 5 iterations, 14 of them replayed,
    and a counted change before the recording left out.  A program
    without the counter gives None."""
    from mlff_tpu_torch.solvers import cg

    trace.count(cg.GRAPH_ITERS, 7)
    with trace.recording() as rec:
        with trace.request("train"):
            for iters, replayed in ((10, 9), (5, 5)):
                with trace.timed("cg") as s:
                    trace.count(cg.GRAPH_ITERS, replayed)
                s.set("iters", iters)
    ctx = SimpleNamespace(session=SimpleNamespace(_spans_recorded=rec))
    assert READER.read(ctx) == pytest.approx(14 / 15)
    monkeypatch.delattr(cg, "GRAPH_ITERS")
    assert READER.read(ctx) is None
