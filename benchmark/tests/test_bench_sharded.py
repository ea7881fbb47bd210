"""The four-card cell ``ethanol-n157k.train-sharded4``: its entries in the
manifest, the manifest's rules for it, its cut rehearsed on four gloo
ranks through the harness's own ``ranks.run_cell``, and the readers of
its collectives, on-the-fly matvec and sharded apply (their counts
against values worked by hand at the cell's shapes, their arithmetic on
hand-made recordings and timelines)."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import devtrace, harness, peaks, sharded_counts
from benchmark.tests import tiny
from benchmark.tests.test_bench_manifest import chips_errors
from mlff_tpu_torch.utils import trace

M = harness.load_json(harness.MANIFEST)
CELL = "ethanol-n157k.train-sharded4"
NEW_METRICS = ("train.collectives_per_iter",
               "train.collective_device_ms_per_iter",
               "train.otf_matvec_roofline", "train.sharded_cg_step_mfu",
               "train.sharded_apply_roofline")
# the accepted metrics the cell is listed on, as they read rank 0
LISTED_ON = ("train_s", "train.cache_build_s", "train.preconditioner_s",
             "train.cg_ms_per_iter", "train.cg_iters",
             "train.device_idle_share", "train.descriptors_s",
             "train.leverage_s", "train.nystrom_host_s",
             "train.cg_enqueue_ms_per_iter", "train.cg_read_ms_per_iter",
             "train.cg_device_ms_per_iter", "train.cg_launches_per_iter",
             "train.finalize_s", "train.idle_unattributed_share")
# the shapes of a configuration: a cut of scale may not change them
WIDTHS = ("z", "perms", "n_atoms", "descriptor_dim", "n_perms")
# N = 5832 over four ranks: 1458 rows each; M = 6 N; n = 27 N
SHAPES = dict(N=5832, M=34992, D=36, A=9, n=157464, k=2368)


def read(name, ctx):
    return harness.reader(name).read(ctx)


def test_the_cell_s_entries_come_last():
    """The cell's configuration, cell and new metrics are the last entries
    of their lists, and the cell is the last name on each accepted metric
    it joins; each new metric has its reader."""
    assert M["configs"][-1]["name"] == "ethanol-n157k"
    assert M["workloads"][-1]["name"] == CELL
    assert [x["name"] for x in M["per_layer"][-len(NEW_METRICS):]] == list(
        NEW_METRICS)
    metrics = {x["name"]: x for x in M["end_to_end"] + M["per_layer"]}
    assert {n for n, x in metrics.items() if CELL in x.get("workloads", ())
            } == set(LISTED_ON + NEW_METRICS)
    for name in LISTED_ON:
        assert metrics[name]["workloads"][-1] == CELL
    for name in NEW_METRICS:
        assert callable(harness.reader(name).read)
    assert harness.find_cell(CELL).chips == 4


def test_the_cell_keeps_the_four_card_rules():
    """A training on 4 cards, the one four-card cell a manifest of four
    cells has room for, of a configuration whose N (5832, cut from 5833 =
    19 x 307) divides over them; the cut and the keys it moves are the
    configuration's ``reduced``, none of them a width."""
    (w,) = [w for w in M["workloads"] if w["chips"] > 1]
    assert (w["name"], w["chips"], w["traffic"]) == (CELL, 4, "train")
    assert chips_errors(M) == []
    (config,) = [c for c in M["configs"] if c["name"] == w["config"]]
    c = harness.load_json(harness.ROOT / config["file"])
    assert c["n_train"] == 5832 and c["n_train"] % w["chips"] == 0
    assert (c["n"], c["n_train_perms"]) == (3 * 9 * 5832, 6 * 5832)
    assert config["reduced"] == ["n_train", "n", "n_train_perms"]
    assert not set(config["reduced"]) & set(WIDTHS)
    assert not any(k.endswith(("_dim", "_rank")) for k in config["reduced"])
    # its limits are the one-card ethanol training's
    assert harness.find_cell(CELL, M).limits == harness.find_cell(
        "ethanol-n31k.train").limits


def test_the_cell_s_metrics_in_the_manifest():
    """The new readers list this cell alone; the readers of the single-card
    operator and the CG graph's share (0 on a mesh, where the loop runs
    eagerly) leave it out; ``train_s`` lists it."""
    by_name = {m["name"]: m for m in M["per_layer"]}
    for name in NEW_METRICS:
        assert by_name[name]["workloads"] == [CELL]
    for name in ("train.matvec_roofline", "train.apply_roofline",
                 "train.cg_step_mfu", "train.cg_graph_share"):
        assert CELL not in by_name[name]["workloads"]
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert CELL in e2e["train_s"]["workloads"]
    cell = harness.find_cell(CELL, M)
    assert {m["name"] for m in cell.end_to_end} == {"train_s", "setup_s"}
    assert len(cell.per_layer) == len(LISTED_ON) - 1 + len(NEW_METRICS)


def test_the_cut_cell_traced_on_four_gloo_ranks(tmp_path):
    """The cell as the manifest gives it, cut (N = 16, k = 384 of
    n = 432 columns), on four gloo ranks with trace: correct; its
    collectives and its iteration's share of the peak read numbers, the
    device readers None off the card, and the CG graph's share, which
    the cell does not list, is not in the line."""
    out_path = tmp_path / "rank0.json"
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.tests.group_rank0", CELL, "4",
         str(tiny.SEED), "0.3", "1", "384", str(out_path)],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, TMPDIR=str(tmp_path)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(out_path.read_text())["out"]
    assert out["correct"] is True, out["checks"]
    assert out["device"]["count"] == 4
    got = {k: v["value"] for k, v in out["metrics"].items()}
    # the matvec's all-gather, the apply's B^T v and the dots and norm:
    # 5 an iteration, and the loop's own before and after it (12.6 over
    # the cut cell's 5 iterations; ~5.5 over the cell's ~820)
    assert got["train.collectives_per_iter"] >= 5.0
    assert 0.0 < got["train.sharded_cg_step_mfu"] <= 100.0
    assert "train.cg_graph_share" not in got
    for name in ("train.collective_device_ms_per_iter",
                 "train.otf_matvec_roofline", "train.sharded_apply_roofline"):
        assert name not in got


def test_otf_matvec_counts():
    # 8 r M D + 10 r M at r = 1458; 8 (r D + 2 M D + r D)
    assert sharded_counts.otf_matvec_ops(1458, 34992, 36) == 15_203_464_128
    assert sharded_counts.otf_matvec_bytes(1458, 34992, 36) == 20_995_200
    # compute-bound: 0.227 ms against 6.3 us of traffic
    assert sharded_counts.otf_matvec_seconds(1458, 34992, 36) == \
        15_203_464_128 / 67e12


def test_sharded_apply_counts():
    # a rank's rows of B: n / 4 = 39,366 of k = 2368; 4 r k operations,
    # 8 (r k + 2 r) bytes: memory-bound, 0.2228 ms against 5.6 us
    assert peaks.apply_ops(39366, 2368) == 372_874_752
    assert peaks.apply_bytes(39366, 2368) == 746_379_360
    assert peaks.apply_seconds(39366, 2368) == 746_379_360 / 3.35e12


def test_sharded_cg_iteration_ops():
    # 8 N M D + 10 N M (58,773,123,072 + 2,040,733,440), 4 n k
    # (1,491,499,008), 10 n (1,574,640)
    s = SHAPES
    assert sharded_counts.sharded_cg_iteration_ops(
        s["N"], s["M"], s["D"], s["n"], s["k"]) == 62_306_930_160


def scripted(monkeypatch, ticks):
    it = iter(ticks)
    monkeypatch.setattr(time, "perf_counter", lambda: next(it))


def recorded(monkeypatch):
    """A training (0-30 s on the host, offset 100 s to the profiler's
    clock) with a collective before its ``cg`` span (1-2 s), then ``cg``
    (3-29 s) of one chunk (3.5-28 s) of 2 iterations, each a collective
    (4-5, 11-12 s), a ``matvec.otf`` span (6-8, 13-15 s) and a
    ``precon.apply`` span (8.5-10.5, 15.5-17.5 s) holding a collective
    (9-9.5, 16-16.5 s)."""
    scripted(monkeypatch, [0.0, 1.0, 2.0, 3.0, 3.5,
                           4.0, 5.0, 6.0, 8.0, 8.5, 9.0, 9.5, 10.5,
                           11.0, 12.0, 13.0, 15.0, 15.5, 16.0, 16.5, 17.5,
                           28.0, 29.0, 30.0])
    with trace.recording() as rec:
        with trace.request("train"):
            with trace.span("mesh.collective"):
                pass
            with trace.span("cg") as cg:
                with trace.span("cg.chunk") as chunk:
                    for _ in range(2):
                        with trace.span("mesh.collective"):
                            pass
                        with trace.span("matvec.otf"):
                            pass
                        with trace.span("precon.apply"):
                            with trace.span("mesh.collective"):
                                pass
                chunk.set("steps", 2)
                chunk.set("iters", 2)
            cg.set("iters", 2)
    rec.offset_s = 100.0
    return rec


def test_collectives_per_iter_counts_those_inside_cg(monkeypatch):
    rec = recorded(monkeypatch)
    ctx = SimpleNamespace(session=SimpleNamespace(_spans_recorded=rec))
    # two bare and two in the applies, over 2 iterations
    assert read("train.collectives_per_iter", ctx) == 2.0


def profiled_ctx(rec, device, launched, chips=4):
    tr = devtrace.Trace(window_s=30.0, device=device)
    session = SimpleNamespace(_spans_profiled=(rec, tr, launched),
                              shapes=SHAPES)
    return SimpleNamespace(session=session, device=torch.device("cuda"),
                           cell=SimpleNamespace(chips=chips))


def test_device_readers_on_a_hand_made_timeline(monkeypatch):
    """Device records, each placed by its launch: an NCCL kernel launched
    in the collective before ``cg`` (left out); one in each bare
    collective inside it, 0.5 and 1.5 s on a device timeline shifted
    early; a copy launched in the first; c10d's range mirrored onto the
    device, linked to no launch (left out).  Two tile kernels launched in
    the first ``matvec.otf`` span (overlapping: 0.25 s of union) and one
    in the second (0.25 s); one record linked to no launch.  In each
    apply two GEMVs (0.5, then 0.3 s) around an all-reduce of 0.1 s
    launched in the collective inside it: the collectives' time, not the
    apply's."""
    rec = recorded(monkeypatch)
    device = [("ncclDevKernel_AllReduce", 101.0, 102.0),
              ("ncclDevKernel_AllGather", 103.0, 103.5),
              ("nccl:all_gather", 102.9, 103.6),
              ("Memcpy DtoD", 103.5, 103.75),
              ("gemm", 106.5, 106.65), ("exp", 106.6, 106.75),
              ("gemv", 107.0, 107.2),
              ("ncclDevKernel_AllReduce", 107.2, 107.3),
              ("gemv", 107.3, 107.6),
              ("ncclDevKernel_AllGather", 108.0, 109.5),
              ("gemm", 111.5, 111.75), ("gemm", 112.0, 112.1),
              ("gemv", 114.0, 114.1),
              ("ncclDevKernel_AllReduce", 114.1, 114.2),
              ("gemv", 114.2, 114.4)]
    launched = [101.5, 104.5, None, 104.9, 106.1, 106.2,
                108.6, 109.1, 109.8, 111.5, 113.1, None,
                115.6, 116.2, 117.0]
    ctx = profiled_ctx(rec, device, launched)
    # (0.75 + 0.1 + 1.5 + 0.1) s over 2 iterations
    assert read("train.collective_device_ms_per_iter", ctx) == \
        pytest.approx(1e3 * 2.45 / 2)
    per_call = (0.25 + 0.25) / 2
    want = sharded_counts.otf_matvec_seconds(1458, 34992, 36) / per_call
    assert read("train.otf_matvec_roofline", ctx) == pytest.approx(
        100.0 * want)
    per_apply = (0.5 + 0.3) / 2
    assert read("train.sharded_apply_roofline", ctx) == pytest.approx(
        100.0 * peaks.apply_seconds(39366, 2368) / per_apply)


def test_device_readers_find_nothing_to_read(monkeypatch):
    """Off the card, and for a program without the spans (the parent of
    the spans ``matvec.otf`` and ``precon.apply``; an unsharded
    training), they return None."""
    device_readers = ("train.collective_device_ms_per_iter",
                      "train.otf_matvec_roofline",
                      "train.sharded_apply_roofline")
    cpu = SimpleNamespace(session=SimpleNamespace(), device=torch.device(
        "cpu"))
    for name in device_readers:
        assert read(name, cpu) is None
    scripted(monkeypatch, [0.0, 1.0, 2.0, 3.0, 4.0, 5.0])
    with trace.recording() as rec:
        with trace.request("train"):
            with trace.span("cg") as cg:
                with trace.span("cg.chunk") as chunk:
                    pass
                chunk.set("iters", 5)
            cg.set("iters", 5)
    ctx = profiled_ctx(rec, [("gemm", 1.0, 2.0)], [1.5])
    for name in device_readers:
        assert read(name, ctx) is None
    plain = SimpleNamespace(session=SimpleNamespace(_spans_recorded=rec))
    assert read("train.collectives_per_iter", plain) is None


def test_sharded_cg_step_mfu():
    """The window's 2 trainings: 8.2 s of CG in 1640 iterations, 5 ms an
    iteration, over four cards' peak."""
    spans = [{"total_time_cg": 4.0, "solver_iters": 800.0},
             {"total_time_cg": 4.2, "solver_iters": 840.0}]
    ctx = harness.Context(
        cell=SimpleNamespace(chips=4), records=[{"spans": x} for x in spans],
        window_s=10.0, setup_s=20.0, session=SimpleNamespace(shapes=SHAPES),
        device=torch.device("cpu"))
    assert read("train.sharded_cg_step_mfu", ctx) == pytest.approx(
        100.0 * 62_306_930_160 / 5e-3 / (4 * peaks.F64_PEAK))
    # 4.65%: inside (0, 100]
    assert 4.6 < read("train.sharded_cg_step_mfu", ctx) < 4.7
