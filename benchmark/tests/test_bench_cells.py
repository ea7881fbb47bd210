"""Each cell's window, metrics and check rehearsed on the CPU at a cut
size, through the harness's internal ``run_cell``; the metric readers'
arithmetic on hand-made windows; and the command's refusal of a CPU."""

from __future__ import annotations

import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import devtrace, harness, peaks
from benchmark.tests import tiny

CELLS = [w["name"] for w in harness.load_json(harness.MANIFEST)["workloads"]]
# and the held-back ones, whose files stay
REHEARSED = CELLS + tiny.HELD_CELLS


@pytest.mark.parametrize("name", REHEARSED)
def test_cell_rehearsal(name):
    c = tiny.cell(name)
    out = tiny.run(c)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in c.end_to_end}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(c.limits)
    assert out["built_kernels"] is False  # nothing is built on the CPU


def test_built_files_see_a_new_build(tmp_path, monkeypatch):
    """A file that set-up adds or rewrites under ``build`` marks the run."""
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    (tmp_path / "build" / "kernels").mkdir(parents=True)
    before = harness.built_files()
    (tmp_path / "build" / "kernels" / "k-0.so").write_bytes(b"x")
    assert harness.built_files() - before
    assert not harness.built_files() - harness.built_files()


@pytest.mark.parametrize("name", REHEARSED)
def test_cell_traced_rehearsal(name):
    """With trace on the CPU: the span and host metrics are read, every
    device metric is left out (no device number from a CPU run)."""
    c = tiny.cell(name)
    out = tiny.run(c, trace=True)
    assert out["correct"] is True
    device_metrics = {m["name"] for m in c.per_layer
                      if m["source"] == "device_trace"}
    assert not device_metrics & set(out["metrics"])
    assert "busy_s" not in out["device"] and "breakdown" not in out


def test_same_seed_same_inputs():
    from benchmark import data

    cfg = tiny.cell("ethanol-n31k.train").config
    a, pa = data.dataset(cfg, 2**31 + 5, n_extra=4)
    b, pb = data.dataset(cfg, 2**31 + 5, n_extra=4)
    c, pc = data.dataset(cfg, 7, n_extra=4)
    assert np.array_equal(a["R"], b["R"]) and np.array_equal(pa, pb)
    assert not np.array_equal(a["R"], c["R"])
    assert not np.array_equal(pa, pc)
    # one training set, each geometry moved rigidly by the seed: the same
    # pair distances and labels
    d = lambda R: R[:, :, None] - R[:, None]  # noqa: E731
    assert np.allclose(d(a["R"]), d(c["R"]), rtol=0, atol=1e-13)
    assert np.array_equal(a["F"], c["F"])


def test_frozen_generator_is_the_calibrated_task():
    """Without the seed's translations the training set is, bit for bit,
    the port's calibrated benchmark task (``make_benchmark_dataset`` and
    ``create_task``'s stratified draw)."""
    from mlff_tpu_torch.data.synthetic import make_benchmark_dataset
    from mlff_tpu_torch.models.task import create_task

    from benchmark import data

    for name, mol in (("ethanol-n31k.train", "ethanol"),
                      ("aspirin-n15k.train", "aspirin")):
        cfg = harness.find_cell(name).config
        cfg = dict(cfg, generator=dict(cfg["generator"], shift=0.0))
        ds, _ = data.dataset(cfg, 1)
        n = cfg["n_train"]
        ref, perms = make_benchmark_dataset(mol, n_samples=n + 60, seed=11,
                                            n_train=n)
        task = create_task(ref, n, ref, n_valid=50, sig=10.0, solver="cg",
                           perms=perms)
        assert np.array_equal(ds["R"], task["R_train"])
        assert np.array_equal(ds["F"], task["F_train"])
        assert np.array_equal(np.asarray(cfg["perms"]), perms)


def ctx(records, window_s=2.0, shapes=None, trace=None, mix=None):
    return harness.Context(
        cell=SimpleNamespace(mix=mix or {}), records=records,
        window_s=window_s, setup_s=3.5,
        session=SimpleNamespace(shapes=shapes or {}), device=torch.device("cpu"),
        trace=trace)


def read(name, c):
    return harness.reader(name).read(c)


def test_train_readers():
    spans = [{"cache_build_s": 0.1, "total_time_preconditioner": 0.3,
              "total_time_cg": 0.2, "solver_iters": 200.0,
              "finalize_s": 0.01},
             {"cache_build_s": 0.3, "total_time_preconditioner": 0.5,
              "total_time_cg": 0.4, "solver_iters": 200.0,
              "finalize_s": 0.01}]
    s = dict(N=1166, M=6996, D=36, A=9, n=31482, k=1536)
    c = ctx([{"spans": x} for x in spans], window_s=2.0, shapes=s)
    assert read("setup_s", c) == 3.5
    assert read("train_s", c) == 1.0
    assert read("train.cache_build_s", c) == pytest.approx(0.2)
    assert read("train.preconditioner_s", c) == pytest.approx(0.4)
    assert read("train.cg_ms_per_iter", c) == pytest.approx(1.5)
    assert read("train.cg_iters", c) == 200.0
    ops = peaks.cg_iteration_ops(1166, 6996, 36, 9, 1536)
    assert read("train.cg_step_mfu", c) == pytest.approx(
        100 * ops / 1.5e-3 / 67e12)
    assert read("train.device_idle_share", c) is None
    assert read("train.matvec_roofline", c) is None  # no card


def test_predict_readers():
    s = dict(N=250, M=1500, D=210, A=21, g=2048, batch=512)
    trace = devtrace.Trace(window_s=4.0, device=[
        ("void wide_weights<4>(double const*)", 0.0, 1.0),
        ("wide_forces", 1.0, 1.5), ("Memcpy DtoH", 2.0, 3.0)])
    c = ctx([{"n": 2048}] * 10, window_s=0.5, shapes=s, trace=trace,
            mix={"trace_calls": 3})
    assert read("predict_geoms_per_s", c) == pytest.approx(20480 / 0.5)
    per_call = 4 * peaks.fused_predict_ops(512, 1500, 210)
    assert read("predict.step_mfu", c) == pytest.approx(
        100 * per_call * 10 / 0.5 / 67e12)
    # 1.5 s of fused kernels over 3 calls of 4 batches
    assert read("predict.fused_roofline", c) == pytest.approx(
        100 * peaks.fused_predict_seconds(512, 1500, 210) / (1.5 / 12))
    assert read("predict.device_idle_share", c) == pytest.approx(
        100 * (1 - 2.5 / 4.0))
    c.trace = devtrace.Trace(window_s=1.0, device=[("gemm", 0.0, 0.5)])
    assert read("predict.fused_roofline", c) is None


def test_md_readers():
    lat = np.arange(1, 101) * 1e-4           # 0.1 ... 10 ms
    records = [{"t0": 0.0, "t1": x, "n": 1} for x in lat]
    trace = devtrace.Trace(window_s=1.0, device=[
        ("k1", 0.0, 0.1), ("k2", 0.2, 0.3), ("Memset (Device)", 0.4, 0.5),
        ("k3", 0.6, 0.7)])
    c = ctx(records, trace=trace, mix={"trace_calls": 2})
    assert read("md_call_p95_ms", c) == pytest.approx(
        1e3 * np.percentile(lat, 95))
    assert read("md.call_median_ms", c) == pytest.approx(5.05)
    assert read("md.launches_per_call", c) == 1.5
    assert read("md.device_idle_share", c) == pytest.approx(60.0)


def test_command_refuses_a_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is here: the command would run")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of the MD cell (a prediction per call) on the card:
    it ends correct, with every end-to-end metric."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import json

    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "ethanol-n31k.md", "--seed", "2147483700", "--seconds", "1",
         "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert set(res["metrics"]) == {"md_call_p95_ms", "setup_s"}
