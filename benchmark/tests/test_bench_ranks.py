"""Cells on more than one card, rehearsed on the CPU: rank 0 of a cut
training cell runs in a process of its own (``group_rank0``) and starts
its followers (``group_follower``) through the harness's own
``ranks.run_cell``, four ranks in one gloo group.

The cut cell is ethanol at N = 16 with k = 384 of n = 432 columns, five
CG iterations.  Each iteration of this lambda = 1e-10 system multiplies
the rounding by which four ranks and one part: at the cut cell's k = 96
(264 iterations) their models part by 9.5e-5 and end 7 iterations
apart, at k = 300 (33 iterations) by 1.3e-6; at k = 384 by 6e-12, where
``chip_smoke.py``'s 1e-6 separates a sound sharded training from one
that is not."""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness, ranks
from benchmark.kinds import predict, train
from benchmark.tests import group_follower, tiny

CELL = "ethanol-n31k.train"
K = 384
WORLD = 4
SHARDED_ALPHA_RTOL = 1e-6      # chip_smoke.py's


def cut(name=CELL):
    c = tiny.cell(name)
    return dataclasses.replace(c, config=dict(c.config, n_columns=K))


def rank0(tmp_path, seconds=0.3, trace=0, env=None, timeout=240):
    """Rank 0's process: (completed process, its JSON or None, seconds)."""
    out = tmp_path / "rank0.json"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.tests.group_rank0", CELL,
         str(WORLD), str(tiny.SEED), str(seconds), str(trace), str(K),
         str(out)],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, TMPDIR=str(tmp_path), **(env or {})))
    took = time.perf_counter() - t0
    got = json.loads(out.read_text()) if out.exists() else None
    return proc, got, took


def left_behind(tmp_path) -> list:
    """Processes whose command line names the run's temporary directory
    (the followers name their group's)."""
    found = []
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            cmd = (d / "cmdline").read_bytes().replace(b"\0", b" ").decode()
        except OSError:
            continue
        if str(tmp_path) in cmd:
            found.append((int(d.name), cmd))
    return found


def wait_gone(tmp_path, seconds=20.0) -> list:
    deadline = time.perf_counter() + seconds
    while left_behind(tmp_path) and time.perf_counter() < deadline:
        time.sleep(0.2)
    return left_behind(tmp_path)


def test_four_ranks_match_one_rank(tmp_path):
    proc, got, _ = rank0(tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout == ""
    out = got["out"]
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert got["found"] == []
    assert out["device"]["count"] == WORLD
    by_rank = out["device"]["memory_peak_bytes_by_rank"]
    assert by_rank == list(group_follower.PEAKS)
    assert out["device"]["memory_peak_bytes"] == max(by_rank)
    assert set(out["metrics"]) == {m["name"] for m in cut().end_to_end}
    assert list(out)[-1] == "checks"
    assert not left_behind(tmp_path)

    one = train.Session(cut(), tiny.SEED, tiny.CPU).request(0)
    a1 = one["model"]["alphas_F"]
    iters = one["spans"]["solver_iters"]
    for a, it in zip(got["alphas_F"], got["iters"]):
        err = np.abs(np.asarray(a) - a1).max() / np.abs(a1).max()
        assert err <= SHARDED_ALPHA_RTOL
        assert abs(it - iters) <= max(2, 0.01 * iters)


def test_four_ranks_traced(tmp_path):
    """With trace the ranks stay in step through each traced training the
    readers run, and report what one rank reports."""
    proc, got, _ = rank0(tmp_path, trace=1)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = got["out"]
    assert out["correct"] is True, out["checks"]
    one = tiny.run(cut(), trace=True)
    assert set(out["metrics"]) == set(one["metrics"])
    assert not left_behind(tmp_path)


def test_a_follower_s_faults_reach_rank0(tmp_path):
    """A follower whose trainings do not converge fails each request; one
    that loaded JAX is named to rank 0, which refuses the run."""
    proc, got, _ = rank0(tmp_path, env={"GROUP_TEST_FAULTS": "3"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = got["out"]
    assert out["correct"] is False
    assert out["failed"] == out["attempted"] >= 1
    assert got["found"] == ["jax"]


def test_follower_killed_mid_window_fails_the_run(tmp_path):
    proc, got, took = rank0(tmp_path, seconds=60,
                            env={"GROUP_TEST_KILL": "2:1"})
    assert proc.returncode == ranks.FOLLOWER_LOST, proc.stderr[-3000:]
    assert proc.stdout == "" and got is None
    assert "rank 2 ended" in proc.stderr
    assert took < ranks.GROUP_TIMEOUT_S
    assert not wait_gone(tmp_path, seconds=0.0)


def test_followers_die_with_rank0(tmp_path):
    """Rank 0 killed by SIGKILL mid-window: no follower outlives it."""
    proc, got, _ = rank0(tmp_path, seconds=60,
                         env={"GROUP_TEST_KILL": "0:1"})
    assert proc.returncode == -signal.SIGKILL
    assert got is None
    assert not wait_gone(tmp_path)


def children() -> set:
    pid = os.getpid()
    out = set()
    for task in Path(f"/proc/{pid}/task").iterdir():
        out |= set((task / "children").read_text().split())
    return out


def test_one_card_cell_forms_no_group(monkeypatch):
    import torch.distributed as dist

    def refused(*args, **kwargs):
        raise AssertionError("a one-card cell started a group")

    monkeypatch.setattr(ranks, "Group", refused)
    monkeypatch.setattr(ranks, "join", refused)
    before = children()
    out = tiny.run(tiny.cell(CELL))
    assert out["correct"] is True
    assert out["device"]["count"] == 1
    assert "memory_peak_bytes_by_rank" not in out["device"]
    assert not dist.is_initialized()
    assert children() <= before


def test_predict_kind_refuses_a_mesh():
    with pytest.raises(ValueError, match="no mesh"):
        predict.Session(tiny.cell("aspirin-n15k.predict"), tiny.SEED,
                        torch.device("cpu"), mesh=object())
