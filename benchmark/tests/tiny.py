"""Cells of the benchmark cut to a size a CPU test holds: the training
cells at a few training points and a small preconditioner, the prediction
cells at small calls and a small pool.  Everything else, the widths
included, is the cell's own.

A cell held back from ``BENCHMARK.json`` keeps its files (traffic,
limits, readers), and ``held_back.json`` keeps the manifest entries that
bring it back as they were: ``manifest()`` adds them, so its files stay
rehearsed here."""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import torch

from benchmark import harness

CPU = torch.device("cpu")
SEED = 2**31 + 17

HELD_BACK = harness.load_json(Path(__file__).with_name("held_back.json"))
HELD_CELLS = [w["name"] for w in HELD_BACK["workloads"]]


def manifest() -> dict:
    """``BENCHMARK.json`` with the held-back cells' entries added."""
    m = harness.load_json(harness.MANIFEST)
    return {k: v + HELD_BACK.get(k, []) if isinstance(v, list) else v
            for k, v in m.items()}


def cell(name: str) -> harness.Cell:
    c = harness.find_cell(name, manifest())
    cfg = dict(c.config, n_train=16 if c.config["n_atoms"] < 12 else 6,
               n_columns=96)
    mix = dict(c.mix)
    if mix["kind"] == "predict":
        g = min(int(mix["geoms_per_call"]), 16)
        mix.update(geoms_per_call=g, pool=8 * g, warmup_calls=1,
                   keep=min(int(mix["keep"]), 1000))
    return dataclasses.replace(c, config=cfg, mix=mix)


def run(c: harness.Cell, seconds: float = 0.3, seed: int = SEED,
        trace: bool = False) -> dict:
    """One run of the cut cell on the CPU, through the harness's own
    ``run_cell`` (the command itself refuses a CPU)."""
    return harness.run_cell(c, seed, seconds, trace, CPU,
                            time.perf_counter())
