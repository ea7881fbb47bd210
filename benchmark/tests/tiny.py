"""Cells of the benchmark cut to a size a CPU test holds: the training
cells at a few training points and a small preconditioner, the prediction
cells at small calls and a small pool.  Everything else, the widths
included, is the cell's own."""

from __future__ import annotations

import dataclasses
import time

import torch

from benchmark import harness

CPU = torch.device("cpu")
SEED = 2**31 + 17


def cell(name: str) -> harness.Cell:
    c = harness.find_cell(name)
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
