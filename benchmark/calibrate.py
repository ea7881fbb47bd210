"""The readings that the limits of ``correct`` are set from, on the card at
a cell's own size: the program's compared numbers over many seeds (the
lower readings) and its control's (the upper readings).

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 2] [--out FILE]

Each seed gets the cell's own set-up and a window of ``--seconds`` (at
least one request), judged as a run judges it.  The controls, one step of
precision below the f64 the configurations state:

  * ``train``: the program's own f32 path, ``matvec_dtype="float32"``
    (the kernel operator in f32 on an f32 copy of the cache), capped at
    three times the most iterations a program seed took, for ``resid``;
    and for ``desc_err`` and ``w_err``, which that path leaves in f64, the
    reference's descriptors and cotangents computed in f32 in place of the
    program's;
  * ``predict``: the reference run in f32 (TF32 off) in the program's
    place, its answers to every call of the pool judged against the f64
    reference.

Prints one JSON line per reading (and writes them to ``--out``).  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from types import SimpleNamespace

import numpy as np


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def program_reading(cell, seed: int, seconds: float, device) -> dict:
    from . import harness
    import importlib

    kind = importlib.import_module(f"benchmark.kinds.{cell.mix['kind']}")
    t0 = time.perf_counter()
    session = kind.Session(cell, seed, device)
    records, window_s = harness.window(session, seconds)
    session.release()
    checks = session.check(records)
    row = {"role": "program", "seed": seed, "checks": checks,
           "requests": len(records), "failed": sum(not r["ok"]
                                                   for r in records),
           "seconds": time.perf_counter() - t0}
    if records and "spans" in records[0]:
        row["iters"] = [r["spans"]["solver_iters"] for r in records]
    return row


def train_control(cell, seed: int, cap: int, device) -> dict:
    """The program's f32 solve, its stored descriptors and cotangents
    replaced by the reference's computed in f32."""
    import torch

    from . import reference
    from .kinds import train

    class Control(train.Session):
        def task(self):
            t = super().task()
            t.update(matvec_dtype="float32", solver_maxiter=cap)
            return t

    session = Control(cell, seed, device)
    rec = session.request(0)
    session.release()
    R = session.ds["R"]
    aF = np.asarray(rec["model"]["alphas_F"]).reshape(R.shape)
    rec["model"]["R_desc"], rec["model"]["R_d_desc_alpha"] = (
        reference.model_arrays(R, aF, device, torch.float32))
    checks = session.check([rec])
    return {"role": "control", "seed": seed, "checks": checks,
            "converged": rec["ok"], "iters": rec["spans"]["solver_iters"]}


def predict_control(cell, seed: int, device) -> dict:
    import torch

    from . import data, reference
    from .kinds import predict

    mix, cfg = cell.mix, cell.config
    ds, R_pool = data.dataset(cfg, seed, n_extra=int(mix["pool"]))
    s = SimpleNamespace(cfg=cfg, mix=mix, g=int(mix["geoms_per_call"]),
                        R_train=ds["R"], a=data.coefficients(cfg, seed),
                        R_pool=R_pool)
    m32 = reference.Model(s.R_train, s.a, cfg["perms"], cfg["sigma"],
                          std=mix["model_std"], c=mix["model_c"],
                          device=device, dtype=torch.float32)
    E, F = m32.predict(R_pool)
    kept = [(i, E[i * s.g:(i + 1) * s.g], F[i * s.g:(i + 1) * s.g])
            for i in range(R_pool.shape[0] // s.g)]
    return {"role": "control", "seed": seed,
            "checks": predict.judge(s, kept, device)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    from . import harness

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.find_cell(args.workload)
    device = torch.device("cuda", 0)
    rows = []

    def emit(row):
        row["workload"] = cell.name
        rows.append(row)
        print(json.dumps(row), flush=True)

    for seed in _seeds(args.seeds):
        emit(program_reading(cell, seed, args.seconds, device))
    for seed in _seeds(args.control_seeds):
        if cell.mix["kind"] == "train":
            most = max(max(r["iters"]) for r in rows if r["role"] == "program")
            emit(train_control(cell, seed, 3 * int(most), device))
        else:
            emit(predict_control(cell, seed, device))
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    for role in ("program", "control"):
        vals = [r["checks"] for r in rows if r["role"] == role]
        if vals:
            worst = {k: max(v[k] for v in vals) for k in vals[0]}
            least = {k: min(v[k] for v in vals) for k in vals[0]}
            print(f"{role}: largest {worst} smallest {least}",
                  file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
