"""The CG matvec's arithmetic engines against each other on the bench
operator, on one card.

    python3 -m mlff_tpu_torch.tools.time_ozaki_matvec [--n-train 1166]
        [--k 1536] [--iters 100] [--device cpu]

The port's counterpart of the root ``tools/profile_ozaki_matvec.py``.  The
bench operator: calibrated ethanol (``make_benchmark_dataset``, seed 11,
P = 6, sigma = 10, lam = 1e-10; n = 31,482 at the default), its kernel
cache rebuilt by the Trainer's rule.  Engines: ``float64`` (cuBLAS f64),
``ozaki`` (exact-slice digit products, ``ops/ozaki.py``), ``mixed``
(centred f32 products with f64 chunk sums) and ``f32`` (a downcast cache).

The first line: ``ozaki_slice_setup_s`` (``ozaki_matvec_state``, host clock
to a synchronized device), ``ozaki_vs_f64_rel`` (||y_ozaki - y_f64|| /
||y_f64|| of one matvec), and each engine's ms per matvec, timed in turns
(``time_in_turns``).  Then one line per engine of a PCG training capped at
``--iters`` iterations (``Trainer.train`` with ``matvec_dtype`` and
``solver_maxiter``, lev_random at k): iterations, CG and preconditioner
seconds, ms per iteration, the relative residual.  On the CPU the times
are null; the agreement and the iterations are computed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import resolve_device, synchronize
from . import benchlib as bl

ENGINES = ("float64", "ozaki")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n-train", type=int, default=1166)
    p.add_argument("--k", type=int, default=1536)
    p.add_argument("--iters", type=int, default=100)
    bl.add_device_argument(p)
    return p


def matvecs(cache) -> tuple[dict, float]:
    """({engine: v -> (K + lam I) v}, Ozaki slice setup seconds on the
    host's clock)."""
    from ..ops import kernel as knl

    synchronize(cache.device)
    t0 = time.perf_counter()
    state = knl.ozaki_matvec_state(cache)
    synchronize(cache.device)
    setup_s = time.perf_counter() - t0
    c32 = knl.downcast_cache(cache)
    return {"float64": lambda v: knl.matvec_psd(cache, v),
            "ozaki": lambda v: knl.matvec_psd_ozaki(state, v),
            "mixed": lambda v: knl.matvec_psd_mixed(cache, v),
            "f32": lambda v: knl.matvec_psd(c32, v)}, setup_s


def agreement(fns: dict, v: torch.Tensor) -> float:
    """||y_ozaki - y_f64|| / ||y_f64||."""
    y64, yoz = fns["float64"](v), fns["ozaki"](v)
    return float(torch.linalg.norm(yoz - y64) / torch.linalg.norm(y64))


def run(args, dev) -> list:
    from ..models.gdml import Trainer
    from ..utils.timing import time_in_turns

    task, _ = bl.benchmark_task("ethanol", args.n_train)
    trainer = Trainer(device=dev)
    _, cache = bl.rebuild_cache(trainer, task)
    fns, setup_s = matvecs(cache)
    v = torch.as_tensor(np.random.default_rng(0).normal(size=cache.n),
                        device=dev)
    name = bl.device_name(dev)
    times = (time_in_turns(torch, {k: (lambda f=f: f(v))
                                   for k, f in fns.items()}, rounds=3, reps=10)
             if dev.type == "cuda" else {})
    first = {"case": "matvec", "n": cache.n, "M": int(cache.Xqt.shape[0]),
             "ozaki_slice_setup_s": bl.on_card(dev, setup_s),
             "ozaki_vs_f64_rel": agreement(fns, v),
             **{f"matvec_{k}_ms": times.get(k, (None,))[0] for k in fns},
             "device": name}
    lines = [first]
    print(json.dumps(first), flush=True)
    for engine in ENGINES:
        t = dict(task, matvec_dtype=engine, solver_maxiter=args.iters)
        synchronize(dev)
        t0 = time.perf_counter()
        model = Trainer(device=dev).train(t, n_columns=args.k,
                                          str_preconditioner="lev_random")
        wall = time.perf_counter() - t0
        t_pre, t_cg, _ = bl.times(model)
        iters = int(model["solver_iters"])
        line = {"case": f"loop_{engine}", "iters": iters,
                "t_cg_s": bl.on_card(dev, t_cg),
                "ms_per_iter": bl.on_card(dev, 1e3 * t_cg / max(1, iters)),
                "resid": float(model.get("solver_resid", np.nan)),
                "t_pre_s": bl.on_card(dev, t_pre),
                "wall_s": bl.on_card(dev, wall), "device": name}
        lines.append(line)
        print(json.dumps(line), flush=True)
    return lines


def main(argv=None) -> list:
    args = parser().parse_args(argv)
    return run(args, resolve_device(args.device))


if __name__ == "__main__":
    main()
    sys.exit(0)
