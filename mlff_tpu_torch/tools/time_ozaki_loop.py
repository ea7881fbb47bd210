"""The Ozaki matvec alone, chained in a Python loop and inside the PCG
loop, with its launches per call, on one card; and its digit products per
pair against one product per weight class.

    python3 -m mlff_tpu_torch.tools.time_ozaki_loop [--device cpu]

The port's counterpart of the root ``tools/profile_ozaki_loop.py``.  The
root asked why the Ozaki matvec took ~24x longer inside XLA's compiled CG
loop than alone, a loop-compilation effect that eager PyTorch does not
have.  The port's question is launch overhead: each matvec queues many
small digit products and conversions, and the launch count answers it.  On
the bench operator (calibrated ethanol, N_TRAIN = 1166, P = 6, sigma = 10,
n = 31,482):

    raw          one ``matvec_psd_ozaki`` and one ``matvec_psd``: ms per
                 call (CUDA events), launches per call and busy share
                 (``device_profile``)
    python_loop  N_CH = 25 calls chained (c <- A c / ||c||), ms per call
    pcg_run      a chunk of 25 iterations of ``PCGSolver._run`` (no
                 preconditioner) on each matvec: ms per iteration, busy
                 share, launches per iteration
    digit_gemm   the third product A_exp1 @ wt from its digits: per digit
                 pair (``ozaki.gemm_presliced``, the engine's form) against
                 one segment-exact product per weight class of the pairs'
                 digits concatenated along the contraction (``grouped``):
                 ms and launches of each, and their relative difference

Times, shares and launches are null on the CPU; the difference is computed
everywhere.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .. import resolve_device
from ..utils.timing import device_profile
from . import benchlib as bl

N_TRAIN, N_CH = 1166, 25


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    bl.add_device_argument(p)
    return p


def gemm_grouped(A_sl, B_sl, s: int | None = None) -> torch.Tensor:
    """``ozaki.gemm_presliced`` with the digit pairs of each weight class w
    as one product: [a_0 .. a_w] (n, (w+1) K) x [b_w; ..; b_0] ((w+1) K, m),
    padded to 256-deep segments, each segment's sum exact in f32.  Low
    classes accumulate in f32 as there."""
    from ..ops import ozaki

    sA, dA = A_sl
    sB, dB = B_sl
    if s is None:
        s = min(len(dA), len(dB))
    w_f64 = ozaki._w_f64(s)
    acc = acc32 = None
    for w in range(s):
        a = torch.cat([ozaki._f32(d) for d in dA[:w + 1]], dim=1)
        b = torch.cat([ozaki._f32(dB[w - i]) for i in range(w + 1)], dim=0)
        depth = a.shape[1]
        n_seg = -(-depth // ozaki._SEG)
        if n_seg > 1:
            a = ozaki._pad_K(a, 1, n_seg * ozaki._SEG)
            b = ozaki._pad_K(b, 0, n_seg * ozaki._SEG)
        low = w >= w_f64
        part = ozaki._seg_matmul(a, b, n_seg,
                                 torch.float32 if low else torch.float64)
        if low:
            term = part * (ozaki._RADIX ** -(w - w_f64))
            acc32 = term if acc32 is None else acc32 + term
        else:
            term = part * (ozaki._RADIX ** -(w + 2))
            acc = term if acc is None else acc + term
    if acc32 is not None:
        acc = acc + acc32.to(torch.float64) * (ozaki._RADIX ** -(w_f64 + 2))
    return sA * acc * sB


def profiled(dev, fn, per: int = 1, reps: int = 3) -> dict:
    """Launches per call (over ``per``) and busy share of ``fn``, profiled
    over ``reps`` calls."""
    prof = device_profile(torch, fn, warmup=1, reps=reps, device=dev)
    return {"launches": (None if prof["launches"] is None
                         else prof["launches"] / per),
            "busy_share": prof["busy_share"]}


def run(dev, n_train: int = N_TRAIN) -> list:
    from ..models.gdml import Trainer
    from ..ops import kernel as knl
    from ..ops import ozaki
    from ..solvers.cg import PCGSolver

    task, _ = bl.benchmark_task("ethanol", n_train)
    _, cache = bl.rebuild_cache(Trainer(device=dev), task)
    state = knl.ozaki_matvec_state(cache)
    v = torch.as_tensor(np.random.default_rng(0).normal(size=cache.n),
                        device=dev)
    fns = {"ozaki": lambda u: knl.matvec_psd_ozaki(state, u),
           "f64": lambda u: knl.matvec_psd(cache, u)}
    name = bl.device_name(dev)
    lines = []

    def emit(line):
        line = dict(line, n=cache.n, device=name)
        lines.append(line)
        print(json.dumps(line), flush=True)

    for engine, fn in fns.items():
        prof = profiled(dev, lambda fn=fn: fn(v))
        emit({"case": "raw", "engine": engine,
              "ms": bl.event_ms(dev, lambda fn=fn: fn(v), reps=10),
              "launches_per_call": prof["launches"],
              "busy_share": prof["busy_share"]})

        def chain(fn=fn):
            c = v
            for _ in range(N_CH):
                c = fn(c) / torch.linalg.norm(c)
            return c

        ms = bl.event_ms(dev, chain, reps=1, warmup=1)
        emit({"case": "python_loop", "engine": engine, "calls": N_CH,
              "ms_per_call": None if ms is None else ms / N_CH,
              "launches_per_call": profiled(dev, chain, N_CH, 1)["launches"]})
        runner = bl.chunk_runner(PCGSolver(fn, None, chunk=N_CH), v, N_CH)
        ms = bl.event_ms(dev, runner, reps=1, warmup=1)
        prof = profiled(dev, runner, N_CH, 1)
        emit({"case": "pcg_run", "engine": engine, "iters": N_CH,
              "ms_per_iter": None if ms is None else ms / N_CH,
              "launches_per_iter": prof["launches"],
              "busy_share": prof["busy_share"]})

    wt, _ = knl._ozaki_cotangents(cache, v)
    wt_sl = ozaki.slice_digits(wt, axis=0)
    gemms = {"per_pair": lambda: ozaki.gemm_presliced(state.Ae1_sl, wt_sl),
             "grouped": lambda: gemm_grouped(state.Ae1_sl, wt_sl)}
    ref, got = gemms["per_pair"](), gemms["grouped"]()
    emit({"case": "digit_gemm", "shape": [*cache.A_exp1.shape,
                                          int(wt.shape[1])],
          "rel_diff": float((got - ref).abs().max() / ref.abs().max()),
          **{f"{k}_ms": bl.event_ms(dev, f, reps=10)
             for k, f in gemms.items()},
          **{f"{k}_launches": profiled(dev, f)["launches"]
             for k, f in gemms.items()}})
    return lines


def main(argv=None, n_train: int = N_TRAIN) -> list:
    """``n_train``: a test's smaller system (the tool's size is N_TRAIN)."""
    args = parser().parse_args(argv)
    return run(resolve_device(args.device), n_train)


if __name__ == "__main__":
    main()
    sys.exit(0)
