"""The Woodbury apply's two skinny passes over the (n, m) factor B, written
several ways and timed in turns on one card.

    python3 -m mlff_tpu_torch.tools.time_woodbury_apply [--n 75006]
        [--m 3840] [--device cpu]

The port's counterpart of the root ``tools/profile_woodbury_apply.py``.
B is random (f64, N(0, 1 / n), made on the device from seed 0), v (n,) and
x (m,) likewise.  The variants, the root's letters kept:

    a  reduce_axis0       (B * v[:, None]).sum(0)         B^T v, broadcast
    b  reduce_axis1       (B * x[None, :]).sum(1)         B x, broadcast
    c  gemv_t             B.T @ v                         B^T v, cuBLAS DGEMV
    d  gemv               B @ x                           B x, cuBLAS DGEMV
    e  reduce_axis1_Bt    (Bt * v[None, :]).sum(1)        B^T v on Bt = B^T
    f  gemv_Bt            Bt @ v                          B^T v, contiguous Bt
    g  split_apply        woodbury_split_apply (2 GEMVs over B, 2 over W2)
    h  reduce_axis0_f32   (a) on f32 B and v
    i  gemv_f32           B32 @ x32
    j  gemv_t_f32         v32 @ B32
    k  df64_bt_v          the df64 kernel on B's (hi, lo) f32 pair
    l  df64_b_x           the df64 kernel, B x
    m  df64_apply         df64_woodbury_apply (k, l, and the third word)

All of them in turns (``utils/timing.py::time_in_turns``: median ms of 10
calls between two CUDA events, 3 rounds forward and back, and the spread),
GB/s of B's bytes each reads (8 n m for the f64 and df64 forms, 4 n m for
f32), and each product's error relative to max |ref| against the cuBLAS f64
product of the same operands (the applies against the f64 split apply).
One JSON line per variant; on the CPU the times are null and the errors are
computed (the df64 wrappers run their plain versions there).
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from .. import require_full_f32, resolve_device
from . import benchlib as bl

ROUNDS, REPS = 3, 10


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=75006)
    p.add_argument("--m", type=int, default=3840)
    bl.add_device_argument(p)
    return p


def operands(n: int, m: int, dev, seed: int = 0) -> dict:
    """B (n, m) ~ N(0, 1/n), v (n,), x (m,), W2 (m, m) ~ N(0, 1/m^2), f64,
    made on ``dev`` from ``seed``."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64,
                           device=dev)

    return {"B": randn(n, m) / math.sqrt(n), "v": randn(n), "x": randn(m),
            "W2": randn(m, m) / m}


def variants(ops: dict) -> dict:
    """{name: (callable, bytes of B it reads, reference name)}."""
    from ..ops import df64
    from ..ops import df64_gemv as dg
    from ..solvers import preconditioners as pc

    B, v, x = ops["B"], ops["v"], ops["x"]
    n, m = B.shape
    Bt = B.T.contiguous()
    B32, v32, x32 = B.float(), v.float(), x.float()
    require_full_f32(B32)
    Bh, Bl = df64.split_f64(B)
    P = pc.WoodburySplitPreconditioner(B=B, W2=ops["W2"], lam=1e-10,
                                       info={})
    P64 = pc.DF64WoodburyPreconditioner(
        Bh=Bh, Bl=Bl, W2=ops["W2"], lam=1e-10,
        Bm=(B - Bh.double() - Bl.double()).float())
    f64, f32 = 8 * n * m, 4 * n * m
    return {
        "a_reduce_axis0": (lambda: (B * v[:, None]).sum(0), f64, "bt_v"),
        "b_reduce_axis1": (lambda: (B * x[None, :]).sum(1), f64, "b_x"),
        "c_gemv_t": (lambda: B.T @ v, f64, "bt_v"),
        "d_gemv": (lambda: B @ x, f64, "b_x"),
        "e_reduce_axis1_Bt": (lambda: (Bt * v[None, :]).sum(1), f64, "bt_v"),
        "f_gemv_Bt": (lambda: Bt @ v, f64, "bt_v"),
        "g_split_apply": (lambda: pc.woodbury_split_apply(P, v), f64,
                          "apply"),
        "h_reduce_axis0_f32": (lambda: (B32 * v32[:, None]).sum(0), f32,
                               "bt_v"),
        "i_gemv_f32": (lambda: B32 @ x32, f32, "b_x"),
        "j_gemv_t_f32": (lambda: v32 @ B32, f32, "bt_v"),
        "k_df64_bt_v": (lambda: dg.df64_bt_v(Bh, Bl, v), f64, "bt_v"),
        "l_df64_b_x": (lambda: dg.df64_b_x(Bh, Bl, x), f64, "b_x"),
        "m_df64_apply": (lambda: pc.df64_woodbury_apply(P64, v), f64 + f32,
                         "apply"),
    }


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / max |ref| (the root tools' measure)."""
    return float((got.double() - ref).abs().max() / ref.abs().max())


def run(args, dev) -> list:
    from ..utils.timing import time_in_turns

    ops = operands(args.n, args.m, dev)
    fns = variants(ops)
    # the references: the f64 cuBLAS products and the f64 split apply
    refs = {ref: fns[key][0]() for ref, key in (
        ("bt_v", "c_gemv_t"), ("b_x", "d_gemv"), ("apply", "g_split_apply"))}
    times = (time_in_turns(torch, {k: f for k, (f, _, _) in fns.items()},
                           rounds=ROUNDS, reps=REPS)
             if dev.type == "cuda" else {})
    name = bl.device_name(dev)
    lines = []
    for key, (fn, nbytes, ref) in fns.items():
        ms, spread = times.get(key, (None, None))
        line = {"variant": key, "n": args.n, "m": args.m,
                "B_gb": 8 * args.n * args.m / 1e9, "ms": ms,
                "ms_spread": spread,
                "gb_per_s": None if ms is None else nbytes / ms / 1e6,
                "rel_err_vs_f64": rel_err(fn(), refs[ref]), "device": name}
        lines.append(line)
        print(json.dumps(line), flush=True)
    return lines


def main(argv=None) -> list:
    args = parser().parse_args(argv)
    return run(args, resolve_device(args.device))


if __name__ == "__main__":
    main()
    sys.exit(0)
