"""The pieces of one on-the-fly (OTF) matvec tile at the n = 503,982
shapes, each timed on its own on one card.

    python3 -m mlff_tpu_torch.tools.time_otf_parts [--t 128] [--m 111996]
        [--d 36] [--reps 3] [--device cpu]

The port's counterpart of the root ``tools/probe_otf_parts.py``.  Random
operands at the tile's shapes: X, Y (t, M) f64, A (t, D), Bd (D, M),
Bm (M, D), from seed 0 on the device.  The root's pieces, for the Ozaki
OTF matvec at 7 digits (``ops/ozaki.py``):

    exp64       exp(-Y), f64 over the tile
    sqrt64      sqrt(Y)
    mul64       X * Y
    slice7      slice_digits(X, axis=1, s=7)
    gemmD       the exact-slice (t, D) x (D, M) product (the distance Gram)
    gemmD_f64   the same product in f64 (cuBLAS)
    gemmM       the exact-slice (t, M) x (M, D) product, X sliced each call
    horner64    the 28 digit-pair partials of gemmD, weighted and summed in
                f64: the accumulation alone

Then the pieces of the OTF route's plain tile loop,
``ops/kernel.py::_desc_forces_otf_tiles`` (what a CPU or f32 cache runs; an
f64 cache on the card takes the fused kernel instead), at the tile
``_otf_tile`` picks for N = M / 6 training points (256 rows at
n = 503,982):

    otf_dist     pairwise_dist_gram of the tile against the (M, D) side
    otf_weights  pair_weights: A_exp = c exp(-dist), A_exp1 = A_exp (1 + dist)
    otf_dot      Xq_t wt^T - ct
    otf_G        A_exp * dot
    otf_F1       Xq_t rowsum(G) - G Xqt
    otf_F2       A_exp1 wt
    otf_tile     the whole tile: dist, weights and desc_forces

Each piece in turns (``time_in_turns``, ``--reps`` rounds of one call):
ms and GB/s of one (tile, M) f64 array.  The last line, ``otf_matvec``:
the tile count of one matvec and ``otf_tile`` ms times it, the tiles'
share of a matvec.  Times are null on the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from .. import resolve_device
from . import benchlib as bl

P_ETHANOL = 6      # M = N * P at the 504k shapes
S_DIGITS = 7


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--t", type=int, default=128)
    p.add_argument("--m", type=int, default=111996)
    p.add_argument("--d", type=int, default=36)
    p.add_argument("--reps", type=int, default=3)
    bl.add_device_argument(p)
    return p


def _randn(g, *shape, dev):
    return torch.randn(shape, generator=g, dtype=torch.float64, device=dev)


def ozaki_pieces(t: int, M: int, D: int, dev) -> dict:
    """{piece: (callable, rows of its (rows, M) tile)} of the root's probe."""
    from ..ops import ozaki

    g = torch.Generator(device=dev).manual_seed(0)
    X = _randn(g, t, M, dev=dev)
    Y = _randn(g, t, M, dev=dev) + 2.0
    A = _randn(g, t, D, dev=dev)
    Bd = _randn(g, D, M, dev=dev)
    Bm = _randn(g, M, D, dev=dev)
    s = S_DIGITS
    A_sl = ozaki.slice_digits(A, axis=1, s=s)
    Bd_sl = ozaki.slice_digits(Bd, axis=0, s=s)
    Bm_sl = ozaki.slice_digits(Bm, axis=0, s=s)
    a32 = [ozaki._f32(d) for d in A_sl[1]]
    b32 = [ozaki._f32(d) for d in Bd_sl[1]]
    partials = [(i + j, a32[i] @ b32[j]) for i in range(s)
                for j in range(s - i)]

    def horner():
        acc = torch.zeros((t, M), dtype=torch.float64, device=dev)
        for w, p in partials:
            acc += p.double() * (256.0 ** -(w + 2))
        return A_sl[0] * acc * Bd_sl[0]

    return {
        "exp64": (lambda: torch.exp(-Y), t),
        "sqrt64": (lambda: torch.sqrt(Y), t),
        "mul64": (lambda: X * Y, t),
        "slice7": (lambda: ozaki.slice_digits(X, axis=1, s=s), t),
        "gemmD": (lambda: ozaki.gemm_presliced(A_sl, Bd_sl), t),
        "gemmD_f64": (lambda: A @ Bd, t),
        "gemmM": (lambda: ozaki.gemm_presliced(
            ozaki.slice_digits(X, axis=1, s=s), Bm_sl), t),
        "horner64": (horner, t),
    }


def otf_pieces(tile: int, M: int, D: int, dev, sig: float = 10.0) -> dict:
    """{piece: (callable, tile)} of the f64 OTF matvec's tile."""
    from ..ops import kernel as knl

    g = torch.Generator(device=dev).manual_seed(1)
    q = knl.SQRT5 / sig
    Xq_t = q * _randn(g, tile, D, dev=dev)
    Xqt = q * _randn(g, M, D, dev=dev)
    wt = _randn(g, M, D, dev=dev)
    dist = knl.pairwise_dist_gram(Xq_t, Xqt)
    A_exp, A_exp1 = knl.pair_weights(dist, sig)
    ct = torch.sum(Xqt * wt, dim=-1)
    dot = Xq_t @ wt.T - ct[None, :]
    G = A_exp * dot

    def whole():
        a, a1 = knl.pair_weights(knl.pairwise_dist_gram(Xq_t, Xqt), sig)
        return knl.desc_forces(Xqt, sig, Xq_t, a, a1, wt, energies=False)[0]

    return {
        "otf_dist": (lambda: knl.pairwise_dist_gram(Xq_t, Xqt), tile),
        "otf_weights": (lambda: knl.pair_weights(dist, sig), tile),
        "otf_dot": (lambda: Xq_t @ wt.T - torch.sum(Xqt * wt, dim=-1)[None],
                    tile),
        "otf_G": (lambda: A_exp * dot, tile),
        "otf_F1": (lambda: Xq_t * torch.sum(G, dim=1, keepdim=True)
                   - G @ Xqt, tile),
        "otf_F2": (lambda: A_exp1 @ wt, tile),
        "otf_tile": (whole, tile),
    }


def run(args, dev) -> list:
    from ..ops import kernel as knl
    from ..utils.timing import time_in_turns

    M, D = args.m, args.d
    N = M // P_ETHANOL
    tile = knl._otf_tile(N, M)
    name = bl.device_name(dev)
    lines = []

    def emit(line):
        line = dict(line, M=M, D=D, device=name)
        lines.append(line)
        print(json.dumps(line), flush=True)

    ms_of = {}
    for make in (lambda: ozaki_pieces(args.t, M, D, dev),
                 lambda: otf_pieces(tile, M, D, dev)):
        pieces = make()
        times = (time_in_turns(torch, {k: f for k, (f, _) in pieces.items()},
                               rounds=args.reps, reps=1)
                 if dev.type == "cuda" else {})
        for key, (fn, rows) in pieces.items():
            fn()
            ms = times.get(key, (None,))[0]
            ms_of[key] = ms
            emit({"piece": key, "t": rows, "ms": ms,
                  "gb_per_s": (None if ms is None
                               else rows * M * 8 / ms / 1e6)})
    tiles = math.ceil(N / tile)
    emit({"piece": "otf_matvec", "n": 27 * N, "N": N, "tile": tile,
          "tiles": tiles,
          "tiles_ms": (None if ms_of["otf_tile"] is None
                       else ms_of["otf_tile"] * tiles)})
    return lines


def main(argv=None) -> list:
    args = parser().parse_args(argv)
    return run(args, resolve_device(args.device))


if __name__ == "__main__":
    main()
    sys.exit(0)
