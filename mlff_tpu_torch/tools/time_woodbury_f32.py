"""f32 and f32-pair forms of the Woodbury apply's two passes over B on one
card: bandwidth and accuracy against the f64 oracle.

    python3 -m mlff_tpu_torch.tools.time_woodbury_f32 [--n 75006]
        [--m 3840] [--device cpu]

The port's counterpart of the root ``tools/profile_woodbury_f32.py``.  The
f32-pair scheme stores B = Bh + Bl with Bh = f32(B), Bl = f32(B - Bh); a
product B^T v expands to Bh^T vh + Bh^T vl + Bl^T vh (the ~2^-48 Bl vl term
dropped), three f32 GEMVs whose accuracy f32 accumulation over n limits.
B (n, m) ~ N(0, 1/n), v and x are random f64, made on the device from seed
0.  Every f32 product runs in full f32: ``require_full_f32`` raises if
TF32 is on (``resolve_device`` turns it off).

Cases (times by CUDA events in turns, ``utils/timing.py::time_in_turns``;
GB/s of the bytes each reads of B): read-sum of f64 B and of f32 Bh (the
read rate), the f64 broadcast-reduce forms and cuBLAS f64 GEMVs (the
baseline), plain f32 GEMVs and reduce forms, the three-GEMV f32-pair forms.
Accuracy: max |got - ref| / max |ref| against the f64 oracle B^T v, B x
(cuBLAS f64 on the same operands) for the f64, pair and plain f32 forms;
the pair forms' speed against the f64 reduce forms.  One JSON line per case
and one ``accuracy`` line; on the CPU the times are null.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .. import require_full_f32, resolve_device
from . import benchlib as bl
from .time_woodbury_apply import operands, rel_err

ROUNDS, REPS = 3, 8


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=75006)
    p.add_argument("--m", type=int, default=3840)
    bl.add_device_argument(p)
    return p


def split_pair(t: torch.Tensor) -> tuple:
    """f64 -> (hi, lo) f32 with t ~ hi + lo."""
    hi = t.float()
    return hi, (t - hi.double()).float()


def pair_bt_v(Bh: torch.Tensor, Bl: torch.Tensor, v: torch.Tensor):
    """B^T v from the f32 pair, three f32 GEMVs, returned as f64."""
    require_full_f32(Bh)
    vh, vl = split_pair(v)
    return (vh @ Bh + vl @ Bh + vh @ Bl).double()


def pair_b_x(Bh: torch.Tensor, Bl: torch.Tensor, x: torch.Tensor):
    """B x from the f32 pair, three f32 GEMVs, returned as f64."""
    require_full_f32(Bh)
    xh, xl = split_pair(x)
    return (Bh @ xh + Bh @ xl + Bl @ xh).double()


def accuracy(B: torch.Tensor, v: torch.Tensor, x: torch.Tensor) -> dict:
    """Relative errors of the f64 broadcast-reduce, f32-pair and plain f32
    forms of B^T v and B x against the f64 oracle."""
    Bh, Bl = split_pair(B)
    require_full_f32(Bh)
    u_ref, y_ref = B.T @ v, B @ x
    return {
        "bt_v_f64": rel_err((B * v[:, None]).sum(0), u_ref),
        "bt_v_pair": rel_err(pair_bt_v(Bh, Bl, v), u_ref),
        "bt_v_f32": rel_err(v.float() @ Bh, u_ref),
        "b_x_f64": rel_err((B * x[None, :]).sum(1), y_ref),
        "b_x_pair": rel_err(pair_b_x(Bh, Bl, x), y_ref),
        "b_x_f32": rel_err(Bh @ x.float(), y_ref),
    }


def cases(B: torch.Tensor, v: torch.Tensor, x: torch.Tensor) -> dict:
    """{case: (callable, bytes of B read)}."""
    Bh, Bl = split_pair(B)
    v32, x32 = v.float(), x.float()
    n, m = B.shape
    f64, f32 = 8 * n * m, 4 * n * m
    return {
        "read_sum_f64": (lambda: B.sum(), f64),
        "read_sum_f32": (lambda: Bh.sum(), f32),
        "f64_reduce_axis0": (lambda: (B * v[:, None]).sum(0), f64),
        "f64_reduce_axis1": (lambda: (B * x[None, :]).sum(1), f64),
        "f64_gemv_t": (lambda: B.T @ v, f64),
        "f64_gemv": (lambda: B @ x, f64),
        "f32_gemv_t": (lambda: v32 @ Bh, f32),
        "f32_gemv": (lambda: Bh @ x32, f32),
        "f32_reduce_axis0": (lambda: (Bh * v32[:, None]).sum(0), f32),
        "f32_reduce_axis1": (lambda: (Bh * x32[None, :]).sum(1), f32),
        "pair_bt_v": (lambda: pair_bt_v(Bh, Bl, v), 2 * f32),
        "pair_b_x": (lambda: pair_b_x(Bh, Bl, x), 2 * f32),
    }


def run(args, dev) -> list:
    from ..utils.timing import time_in_turns

    ops = operands(args.n, args.m, dev)
    B, v, x = ops["B"], ops["v"], ops["x"]
    del ops["W2"]
    fns = cases(B, v, x)
    times = (time_in_turns(torch, {k: f for k, (f, _) in fns.items()},
                           rounds=ROUNDS, reps=REPS)
             if dev.type == "cuda" else {})
    name = bl.device_name(dev)
    lines = []

    def emit(line):
        line = dict(line, n=args.n, m=args.m, device=name)
        lines.append(line)
        print(json.dumps(line), flush=True)

    for key, (_, nbytes) in fns.items():
        ms, spread = times.get(key, (None, None))
        emit({"case": key, "ms": ms, "ms_spread": spread,
              "gb_per_s": None if ms is None else nbytes / ms / 1e6})
    ms = {k: t[0] for k, t in times.items()}
    emit({"case": "accuracy", **accuracy(B, v, x),
          "speedup_axis0": (ms["f64_reduce_axis0"] / ms["pair_bt_v"]
                            if ms else None),
          "speedup_axis1": (ms["f64_reduce_axis1"] / ms["pair_b_x"]
                            if ms else None)})
    return lines


def main(argv=None) -> list:
    args = parser().parse_args(argv)
    return run(args, resolve_device(args.device))


if __name__ == "__main__":
    main()
    sys.exit(0)
