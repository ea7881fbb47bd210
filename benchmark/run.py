"""Run one cell of the benchmark once, on the card of the machine it starts
on, and print its result as the last line of standard output.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics with the device's busy and window seconds and a
breakdown.  Every run checks what its window produced against the plain
reference and prints each number compared beside its limit, as the last
lines of standard error and under ``checks`` at the end of the result.
``built_kernels`` in the result says whether the run built a kernel of the
program (the first run in a checkout builds the fused kernel into
``build/kernels``), so that such a run's ``setup_s`` can be set apart.
Host threads are the libraries' defaults, as a user of the port has them.

A cell on more than one card runs one process per card in one NCCL group
(``ranks.py``): this process is rank 0 on ``cuda:0`` and prints the one
result line, with ``count`` the cell's cards and ``memory_peak_bytes`` the
fullest card's (``memory_peak_bytes_by_rank`` beside it).

Exits non-zero, and prints no result, without a CUDA device or with fewer
than the cell asks for, when a module of JAX or of the JAX package has
been loaded (in any rank), and when a rank of a cell on more than one card
fails or ends early.  Build and kernel caches stay inside the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

def cache_dirs() -> None:
    """Every build and kernel cache a run may fill, at fixed paths inside
    the checkout (the port builds its own kernels into ``build/kernels``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / "benchmark" / sub)


def finite(x: float) -> float:
    """A number JSON can carry: a non-finite reading as the largest
    double (it fails every limit)."""
    return x if math.isfinite(x) else sys.float_info.max


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_dirs()

    from . import harness

    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3

    cell = harness.find_cell(args.workload)
    if cell.chips > 1:
        from . import ranks

        ranks.host_threads(cell.chips)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: the cell needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if cell.chips == 1:
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        out = harness.run_cell(cell, args.seed, args.seconds,
                               bool(args.trace), device, T_START)
        found = []
    else:
        out, found = ranks.run_cell(cell, args.seed, args.seconds,
                                    bool(args.trace), T_START)
    bad = sorted(set(harness.forbidden_modules()) | set(found))
    if bad:
        print(f"benchmark: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        v["value"] = finite(v["value"])
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
