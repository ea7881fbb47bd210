"""Check and time the df64 GEMV kernels on one CUDA card.

    python3 -m mlff_tpu_torch.tools.time_df64_gemv [--check-only]
        [--variant NAME=SOURCE.cu ...]

Builds ``csrc/df64_gemv.cu`` (printing what ptxas reports), runs both passes
at the shapes below against the plain PyTorch versions and the f64 cuBLAS
product (tolerance 3e-12 relative), checks that ``df64_bt_v`` gives the same
bits twice, and then times each pass in turns with the cuBLAS f64 GEMV on
the same B at the two large shapes (median and spread, byte bound, share).

``--variant`` names further sources with the same C interface
(``mlff_df64_bt_v``, ``mlff_df64_b_x``): each is built with the same flags,
checked against the f64 product and timed in the same turns, so that two
designs are compared within one run on one card.  Results go to stdout as
JSON lines, the card's name and power limit last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from ..ops import cuda_build
from ..ops import df64
from ..ops import df64_gemv as dg
from ..utils.timing import time_in_turns

F32_PEAK, MEM_RATE = 67e12, 3.35e12   # NVIDIA H100 SXM data sheet
RTOL = 3e-12
SHAPES = (("main", 31482, 1536), ("profiled", 75006, 3840),
          ("ragged", 1001, 130), ("ragged_slabs", 4099, 1030),
          ("narrow", 257, 4), ("one", 1, 1), ("wide", 5, 29056),
          ("odd_rows", 4099, 1024))
TIMED = ("main", "profiled")


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def build_variant(name: str, source: str) -> ctypes.CDLL:
    """Compile ``source`` with the package's nvcc flags and load it."""
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = cuda_build.BUILD_DIR / f"variant-{name}.so"
    proc = subprocess.run(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out), source],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}"
                           f"{proc.stderr}")
    emit(variant=name, ptxas=ptxas_lines(proc.stdout + proc.stderr))
    return dg._bind(ctypes.CDLL(str(out)))


def ptxas_lines(report: str) -> list:
    return [ln.strip() for ln in report.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln]


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=SOURCE.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_df64_gemv: no CUDA device")

    reports = cuda_build.build(["df64_gemv"])
    emit(build="df64_gemv", ptxas=ptxas_lines(reports.get("df64_gemv", "")))
    libs = {"kernel": dg._library()}
    for spec in args.variant:
        name, _, source = spec.partition("=")
        libs[name] = build_variant(name, source)

    gen = torch.Generator(device="cuda").manual_seed(2)
    failed = False
    for label, n, m in SHAPES:
        B64 = torch.randn((n, m), generator=gen, dtype=torch.float64,
                          device="cuda") / n**0.5
        Bh, Bl = df64.split_f64(B64)
        emit(shape=label, plan=str(dg.plan(n, m, dg._sm_count(0))))
        for name, length, launch, library in (
                ("df64_bt_v", n, dg._launch_bt_v, lambda v: B64.T @ v),
                ("df64_b_x", m, dg._launch_b_x, lambda x: B64 @ x)):
            vec = torch.randn(length, generator=gen, dtype=torch.float64,
                              device="cuda")
            want = library(vec)
            row = {"name": name, "shape": label, "n": n, "m": m}
            for lib_name, lib in libs.items():
                got = launch(lib, Bh, Bl, vec)
                torch.cuda.synchronize()
                row[f"{lib_name}_rel_err_vs_f64"] = rel_err(got, want)
                ok = row[f"{lib_name}_rel_err_vs_f64"] <= RTOL
                if lib_name == "kernel":
                    if label != "profiled":
                        plain = getattr(dg, name + "_ref")(Bh, Bl, vec)
                        row["rel_err_vs_plain"] = rel_err(got, plain)
                        ok = ok and row["rel_err_vs_plain"] <= RTOL
                        del plain
                    again = launch(lib, Bh, Bl, vec)
                    row["same_bits_twice"] = bool(torch.equal(got, again))
                    ok = ok and row["same_bits_twice"]
                failed = failed or not ok
            if label in TIMED and not args.check_only:
                fns = {"library": lambda: library(vec)}
                for lib_name, lib in libs.items():
                    fns[lib_name] = (lambda lib=lib:
                                     launch(lib, Bh, Bl, vec))
                bound_s, bound_by = dg.bound_seconds(n, m, F32_PEAK, MEM_RATE)
                row["bound_ms"], row["bound_by"] = bound_s * 1e3, bound_by
                for fn_name, (ms, spread) in time_in_turns(torch, fns).items():
                    row[f"{fn_name}_ms"] = ms
                    row[f"{fn_name}_ms_spread"] = spread
                for lib_name in libs:
                    row[f"{lib_name}_vs_library"] = (row[f"{lib_name}_ms"]
                                                     / row["library_ms"])
                    row[f"{lib_name}_share_of_bound"] = (
                        row["bound_ms"] / row[f"{lib_name}_ms"])
            emit(**row)
        del B64, Bh, Bl
        torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    if failed:
        sys.exit("time_df64_gemv: a kernel disagrees with its reference")


if __name__ == "__main__":
    main()
