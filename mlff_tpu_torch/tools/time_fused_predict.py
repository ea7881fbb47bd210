"""Check and time the fused prediction kernel on one CUDA card.

    python3 -m mlff_tpu_torch.tools.time_fused_predict [--check-only]
        [--variant NAME=SOURCE.cu ...] [--variant-with-dist NAME=SOURCE.cu ...]
        [--f64-rates]

Builds ``csrc/fused_predict.cu`` (printing what ptxas reports and, where
the toolkit's ``cuobjdump`` is found, how many f64 ``mma`` operations of
each shape the library holds), runs
``desc_forces_fused`` at the cases below against its plain PyTorch version
(atol 2e-5 * max|ref| + rtol 2e-4, the tolerance of ``chip_smoke.py``),
checks that it gives the same bits twice, and then times kernel and plain
version in turns (median and spread over the turns, operations bound,
share), and one call on the host's clock at the small batches.

The cases: calibrated ethanol (D = 36) with 1166 training geometries
(M = 6996) at B = 512 (``full``), B = 7 against a ragged M (``ragged``), the
first 512 training descriptors as queries (``self``: zero distances), B = 1
(``one``) and B = 60 (``held_out``); uracil (D = 66), toluene (D = 105) and
salicylic acid (D = 120) for the kernel's wider instantiations; and the
on-the-fly training matvec's call on one of four ranks at n = 157,464
(``otf``: 5832 training geometries, M = 34,992, the first 1458 permuted
training rows as queries), timed beside the plain tile loop that a CPU
cache runs (``tiles_ms``: ``ops/kernel.py::_desc_forces_otf_tiles``, its
rows in tiles of 768).

``--variant`` names further sources with the same C interface
(``mlff_fused_predict``, ``mlff_fused_predict_geometry``): each is built with
the same flags, planned with its own geometry, checked and timed in the same
turns, so that two designs are compared within one run on one card.

``--wide`` runs the kernel's wide route (D > 129) instead, at the shapes
``chip_smoke.py`` times (aspirin, catcher, the full row at D = 210 and
3828, the nanotube), each at B = 512 and B = 1: held to the plain version
within 1e-12 relative with the same bits twice, then timed in turns with
the plain version and the four dense products as ``torch.matmul`` and,
where the plan splits the tiles of pass 1's last wave over D, the same
call with them unsplit (``unsplit_ms``).
There ``--variant`` names sources with the wide route's C interface
(``mlff_fused_predict_wide``, ``mlff_fused_predict_wide_geometry``), each
planned with the tiles and resident blocks its library reports.
``--variant-with-dist`` does the same for a source with the first kernel's
interface, which took the (B, M) distances as an argument, 32-query tiles
and 64-row stages: its timed call includes the f64 Gram-trick distances and
the zeroed outputs, as its wrapper's did.  ``--f64-rates`` first measures
what the card's f64 units give (``tools/f64_rates.cu``): each f64
``mma.sync`` shape and DFMA alone, and the two mixed, in TFLOP/s with 8
warps on every SM.  Results go to stdout as JSON lines, the card's name and
power limit last.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from ..data.synthetic import MOLECULES, make_benchmark_dataset, make_dataset
from ..ops import cuda_build
from ..ops import descriptor as dsc
from ..ops import fused_predict as fp
from ..ops import kernel as knl
from ..utils.timing import host_ms_per_call, time_in_turns

F64_PEAK, MEM_RATE = 67e12, 3.35e12   # NVIDIA H100 SXM data sheet
ATOL_REL, RTOL = 2e-5, 2e-4
SIG = 10.0
# a call keeps the host for tens of microseconds, at B = 1 longer than the
# card: each timed turn of 10 calls starts behind a spin of this length
LEAD_MS = 2.0
# (label, molecule, training geometries, B, rows cut from M, queries taken
# from the training rows)
CASES = (("full", "ethanol", 1166, 512, 0, False),
         ("ragged", "ethanol", 1166, 7, 37, False),
         ("self", "ethanol", 1166, 512, 0, True),
         ("one", "ethanol", 1166, 1, 0, False),
         ("held_out", "ethanol", 1166, 60, 0, False),
         ("uracil", "uracil", 3000, 512, 5, False),
         ("toluene", "toluene", 600, 512, 5, False),
         ("salicylic", "salicylic", 3000, 512, 5, False),
         ("otf", "ethanol", 5832, 1458, 0, True))
TIMED = ("full", "one", "held_out", "uracil", "toluene", "salicylic", "otf")
HOST_TIMED = ("one", "held_out")


# the wide route: (label, (molecule, training geometries) or None for
# random operands, M, D), chip_smoke.py's WIDE_TIMED, each at these B
WIDE_CASES = (("aspirin", ("aspirin", 250), 1500, 210),
              ("catcher", ("catcher", 119), 119, 3828),
              ("full_210", ("aspirin", 1166), 6996, 210),
              ("full_3828", None, 6996, 3828),
              ("nanotube", ("nanotube", 14), 14, 68265))
WIDE_BATCHES = (512, 1)
WIDE_RTOL = 1e-12


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def operands(molecule: str, n_train: int, n_query: int, device):
    """(Xq_query (n_query, D), Xqt (M, D), wt (M, D)) on ``device``: q-scaled
    descriptors of seeded geometries of ``molecule`` (with its permutations
    where the benchmark data has them) and standard normal cotangents."""
    n = n_train + n_query
    if molecule in ("ethanol", "uracil", "toluene", "aspirin", "catcher",
                    "nanotube"):
        ds, perms = make_benchmark_dataset(molecule, n_samples=n, seed=11,
                                           n_train=n_train)
    else:
        ds = make_dataset(molecule, n_samples=n, seed=11)
        perms = np.arange(MOLECULES[molecule])[None, :]
    spec = dsc.make_spec(MOLECULES[molecule])
    P_idx = torch.as_tensor(dsc.desc_perms(perms), device=device)
    X, _ = dsc.descriptors_from_R(
        spec, torch.as_tensor(ds["R"], dtype=torch.float64, device=device))
    Xq = (knl.SQRT5 / SIG) * X
    Xqt = knl.permuted_descriptors(Xq[:n_train], P_idx).contiguous()
    w = torch.as_tensor(
        np.random.default_rng(1).normal(size=(n_train, spec.dim)),
        device=device)
    wt = knl.perm_expand_w(w, P_idx).contiguous()
    return Xq[n_train:].contiguous(), Xqt, wt


def random_operands(B: int, M: int, D: int, seed: int, device):
    """(Xq (B, D), Xqt (M, D), wt (M, D)), seeded: descriptors in
    [0.05, 0.15), standard normal cotangents."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def uniform(*shape):
        return 0.05 + 0.1 * torch.rand(shape, generator=gen,
                                       dtype=torch.float64, device=device)

    return uniform(B, D), uniform(M, D), torch.randn(
        (M, D), generator=gen, dtype=torch.float64, device=device)


def wide(lib, variants: dict, n_sm: int, check_only: bool) -> bool:
    """The wide route of ``lib`` and of each variant library at WIDE_CASES:
    checked, then timed in turns.  Returns whether all
    agreed with the plain version and with themselves."""
    dev = torch.device("cuda", torch.cuda.current_device())
    calls = {"kernel": (lib, fp.WIDE), **variants}
    failed = False
    for label, source, M, D in WIDE_CASES:
        if source is None:
            Xq_all, Xqt, wt = random_operands(max(WIDE_BATCHES), M, D, 7, dev)
        else:
            Xq_all, Xqt, wt = operands(*source, max(WIDE_BATCHES), dev)
        for B in WIDE_BATCHES:
            ops = (Xq_all[:B].contiguous(), Xqt, wt)
            p = fp.plan(B, M, D, n_sm)
            fns = {name: (lambda v=v, q=fp.wide_plan(B, M, D, n_sm, geo):
                          fp._launch_wide(v, *ops, SIG, q))
                   for name, (v, geo) in calls.items()}
            if p.n_whole > 0 and p.n_tail > 0:
                # the same call with the last wave's tiles not split
                whole = dataclasses.replace(
                    p, n_whole=p.n_qtiles * p.n_mtiles, n_ksplit=1,
                    cols_per_slice=-(-D // p.geometry.depth)
                    * p.geometry.depth)
                fns["unsplit"] = lambda: fp._launch_wide(lib, *ops, SIG,
                                                         whole)
            want = fp.desc_forces_fused_ref(*ops, SIG)
            row = {"case": label, "B": B, "M": M, "D": D,
                   "n_whole": p.n_whole, "n_tail": p.n_tail,
                   "n_ksplit": p.n_ksplit, "n_split": p.n_split}
            for name, fn in fns.items():
                got, again = fn(), fn()
                torch.cuda.synchronize()
                errs = [float((g - w).abs().max() / w.abs().max())
                        for g, w in zip(got, want)]
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                row[f"{name}_rel_err"] = max(errs)
                row[f"{name}_same_bits_twice"] = same
                failed = failed or max(errs) > WIDE_RTOL or not same
            if not check_only:
                gen = torch.Generator(device=dev).manual_seed(3)
                G, a1 = (torch.rand((B, M), generator=gen,
                                    dtype=torch.float64, device=dev)
                         for _ in range(2))
                turns = time_in_turns(torch, {
                    "plain": lambda: fp.desc_forces_fused_ref(*ops, SIG),
                    "products": lambda: (ops[0] @ wt.T, ops[0] @ Xqt.T,
                                         G @ Xqt, a1 @ wt),
                    **fns}, lead_ms=LEAD_MS)
                bound_s, row["bound_by"] = fp.bound_seconds(
                    B, M, D, F64_PEAK, MEM_RATE)
                row["bound_ms"] = bound_s * 1e3
                for name, (ms, spread) in turns.items():
                    row[f"{name}_ms"], row[f"{name}_ms_spread"] = ms, spread
                for name in fns:
                    row[f"{name}_share_of_bound"] = (row["bound_ms"]
                                                     / row[f"{name}_ms"])
                del G, a1
            emit(**row)
        del Xq_all, Xqt, wt
        torch.cuda.empty_cache()
    return not failed


def errors(got, want) -> dict:
    """Largest error of (F, E) against the plain version, relative to the
    largest reference value, and whether every value is inside
    atol 2e-5 * max|ref| + rtol 2e-4."""
    out, ok = {}, True
    for name, g, w in (("F", got[0], want[0]), ("E", got[1], want[1])):
        scale = float(w.abs().max())
        err = (g - w).abs()
        out[f"rel_err_{name}"] = float(err.max()) / scale
        ok = ok and bool(torch.isfinite(g).all()
                         and (err <= ATOL_REL * scale + RTOL * w.abs()).all())
    out["ok"] = ok
    return out


def otf_tiles(Xq, Xqt, wt) -> torch.Tensor:
    """The on-the-fly matvec's plain tile loop over the queries ``Xq`` as
    a cache's rows: its (B, D) descriptor forces."""
    cache = knl.KernelCache(X=Xq, Jc=None, S=None, P_idx=None, Xq=Xq,
                            Xqt=Xqt, A_exp=None, A_exp1=None, sig=SIG,
                            lam=0.0)
    return knl._desc_forces_otf_tiles(cache, wt)


def variant_plan(lib, B: int, M: int, D: int, n_sm: int) -> fp.Plan:
    """The plan of a variant, from the geometry its library reports."""
    queries, threads, _, resident = fp.library_geometry(lib, D)
    width = fp.geometry_for(D).width
    return fp.plan_for(fp.Geometry(width, queries, threads, resident),
                       B, M, n_sm)


def bind_with_dist(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.mlff_fused_predict.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
        + [ctypes.c_double, ctypes.c_double, ctypes.c_void_p])
    lib.mlff_fused_predict.restype = ctypes.c_int
    return lib


def call_with_dist(lib, Xq, Xqt, wt, n_sm: int):
    """One call of a source with the first kernel's interface, as its
    wrapper made it: distances by the Gram trick, zeroed outputs, slabs of
    64-row stages for 32-query tiles at 2 blocks per SM."""
    (B, D), M, dev = Xq.shape, Xqt.shape[0], Xq.device
    f_out = torch.zeros((B, D), dtype=torch.float64, device=dev)
    e_out = torch.zeros((B,), dtype=torch.float64, device=dev)
    dist = knl.pairwise_dist_gram(Xq, Xqt)
    n_stages = -(-M // 64)
    n_split = max(1, min(n_stages, 2 * n_sm // -(-B // 32)))
    rows = -(-n_stages // n_split) * 64
    n_split = -(-M // rows)
    f_part = torch.empty((n_split, B, D), dtype=torch.float64, device=dev)
    e_part = torch.empty((n_split, B), dtype=torch.float64, device=dev)
    err = lib.mlff_fused_predict(
        Xq.data_ptr(), Xqt.data_ptr(), wt.data_ptr(), dist.data_ptr(),
        f_part.data_ptr(), e_part.data_ptr(), f_out.data_ptr(),
        e_out.data_ptr(), B, M, D, n_split, rows, 5.0 / (3.0 * SIG**2),
        knl.SQRT5 / SIG, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"variant launch failed: CUDA error {err}")
    return f_out, e_out


def dmma_counts(library: Path) -> dict | None:
    """{SASS opcode: count} of the DMMA operations in a built library, or
    None where there is no cuobjdump."""
    cuobjdump = Path(cuda_build._nvcc()).with_name("cuobjdump")
    if not cuobjdump.exists():
        return None
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    return dict(Counter(re.findall(r"\bDMMA\.\w+", sass)))


def f64_rates(n_sm: int) -> None:
    """Emit the TFLOP/s of each mode of tools/f64_rates.cu, 8 warps on each
    SM: flop per step = 2 m n k of the mma, 2 * 32 * 8 of the 8 DFMAs."""
    lib, _ = cuda_build.build_variant(
        "f64_rates", str(Path(__file__).with_name("f64_rates.cu")))
    lib.mlff_f64_rate.argtypes = [ctypes.c_int, ctypes.c_void_p] \
        + [ctypes.c_int] * 3
    lib.mlff_f64_rate.restype = ctypes.c_float
    scratch = torch.zeros(1, dtype=torch.float64, device="cuda")
    warps, iters = 8, 2000
    modes = (("m8n8k4", 512), ("m16n8k4", 1024), ("m16n8k8", 2048),
             ("m16n8k16", 4096), ("dfma_x8", 512),
             ("m16n8k4_and_dfma_x8", 1536))
    for mode, (name, flop) in enumerate(modes):
        ms = lib.mlff_f64_rate(mode, scratch.data_ptr(), n_sm, warps, iters)
        if ms <= 0:
            sys.exit(f"time_fused_predict: f64 rate kernel {name} failed")
        emit(f64_rate=name, ms=ms, warps_per_sm=warps,
             tflops=n_sm * warps * iters * 8 * flop / ms / 1e9)


def print_card() -> None:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=SOURCE.cu")
    ap.add_argument("--variant-with-dist", action="append", default=[],
                    metavar="NAME=SOURCE.cu")
    ap.add_argument("--f64-rates", action="store_true")
    ap.add_argument("--wide", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_fused_predict: no CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    if args.f64_rates:
        f64_rates(n_sm)
    reports = cuda_build.build(["fused_predict"])
    emit(build="fused_predict",
         ptxas=cuda_build.ptxas_lines(reports.get("fused_predict", "")),
         sass=dmma_counts(cuda_build.library_path("fused_predict")))
    lib = fp._library()
    emit(geometry={g.width: fp.library_geometry(lib, g.width)
                   for g in fp.GEOMETRIES},
         wide_geometry=fp.library_wide_geometry(lib),
         resources=cuda_build.kernel_resources(
             reports.get("fused_predict", "")))
    if args.wide:
        variants = {}
        for spec in args.variant:
            name, _, source = spec.partition("=")
            vlib, report = cuda_build.build_variant(name, source)
            vlib = fp._bind(vlib)
            geo = fp.library_wide_geometry(vlib)
            emit(variant=name, wide_geometry=geo,
                 resources=cuda_build.kernel_resources(report))
            variants[name] = (vlib, fp.WideGeometry(
                queries=geo[0], tile=geo[1], depth=geo[2], stages=geo[3],
                cols=geo[4], rows=geo[5], threads=geo[7],
                combine_queries=geo[12], blocks_per_sm=min(geo[10:12])))
        ok = wide(lib, variants, n_sm, args.check_only)
        print_card()
        if not ok:
            sys.exit("time_fused_predict: the wide route disagrees with its "
                     "plain version or with itself")
        return
    # name -> callable (Xq, Xqt, wt) -> (F, E)
    calls = {"kernel": lambda *a: fp._launch(
        lib, *a, SIG, fp.plan(a[0].shape[0], a[1].shape[0], a[0].shape[1],
                              n_sm))}
    for spec in args.variant:
        name, _, source = spec.partition("=")
        vlib, report = cuda_build.build_variant(name, source)
        emit(variant=name, ptxas=cuda_build.ptxas_lines(report))
        vlib = fp._bind(vlib)
        calls[name] = lambda *a, vlib=vlib: fp._launch(
            vlib, *a, SIG, variant_plan(vlib, a[0].shape[0], a[1].shape[0],
                                        a[0].shape[1], n_sm))
    for spec in args.variant_with_dist:
        name, _, source = spec.partition("=")
        vlib, report = cuda_build.build_variant(name, source)
        emit(variant=name, ptxas=cuda_build.ptxas_lines(report))
        vlib = bind_with_dist(vlib)
        calls[name] = lambda *a, vlib=vlib: call_with_dist(vlib, *a, n_sm)

    failed = False
    made = {}
    for label, molecule, n_train, B, cut, from_rows in CASES:
        key = (molecule, n_train)
        if key not in made:
            made.clear()     # one molecule's operands on the card at a time
            made[key] = operands(molecule, n_train, 512, dev)
        Xq_all, Xqt, wt = made[key]
        Mr = Xqt.shape[0] - cut
        Xq = (Xqt[:B] if from_rows else Xq_all[:B]).contiguous()
        ops = (Xq, Xqt[:Mr].contiguous(), wt[:Mr].contiguous())
        D = Xq.shape[1]
        want = fp.desc_forces_fused_ref(*ops, SIG)
        row = {"case": label, "B": B, "M": Mr, "D": D,
               "plan": str(fp.plan(B, Mr, D, n_sm))}
        for name, call in calls.items():
            got = call(*ops)
            torch.cuda.synchronize()
            res = errors(got, want)
            failed = failed or not res.pop("ok")
            row.update({f"{name}_{k}": v for k, v in res.items()})
            if name == "kernel":
                again = call(*ops)
                row["same_bits_twice"] = bool(
                    torch.equal(got[0], again[0])
                    and torch.equal(got[1], again[1]))
                failed = failed or not row["same_bits_twice"]
        if label in TIMED and not args.check_only:
            fns = {"plain": lambda: fp.desc_forces_fused_ref(*ops, SIG)}
            if label == "otf":
                fns["tiles"] = lambda: otf_tiles(*ops)
                row["tiles_rel_err_F"] = errors(
                    (otf_tiles(*ops), want[1]), want)["rel_err_F"]
            for name, call in calls.items():
                fns[name] = lambda call=call: call(*ops)
            bound_s, bound_by = fp.bound_seconds(B, Mr, D, F64_PEAK, MEM_RATE)
            row["bound_ms"], row["bound_by"] = bound_s * 1e3, bound_by
            for name, (ms, spread) in time_in_turns(torch, fns,
                                                    lead_ms=LEAD_MS).items():
                row[f"{name}_ms"] = ms
                row[f"{name}_ms_spread"] = spread
            for name in calls:
                row[f"{name}_share_of_bound"] = (row["bound_ms"]
                                                 / row[f"{name}_ms"])
            if label in HOST_TIMED:
                row["host_ms"] = host_ms_per_call(
                    torch, lambda: fp.desc_forces_fused(*ops, SIG))
        emit(**row)
    print_card()
    if failed:
        sys.exit("time_fused_predict: a kernel disagrees with its plain "
                 "version or with itself")


if __name__ == "__main__":
    main()
