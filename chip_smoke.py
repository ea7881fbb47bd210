#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``mlff_tpu_torch``) once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line of its own numbers:

  build      compile every CUDA kernel from csrc/, one nvcc per source, all
             at once; ptxas's registers and spills (a spill in any kernel
             fails the run)
  kernel     each kernel against its plain PyTorch version on the card, at
             the main path's full shape and at a ragged one; times, bound.
             fused_predict also with queries that are training rows (zero
             distances) and with one query, twice for the same bits, timed
             in turns with its plain version (median, spread,
             share_of_bound) and, at B = 1 and B = 60, per call on the
             host's clock.
             The df64 passes also at the energy-constrained factor's
             32,648 x 1536, at a second ragged shape with several slabs
             (4099 x 1030) and at the shape the JAX package profiled them
             at (75,006 x 3840), at every shape against the f64 cuBLAS
             product of the unsplit B; at the three large shapes kernel and
             cuBLAS call are timed in turns (median, spread, vs_library,
             share_of_bound); df64_bt_v twice for the same bits
  apply      one preconditioner apply at the main factor shape: the f64
             split apply against the df64 apply with 3 and 2 components
  reference  a small training on the card against the same training on the
             CPU (the CPU port is held to the JAX package by the tests),
             with the f64 apply and with apply_impl="df64"
  train      calibrated ethanol, n = 31,482 (N_train = 1166, P = 6, sig = 10),
             lev_random Nystrom-PCG with k = 1536 to tol 1e-4, f64
  predict    Predictor(fast=True) through the fused kernel on the 60
             held-out and the 1166 training geometries, against the f64
             Predictor
  train_df64           the train phase with apply_impl="df64" (3 components):
                       every PCG iteration's preconditioner apply runs the
                       two df64 GEMV kernels
  train_colblock_df64  the same with nystrom_block_cols=512 (3 column
                       blocks, 2 components)
  zoo_full   the train phase's task with the factor preconditioners at
             k = 1536: cholesky (the greedy loop), cholesky_panel,
             rpcholesky, truncated_cholesky, cholesky_panel with
             apply_impl="df64" (the df64 kernels apply a Cholesky factor),
             and solver_name="cg_cholesky"; one line each, held-out forces
             through Predictor(fast=True)
  zoo_dense  calibrated ethanol at N_train = 120 (n = 3,240, k/n = 15%),
             where the dense families fit: all fourteen strategy strings,
             the preconditioned spectrum (flag_eigvals), a restarted solve
             from 2 inducing points, nystrom_method="chol", and the analytic
             solver, whose forces every converged cg model must match
  train_otf      the train phase's task with the on-the-fly matvec forced
                 (pairwise=False): 285 +- 2 iterations, held-out force MAE
                 within 1e-4 of the train phase's, one OTF matvec against
                 the cached one within 1e-12, ms per iteration beside the
                 cached training's
  train_157k     calibrated ethanol at N_train = 5833 (n = 157,491, k =
                 2368): above the 3 GB cache switch, so the Trainer takes
                 the OTF matvec; converged within 1300 iterations; one OTF
                 matvec's time beside one cached matvec's at that n
  train_aspirin  calibrated aspirin, N_train = 250 (n = 15,750, D = 210,
                 k = 1653): within 2400 iterations; then fast prediction
                 (the kernel's wide route) against the f64 Predictor
  train_catcher  calibrated catcher, N_train = 119 (n = 31,416, A = 88,
                 D = 3828, k = 3298): the square matvec, within 4650
                 iterations; fast prediction against f64
  nanotube       N_train = 14 (n = 15,540, D = 68,265): the cache's square
                 fields, 1631 columns by the square assembly against a
                 sample by the compressed one (1e-10), the compressed
                 diagonal against them, a solve capped at 200 iterations
                 whose residual is finite and lower after the last chunk of
                 50 iterations than after the first, fast prediction against
                 f64
  cli_reference  ``cli.main(["all", ...])`` on the reference phase's small
                 set with --device cuda and --device cpu: the same sigma,
                 iterations within 2, test force MAE within 1e-4
  cli_all        the CLI at full width on the card's default device:
                 ``all`` on calibrated ethanol (1166 training, 100
                 validation, 200 test points, sigma 10 and 20, lev_random at
                 k = 1536), then ``validate``, ``show`` and ``resume`` of
                 best_model.npz; P from the CLI's own symmetry search
  rule_of_thumb  harness.minimum_preconditioner_size on the train phase's
                 task at k = 256 ... 3072, then optimal_precon_k and
                 fit_slope beside the paper's (0.87, 10)
  benchmark_models  train_model analytic and cg (the rule-of-thumb k) on
                 cli_all's data, evaluate on 100 test points, forces within
                 5e-3 of max |F|; the analytic solve's peak device memory
                 with the ridge on K's diagonal against a dense identity
  train_ecstr    energy-constrained training (use_E_cstr) of the train
                 phase's task: n + N = 31,482 + 1,166 = 32,648, k = 1536,
                 lev_random to tol 1e-4, with (a) the f64 apply, (b)
                 apply_impl="df64" (3 components: the two df64 kernels on the
                 32,648 x 1536 factor in every PCG iteration) and (c) df64
                 with nystrom_block_cols=512 (2 components); converged
                 within 880 iterations, k = 1536, df64 launches >= iterations,
                 held-out force and energy MAE of (b), (c) within 10% of
                 (a)'s; then the analytic constrained solve of the same task
                 (dense 32,648^2), whose held-out forces and energies the
                 PCG model meets within 5e-3 of max |F| and of the energy
                 range; Predictor(fast=True) on the constrained model takes
                 the f64 contraction (the fused count stays 0, same bits)
  zoo_ecstr      the constrained system at N_train = 120 (n + N = 3,360,
                 k = 504): analytic, cholesky, cholesky_panel, rpcholesky,
                 truncated_cholesky, lev_random, lev_random with
                 allow_restarts from 2 inducing points (restarts at least
                 once), and the three eigvec variants (controls); every
                 converged model within 5e-3 of the analytic model's forces
                 and energies
  cli_ecstr      cli_reference with --E-cstr at --tol 1e-6: the same sigma on
                 card and CPU, iterations within 2, test force and energy
                 MAE within 1e-4
  precision      the arithmetic options of the solve on the train phase's
                 task, one line per part, each with the card's name and
                 power limit: (a) matvec_dtype="ozaki" (one matvec within
                 1e-12 of the f64 one, the solve within 400 iterations,
                 held-out MAE within 10%, fast prediction within the predict
                 phase's tolerances); (b) apply_impl="ozaki" (one apply
                 within 1e-13 of the f64 split apply, iterations within 2 of
                 train's); (c) MLFF_BUILD_GEMM=ozaki (guard quiet,
                 gram_probe_err, build seconds, iterations within 2); (d)
                 matvec_dtype "mixed" and "float32" capped at 3x train's
                 iterations (a reported convergence has a true f64 residual
                 <= 1.3e-4); (e) n = 157,491 on the OTF cache: the Ozaki OTF
                 matvec within 1e-12 of the f64 one, the mixed one's error,
                 the split factor's Gram at k = 2368 under both build
                 engines; (f) MLFF_TPU_HBM_CEILING_GB=0.3: the factor
                 switches to column blocks of 512, iterations within 2;
                 (g) IR-CG on zoo_dense's system: lam = 1e-6 converges
                 within 6 outer steps, lam = 1e-10 stops within 3, not
                 converged
The kernel phase also holds the fused kernel's wide route (D > 129) to its
plain version at D = 130, 210, 3828 and 68,265 (1e-12, same bits twice)
and times it at B = 512 at the aspirin, catcher and full-row shapes.

Then the kernel table as one JSON line, the card's name and power limit as
nvidia-smi reports them, and as the last line
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Any failed phase
exits non-zero without that line; without a CUDA card the script exits
non-zero before any phase.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import io
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
F64_PEAK = 67e12    # FP64 on the tensor cores, FLOP/s (the card's top f64 rate)
F32_PEAK = 67e12    # FP32 on the CUDA cores, FLOP/s
MEM_RATE = 3.35e12  # HBM3, bytes/s

N_TRAIN, N_SAMPLES, SIG, K_COLUMNS = 1166, 1226, 10.0, 1536
JAX_F64_ITERS = 287     # the JAX package's f64-matvec record (bench.py)
MAX_ITERS = 400
# the kernel vs its plain version and the fast Predictor vs the f64 one: the
# tolerances of the TPU kernel's own tests (tests/test_pallas_predict.py)
ATOL_REL, RTOL = 2e-5, 2e-4
# the df64 passes: (label, n, m), and their tolerance relative to max |ref|
# (tests/test_df64.py).  "profiled" is the shape of the JAX package's
# tools/profile_df64_kernels.py; its plain version is timed, not compared.
# "ecstr" is the factor of the energy-constrained main task (n + N rows).
DF64_SHAPES = (("main", 31482, K_COLUMNS), ("ecstr", 32648, K_COLUMNS),
               ("ragged", 1001, 130), ("ragged_slabs", 4099, 1030),
               ("profiled", 75006, 3840))
DF64_TIMED = ("main", "ecstr", "profiled")
DF64_RTOL = 3e-12
# a fused_predict call keeps the host for tens of microseconds, at small B
# longer than the card: its timed turns start behind a spin of this length
FUSED_LEAD_MS = 2.0
COLBLOCK_COLS = 512     # 3 column blocks of the k = 1536 factor
# a df64 model and the f64 model of the same task, both converged to the
# same tolerance, predict held-out forces of the same quality: their force
# MAEs agree within 10%, which still catches a broken solve
MAE_RATIO_LIMIT = 0.1
# zoo_full: (strategy or solver, extra task fields)
ZOO_FULL = (("cholesky", {}), ("cholesky_panel", {}), ("rpcholesky", {}),
            ("truncated_cholesky", {}),
            ("cholesky_panel", {"apply_impl": "df64"}), ("cg_cholesky", {}))
# every factor row must beat what catches a preconditioner that stopped
# working: the four factor strategies took 216-247 iterations on this task
# (PERF.md section 2), lev_random 285
ZOO_MAX_ITERS = 320
# zoo_dense: the size the dense families allow, and the strategies that are
# controls (built to precondition badly), which need not converge
ZOO_DENSE_N_TRAIN, ZOO_DENSE_FRACTION = 120, 0.15
ZOO_DENSE_MAX_ITERS = 6000
ZOO_CONTROLS = ("inverse_lev", "eigvec_precon_block_diagonal",
                "eigvec_precon_atomic_interactions")
# cg models against the analytic model on training geometries
# (tests/test_train_e2e.py::test_cg_matches_analytic)
ANALYTIC_ATOL_REL = 5e-3
# wide route of the fused kernel: (D, molecule and training geometries) of
# the checked cases; None: random operands of a width no molecule has
WIDE_CHECKED = ((130, None), (210, ("aspirin", 250)),
                (3828, ("catcher", 119)), (68265, ("nanotube", 14)))
# the wide kernel against its plain version: 1e-12 relative, f64 sums in
# another order (the narrow widths read ~4e-15)
WIDE_RTOL = 1e-12
# timed at B = 512: (label, operands, M, D); "full_*" are the full row's
# M = 6996 at a wide width (random operands at D = 3828: 6996 catcher
# geometries would take the host ~10 s to make)
WIDE_TIMED = (("aspirin", ("aspirin", 250), 1500, 210),
              ("catcher", ("catcher", 119), 119, 3828),
              ("full_210", ("aspirin", 1166), 6996, 210),
              ("full_3828", None, 6996, 3828))
# the large systems: (phase, molecule, N_train, k, iteration limit).  The
# limits: 157k, 841 iterations of the JAX package's ozaki OTF solve on a
# TPU + 50% (no f64 record); aspirin and catcher, the JAX package's counts
# (data/synthetic.py calibration: 1826, 3576) + 30%
LARGE = (("train_157k", "ethanol", 5833, 2368, 1300),
         ("train_aspirin", "aspirin", 250, 1653, 2400),
         ("train_catcher", "catcher", 119, 3298, 4650))
N_HELD_LARGE = 60
OTF_ITERS, OTF_ITERS_SLACK = 285, 2
OTF_MAE_RTOL = 1e-4
NANOTUBE_N_TRAIN, NANOTUBE_K, NANOTUBE_MAXITER = 14, 1631, 200
NANOTUBE_SAMPLE_EVERY = 26     # every 26th square column against compressed
SQUARE_RTOL = 1e-10
# the user's layers: the CLI, evaluate and the experiment harness.  cli_all's
# data: 1166 training, 100 validation and 200 test points of calibrated
# ethanol; its sigmas are the first two of the CLI's default grid, its k/n
# as Python writes 1536 / 31,482 (int(k/n * n) = 1536 exactly)
CLI_N_SAMPLES, CLI_N_VALID, CLI_N_TEST = 1466, 100, 200
CLI_SIGS = ("10", "20")
CLI_BREAK = repr(K_COLUMNS / (27 * N_TRAIN))
# the card against the CPU: the reference phase's limits
CLI_ITERS_SLACK, CLI_MAE_RTOL = 2, 1e-4
# the k-sweep: it brackets the rule of thumb's k = 2049 at n = 31,482
ROT_KS = (256, 512, 1024, 1536, 2048, 3072)
# tests/test_golden_archived.py::test_archived_cg_curves_are_monotone_decreasing
ROT_FIRST_OVER_LAST, ROT_NONINCREASING_SHARE = 2.0, 0.6
# train_ecstr: the JAX package's count for this task was not measured (a
# full-size JAX run belongs on no shared CPU).  On the same generator at
# N_train = 120, 240, 480 and k/n = 1536/31,482 the constrained solve took
# 1.66-2.21x the force-only solve's iterations, in both packages alike
# (PERF.md section 6), so the limit is train's 400 times 2.2
ECSTR_MAX_ITERS = 880
# zoo_ecstr: (row, strategy, extra task fields, extra train arguments); the
# eigvec rows are controls (tests/test_ecstr.py asserts no convergence of
# the masked ones)
ZOO_ECSTR = (("cholesky", "cholesky", {}, {}),
             ("cholesky_panel", "cholesky_panel", {}, {}),
             ("rpcholesky", "rpcholesky", {}, {}),
             ("truncated_cholesky", "truncated_cholesky", {}, {}),
             ("lev_random", "lev_random", {}, {}),
             ("allow_restarts", "lev_random", {"n_inducing_pts_init": 2},
              {"break_percentage": None, "allow_restarts": True}),
             ("eigvec_precon", "eigvec_precon", {}, {}),
             ("eigvec_precon_block_diagonal",
              "eigvec_precon_block_diagonal", {}, {}),
             ("eigvec_precon_atomic_interactions",
              "eigvec_precon_atomic_interactions", {}, {}))
# precision: one matvec of an f64-grade engine against the f64 one, the
# lam-floor bound (ARCHITECTURE.md; the JAX package's Ozaki matvec measured
# 2.0e-13 on a TPU); the Ozaki apply against the f64 split apply
# (tests/test_ozaki.py); iterations of the f64-grade options within 2 of
# train's; a reduced-precision solve that reports convergence has a true
# f64 residual within tests/test_mixed_matvec.py's 1.3e-4
PRECISION_MATVEC_RTOL, PRECISION_APPLY_RTOL = 1e-12, 1e-13
PRECISION_ITERS_SLACK, PRECISION_RESID_LIMIT = 2, 1.3e-4
# the ceiling that trips the switch on the main task's 0.39 GB factor
CEILING_ENV, PRECISION_CEILING_GB = "MLFF_TPU_HBM_CEILING_GB", "0.3"
PRECISION_157K = ("ethanol", 5833, 2368)      # train_157k's task
IR_MAX_OUTER = 6                              # tests/test_ir_cg.py


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def close(a, b, scale) -> tuple[bool, float]:
    """(all |a - b| <= ATOL_REL * scale + RTOL * |b|, max |a - b|)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.abs(a - b)
    ok = bool(np.all(np.isfinite(a)) and np.all(err <= ATOL_REL * scale
                                                 + RTOL * np.abs(b)))
    return ok, float(err.max()) if err.size else 0.0


def time_ms(torch, fn, reps: int = 20) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls, by CUDA
    events, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def f32_contraction_error(torch, pred, R) -> float:
    """max |F_desc(f32) - F_desc(f64)| / max |F_desc(f64)| on geometries R,
    where the f32 version repeats the TPU kernel's arithmetic (f64
    distances, everything else f32).  It says why the port's kernel is
    f64."""
    from mlff_tpu_torch.ops import kernel as knl

    Xq, _ = pred._query_descriptors(
        torch.as_tensor(R, dtype=torch.float64, device=pred.device))
    F64, _ = knl._desc_forces_x(
        pred.Xqt, pred.sig, Xq,
        *weights(knl.pairwise_dist_gram(Xq, pred.Xqt), pred.sig), pred.wt)
    a, a1 = weights(knl.pairwise_dist_gram(Xq, pred.Xqt).float(), pred.sig)
    xq, xt, w = Xq.float(), pred.Xqt.float(), pred.wt.float()
    G = a * (xq @ w.T - torch.sum(xt * w, dim=1)[None, :])
    F32 = xq * torch.sum(G, dim=1, keepdim=True) - G @ xt - a1 @ w
    return float((F32.double() - F64).abs().max() / F64.abs().max())


def weights(dist, sig):
    """(a, a1) = 5/(3 sig^2) exp(-dist) and a (1 + dist)."""
    a = (5.0 / (3.0 * sig**2)) * (-dist).exp()
    return a, a * (1.0 + dist)


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def fused_predict_rows(torch, Xq, Xqt, wt, Xq_held) -> dict:
    """The fused kernel against its plain version on the main path's
    operands: Xq (512 training descriptors as queries), Xqt and wt (the
    permuted training set), Xq_held (the 60 held-out queries).  Returns
    {label: row}; ``full`` carries the times."""
    from mlff_tpu_torch.ops import fused_predict as fp
    from mlff_tpu_torch.utils.timing import host_ms_per_call, time_in_turns

    M, D = Xqt.shape
    cases = {"full": (Xq, M), "ragged": (Xq[:7], M - 37),
             "self": (Xqt[:512], M), "one": (Xq_held[:1], M),
             "held_out": (Xq_held, M)}
    rows = {}
    for label, (queries, Mr) in cases.items():
        args = (queries.contiguous(), Xqt[:Mr].contiguous(),
                wt[:Mr].contiguous(), SIG)
        B = args[0].shape[0]
        F_k, E_k = fp.desc_forces_fused(*args)
        F_2, E_2 = fp.desc_forces_fused(*args)
        F_r, E_r = fp.desc_forces_fused_ref(*args)
        torch.cuda.synchronize()
        same = bool(torch.equal(F_k, F_2) and torch.equal(E_k, E_2))
        F_k, E_k, F_r, E_r = (t.cpu().numpy() for t in (F_k, E_k, F_r, E_r))
        okF, errF = close(F_k, F_r, np.abs(F_r).max())
        okE, errE = close(E_k, E_r, np.abs(E_r).max())
        row = {"shape": label, "B": B, "M": Mr, "D": D,
               "max_abs_err_F": errF, "max_abs_err_E": errE,
               "max_abs_F": float(np.abs(F_r).max()),
               "rel_err_F": errF / float(np.abs(F_r).max()),
               "same_bits_twice": same, "ok": okF and okE and same}
        if label in ("full", "one", "held_out"):
            turns = time_in_turns(torch, {
                "plain": lambda: fp.desc_forces_fused_ref(*args),
                "kernel": lambda: fp.desc_forces_fused(*args)},
                lead_ms=FUSED_LEAD_MS)
            row["ms"], row["ms_spread"] = turns["kernel"]
            row["plain_ms"], row["plain_ms_spread"] = turns["plain"]
            bound_s, bound_by = fp.bound_seconds(B, Mr, D, F64_PEAK, MEM_RATE)
            row["bound_ms"] = bound_s * 1e3
            row["bound_by"] = bound_by
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
        if label in ("one", "held_out"):
            row["host_ms"] = host_ms_per_call(
                torch, lambda: fp.desc_forces_fused(*args))
        emit("kernel", name="fused_predict", **row)
        if not row["ok"]:
            fail(f"fused_predict disagrees with its plain version or with "
                 f"itself ({label})")
        if row.get("share_of_bound", 0.0) > 1.0:
            fail(f"fused_predict ({label}) timed below its bound: "
                 f"{row['ms']} ms against {row['bound_ms']} ms")
        rows[label] = row
    return rows


def random_operands(torch, B: int, M: int, D: int, seed: int):
    """(Xq (B, D), Xqt (M, D), wt (M, D)) on the card, seeded: descriptors in
    [0.05, 0.15), standard normal cotangents."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def uniform(*shape):
        return 0.05 + 0.1 * torch.rand(shape, generator=gen,
                                       dtype=torch.float64, device="cuda")

    return uniform(B, D), uniform(M, D), torch.randn(
        (M, D), generator=gen, dtype=torch.float64, device="cuda")


def fused_wide_rows(torch) -> dict:
    """The fused kernel's wide route (D > 129) against its plain version at
    every width of WIDE_CHECKED, with B = 7 and a full batch and M ragged
    against its 16-row steps, twice for the same bits; then timed in turns
    with its plain version at the shapes of WIDE_TIMED, and at B = 1.
    Returns {label: row} of the timed rows."""
    from mlff_tpu_torch.ops import fused_predict as fp
    from mlff_tpu_torch.tools.time_fused_predict import operands
    from mlff_tpu_torch.utils.timing import time_in_turns

    for D, source in WIDE_CHECKED:
        if source is None:
            Xq, Xqt, wt = random_operands(torch, 513, 301, D, D)
        else:
            Xq, Xqt, wt = operands(*source, 513 if D < 68265 else 60, "cuda")
        M = Xqt.shape[0] - 3 if Xqt.shape[0] > 64 else Xqt.shape[0]
        for B in (7, Xq.shape[0]):
            args = (Xq[:B].contiguous(), Xqt[:M].contiguous(),
                    wt[:M].contiguous(), SIG)
            F_k, E_k = fp.desc_forces_fused(*args)
            F_2, E_2 = fp.desc_forces_fused(*args)
            F_r, E_r = fp.desc_forces_fused_ref(*args)
            torch.cuda.synchronize()
            row = {"shape": f"wide_{D}", "B": B, "M": M, "D": D,
                   "max_abs_err_F": float((F_k - F_r).abs().max()),
                   "rel_err_F": rel_err(F_k, F_r),
                   "rel_err_E": rel_err(E_k, E_r),
                   "same_bits_twice": bool(torch.equal(F_k, F_2)
                                           and torch.equal(E_k, E_2))}
            row["ok"] = bool(row["rel_err_F"] <= WIDE_RTOL
                             and row["rel_err_E"] <= WIDE_RTOL
                             and row["same_bits_twice"]
                             and torch.isfinite(F_k).all())
            emit("kernel", name="fused_predict", route="wide", **row)
            if not row["ok"]:
                fail(f"fused_predict's wide route disagrees with its plain "
                     f"version or with itself (D = {D}, B = {B})")
        del Xq, Xqt, wt

    rows = {}
    for label, source, M, D in WIDE_TIMED:
        if source is None:
            Xq, Xqt, wt = random_operands(torch, 512, M, D, 7)
        else:
            Xq, Xqt, wt = operands(*source, 512, "cuda")
        if tuple(Xqt.shape) != (M, D):
            fail(f"wide operands {label}: {tuple(Xqt.shape)}, not {(M, D)}")
        args, one = (Xq, Xqt, wt, SIG), (Xq[:1].contiguous(), Xqt, wt, SIG)
        turns = time_in_turns(torch, {
            "plain": lambda: fp.desc_forces_fused_ref(*args),
            "kernel": lambda: fp.desc_forces_fused(*args)},
            lead_ms=FUSED_LEAD_MS)
        ms_one = time_in_turns(torch, {
            "kernel": lambda: fp.desc_forces_fused(*one)},
            lead_ms=FUSED_LEAD_MS)["kernel"][0]
        F_k, _ = fp.desc_forces_fused(*args)
        F_r, _ = fp.desc_forces_fused_ref(*args)
        bound_s, bound_by = fp.bound_seconds(512, M, D, F64_PEAK, MEM_RATE)
        row = {"shape": label, "B": 512, "M": M, "D": D,
               "max_abs_err_F": float((F_k - F_r).abs().max()),
               "rel_err_F": rel_err(F_k, F_r),
               "ms": turns["kernel"][0], "ms_spread": turns["kernel"][1],
               "plain_ms": turns["plain"][0],
               "plain_ms_spread": turns["plain"][1],
               "bound_ms": bound_s * 1e3, "bound_by": bound_by,
               "ms_B1": ms_one, "plan": str(fp.plan(512, M, D, fp._sm_count(
                   torch.cuda.current_device())))}
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        emit("kernel", name="fused_predict", route="wide", **row)
        if row["rel_err_F"] > WIDE_RTOL:
            fail(f"fused_predict's wide route disagrees with its plain "
                 f"version ({label})")
        if row["share_of_bound"] > 1.0:
            fail(f"fused_predict ({label}) timed below its bound: "
                 f"{row['ms']} ms against {row['bound_ms']} ms")
        rows[label] = row
        del Xq, Xqt, wt, args, one, F_k, F_r
    torch.cuda.empty_cache()
    return rows


def fast_against_f64(model, R, dev):
    """Predictor(fast=True) against the f64 Predictor on geometries R:
    (ok, max |dF|, max |dE|, max |F|, fast forces)."""
    from mlff_tpu_torch.models.predict import Predictor

    E_f, F_f = Predictor(model, fast=True, device=dev).predict(R)
    E_x, F_x = Predictor(model, device=dev).predict(R)
    okF, errF = close(F_f, F_x, np.abs(F_x).max())
    E_c = E_x - model["c"]
    okE, errE = close(E_f - model["c"], E_c, np.abs(E_c).max())
    ok = okF and okE and bool(np.all(np.isfinite(F_f))) \
        and F_f.shape == F_x.shape
    return ok, errF, errE, float(np.abs(F_x).max()), F_f


def train_otf(torch, dev, task, ds, held, cached_row, mae_ref) -> int:
    """The train phase's task with the on-the-fly matvec forced
    (pairwise=False): iterations and held-out forces against the cached
    training's, and one OTF matvec against the cached one.  Returns the
    fused kernel's launches in the phase."""
    from mlff_tpu_torch.models.gdml import Trainer
    from mlff_tpu_torch.models.predict import Predictor
    from mlff_tpu_torch.ops import fused_predict as fp
    from mlff_tpu_torch.ops import kernel as knl

    tr = Trainer(device=dev)
    tr._pairwise_fits = lambda n_train, n_perms: False
    fp.desc_forces_fused.launches = 0
    t0 = time.perf_counter()
    m = tr.train(task, n_columns=K_COLUMNS, str_preconditioner="lev_random")
    train_s = time.perf_counter() - t0
    info = tr.last_info
    _, F = Predictor(m, fast=True, device=dev).predict(ds["R"][held])
    launches = fp.desc_forces_fused.launches
    mae = float(np.abs(F - ds["F"][held]).mean())
    iters = int(m["solver_iters"])

    spec, S, X, Jc, P_idx = tr.build_kernel_inputs(task)
    cached = knl.build_cache(X, Jc, S, P_idx, SIG, 1e-10, device=dev)
    otf = knl.build_cache(X, Jc, S, P_idx, SIG, 1e-10, pairwise=False,
                          device=dev)
    v = torch.randn(cached.n, generator=torch.Generator(
        device=dev).manual_seed(4), dtype=torch.float64, device=dev)
    matvec_err = rel_err(knl.matvec_psd(otf, v), knl.matvec_psd(cached, v))
    row = dict(n=cached.n, k=K_COLUMNS, converged=bool(m["is_conv"]),
               iters=iters, cached_iters=cached_row["iters"],
               cg_s=info["total_time_cg"], train_s=train_s,
               ms_per_iter=info["total_time_cg"] * 1e3 / max(iters, 1),
               ms_per_iter_cached=cached_row["cg_s"] * 1e3
               / max(cached_row["iters"], 1),
               matvec_otf_ms=time_ms(torch, lambda: knl.matvec_psd(otf, v)),
               matvec_cached_ms=time_ms(torch,
                                        lambda: knl.matvec_psd(cached, v)),
               otf_tile=knl._otf_tile(cached.n_train, cached.Xqt.shape[0]),
               rel_err_matvec_vs_cached=matvec_err,
               force_mae_held_out=mae, force_mae_held_out_cached=mae_ref,
               launches=launches)
    emit("train_otf", **row)
    del cached, otf
    if not m["is_conv"] or abs(iters - OTF_ITERS) > OTF_ITERS_SLACK:
        fail(f"train_otf: converged={m['is_conv']} in {iters} PCG iterations "
             f"(want {OTF_ITERS} +- {OTF_ITERS_SLACK})")
    if not abs(mae / mae_ref - 1.0) <= OTF_MAE_RTOL:
        fail(f"train_otf: held-out force MAE {mae} against {mae_ref}")
    if not matvec_err <= 1e-12:
        fail(f"train_otf: OTF matvec {matvec_err} from the cached one")
    if launches == 0:
        fail("train_otf: Predictor(fast=True) did not launch fused_predict")
    return launches


def large_system(torch, dev, phase, molecule, n_train, k, limit) -> int:
    """Train a large system to tol 1e-4 with lev_random, then predict its
    60 held-out geometries fast and in f64.  train_157k is above the 3 GB
    cache switch (the OTF matvec) and also times one OTF matvec beside one
    cached matvec at its n; train_catcher takes the square matvec.  Returns
    the fused kernel's launches in the phase."""
    from mlff_tpu_torch.data.synthetic import make_benchmark_dataset
    from mlff_tpu_torch.models.gdml import Trainer
    from mlff_tpu_torch.models.task import create_task
    from mlff_tpu_torch.ops import fused_predict as fp
    from mlff_tpu_torch.ops import kernel as knl

    ds, perms = make_benchmark_dataset(molecule, n_samples=n_train
                                       + N_HELD_LARGE, seed=11,
                                       n_train=n_train)
    task = create_task(ds, n_train, ds, n_valid=min(50, N_HELD_LARGE),
                       sig=SIG, solver="cg",
                       perms=perms)
    held = np.setdiff1d(np.arange(n_train + N_HELD_LARGE), task["idxs_train"])
    tr = Trainer(device=dev)
    n_atoms = ds["R"].shape[1]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fp.desc_forces_fused.launches = 0
    t0 = time.perf_counter()
    m = tr.train(task, n_columns=k, str_preconditioner="lev_random")
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    info = tr.last_info
    iters = int(m["solver_iters"])
    ok, errF, errE, max_F, F = fast_against_f64(m, ds["R"][held], dev)
    launches = fp.desc_forces_fused.launches
    row = dict(molecule=molecule, n=int(np.asarray(task["F_train"]).size),
               N_train=n_train, A=n_atoms, D=n_atoms * (n_atoms - 1) // 2,
               P=int(perms.shape[0]), k=len(m["inducing_pts_idxs"]),
               pairwise=Trainer._pairwise_fits(n_train, perms.shape[0]),
               matvec_impl=info["matvec_impl"], converged=bool(m["is_conv"]),
               iters=iters, iters_limit=limit, train_s=train_s,
               cache_build_s=info["cache_build_s"],
               preconditioner_s=info["total_time_preconditioner"],
               cg_s=info["total_time_cg"],
               ms_per_iter=info["total_time_cg"] * 1e3 / max(iters, 1),
               peak_mem_gb=peak,
               force_mae_held_out=float(np.abs(F - ds["F"][held]).mean()),
               max_abs_err_F_vs_f64=errF, max_abs_err_E_vs_f64=errE,
               max_abs_F=max_F, launches=launches)
    if phase == "train_157k":
        spec, S, X, Jc, P_idx = tr.build_kernel_inputs(task)
        otf = knl.build_cache(X, Jc, S, P_idx, SIG, 1e-10, pairwise=False,
                              device=dev)
        v = torch.randn(otf.n, generator=torch.Generator(
            device=dev).manual_seed(4), dtype=torch.float64, device=dev)
        row["matvec_otf_ms"] = time_ms(torch, lambda: knl.matvec_psd(otf, v),
                                       reps=5)
        row["otf_tile"] = knl._otf_tile(n_train, otf.Xqt.shape[0])
        Kv = knl.matvec_psd(otf, v)
        del otf
        cached = knl.build_cache(X, Jc, S, P_idx, SIG, 1e-10, device=dev)
        row["matvec_cached_ms"] = time_ms(
            torch, lambda: knl.matvec_psd(cached, v), reps=5)
        row["rel_err_matvec_otf_vs_cached"] = rel_err(
            Kv, knl.matvec_psd(cached, v))
        row["cache_gb"] = 2 * cached.A_exp.numel() * 8 / 1e9
        del cached, X, Jc, S
        torch.cuda.empty_cache()
    emit(phase, **row)
    if not m["is_conv"] or iters > limit:
        fail(f"{phase}: converged={m['is_conv']} in {iters} PCG iterations "
             f"(limit {limit})")
    if not ok:
        fail(f"{phase}: Predictor(fast=True) disagrees with the f64 "
             "Predictor")
    if launches == 0:
        fail(f"{phase}: Predictor(fast=True) did not launch fused_predict")
    if phase == "train_157k" and (row["pairwise"] or not row[
            "rel_err_matvec_otf_vs_cached"] <= 1e-12):
        fail("train_157k: not on the OTF matvec, or the OTF matvec "
             "disagrees with the cached one")
    if phase == "train_catcher" and row["matvec_impl"] != "square":
        fail("train_catcher: the square matvec was not selected")
    return launches


def nanotube(torch, dev) -> int:
    """The nanotube (A = 370, D = 68,265, P = 1) at N_train = 14: the cache's
    square fields, 1631 Nystrom columns through the square assembly against
    the compressed one, the compressed diagonal, a capped solve and fast
    prediction.  Returns the fused kernel's launches in the phase."""
    from mlff_tpu_torch.data.synthetic import make_benchmark_dataset
    from mlff_tpu_torch.models.gdml import Trainer
    from mlff_tpu_torch.models.task import create_task
    from mlff_tpu_torch.ops import fused_predict as fp
    from mlff_tpu_torch.ops import kernel as knl

    N = NANOTUBE_N_TRAIN
    ds, perms = make_benchmark_dataset("nanotube", n_samples=N + N_HELD_LARGE,
                                       seed=11, n_train=N)
    task = create_task(ds, N, ds, n_valid=min(50, N_HELD_LARGE), sig=SIG,
                       solver="cg",
                       perms=perms)
    held = np.setdiff1d(np.arange(N + N_HELD_LARGE), task["idxs_train"])
    tr = Trainer(device=dev)
    spec, S, X, Jc, P_idx = tr.build_kernel_inputs(task)
    cache = knl.build_cache(X, Jc, S, P_idx, SIG, 1e-10,
                            R=Trainer._square_R(task, spec, P_idx),
                            device=dev)
    fields = [f for f in ("Xsq", "Gsq", "Usq", "Zsq", "C1sq")
              if getattr(cache, f) is not None]
    cols = np.sort(np.random.default_rng(5).choice(cache.n, NANOTUBE_K,
                                                   replace=False))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    K_sq = knl.assemble_columns_square(spec, cache, cols)
    torch.cuda.synchronize()
    square_s = time.perf_counter() - t0
    sample = np.arange(0, NANOTUBE_K, NANOTUBE_SAMPLE_EVERY)
    t0 = time.perf_counter()
    K_c = knl.assemble_columns_compressed(spec, cache, cols[sample])
    torch.cuda.synchronize()
    compressed_s = time.perf_counter() - t0
    err_cols = rel_err(K_sq[:, torch.as_tensor(sample, device=dev)], K_c)
    diag = knl.kernel_diag_compressed(spec.dim_i, cache)
    idx = torch.as_tensor(cols, device=dev)
    err_diag = rel_err(diag[idx], K_sq[idx, torch.arange(NANOTUBE_K,
                                                        device=dev)])
    del cache, K_sq, K_c, diag, X, Jc, S
    torch.cuda.empty_cache()

    history = []       # (iterations, residual) after each chunk of PCG
    fp.desc_forces_fused.launches = 0
    t0 = time.perf_counter()
    m = tr.train(dict(task, solver_maxiter=NANOTUBE_MAXITER),
                 n_columns=NANOTUBE_K, str_preconditioner="lev_random",
                 callback=lambda it, resid, eff: history.append(
                     (int(it), float(resid))))
    train_s = time.perf_counter() - t0
    info = tr.last_info
    ok, errF, errE, max_F, _ = fast_against_f64(m, ds["R"][held], dev)
    launches = fp.desc_forces_fused.launches
    resid, norm_y = float(m["solver_resid"]), float(m["norm_y_train"])
    row = dict(n=N * 370 * 3, N_train=N, D=spec.dim, square_fields=fields,
               k=NANOTUBE_K, square_columns_s=square_s,
               compressed_columns_s=compressed_s,
               compressed_sampled=len(sample),
               rel_err_square_vs_compressed=err_cols,
               rel_err_diag_vs_square_columns=err_diag,
               matvec_impl=info["matvec_impl"],
               iters=int(m["solver_iters"]), converged=bool(m["is_conv"]),
               resid=resid, norm_y=norm_y, rel_resid=resid / norm_y,
               resid_history=history,
               train_s=train_s,
               preconditioner_s=info["total_time_preconditioner"],
               cg_s=info["total_time_cg"], max_abs_err_F_vs_f64=errF,
               max_abs_err_E_vs_f64=errE, max_abs_F=max_F,
               launches=launches)
    emit("nanotube", **row)
    if len(fields) != 5:
        fail(f"nanotube: the cache carries square fields {fields} only")
    if not (err_cols <= SQUARE_RTOL and err_diag <= SQUARE_RTOL):
        fail(f"nanotube: square columns {err_cols} from the compressed ones, "
             f"diagonal {err_diag}")
    resids = [r for _, r in history]
    if not (len(resids) >= 2 and np.all(np.isfinite(resids))
            and resids[-1] < resids[0]
            and m["solver_iters"] <= NANOTUBE_MAXITER):
        fail(f"nanotube: the capped solve's residual is not finite and "
             f"falling: {history}")
    if info["matvec_impl"] != "square":
        fail("nanotube: the square matvec was not selected")
    if not ok:
        fail("nanotube: Predictor(fast=True) disagrees with the f64 Predictor")
    if launches == 0:
        fail("nanotube: Predictor(fast=True) did not launch fused_predict")
    return launches


def df64_kernel_rows(torch) -> dict:
    """Both df64 passes at every shape of DF64_SHAPES on a random f64 B
    (seeded, made on the card): against the plain version (all but
    profiled) and the f64 cuBLAS product (all); at main and profiled the
    kernel and the cuBLAS call are timed in turns.  Returns
    {(name, label): row}."""
    from mlff_tpu_torch.ops import df64
    from mlff_tpu_torch.ops import df64_gemv as dg
    from mlff_tpu_torch.utils.timing import time_in_turns

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = {}
    for label, n, m in DF64_SHAPES:
        B64 = torch.randn((n, m), generator=gen, dtype=torch.float64,
                          device="cuda") / n**0.5
        Bh, Bl = df64.split_f64(B64)
        library = {"df64_bt_v": lambda v: B64.T @ v,    # one cuBLAS DGEMV
                   "df64_b_x": lambda x: B64 @ x}
        for name, length in (("df64_bt_v", n), ("df64_b_x", m)):
            vec = torch.randn(length, generator=gen, dtype=torch.float64,
                              device="cuda")
            kernel = getattr(dg, name)
            plain = getattr(dg, name + "_ref")
            got = kernel(Bh, Bl, vec)
            row = {"shape": label, "n": n, "m": m,
                   "rel_err_vs_f64": rel_err(got, library[name](vec))}
            ok = row["rel_err_vs_f64"] <= DF64_RTOL
            if label != "profiled":
                ref = plain(Bh, Bl, vec)
                row["max_abs_err"] = float((got - ref).abs().max())
                row["rel_err_vs_plain"] = rel_err(got, ref)
                ok = ok and row["rel_err_vs_plain"] <= DF64_RTOL
                del ref
            if label == "main" and name == "df64_bt_v":
                row["same_bits_twice"] = bool(
                    torch.equal(got, kernel(Bh, Bl, vec)))
                ok = ok and row["same_bits_twice"]
            if label in DF64_TIMED:
                turns = time_in_turns(torch, {
                    "library": lambda: library[name](vec),
                    "kernel": lambda: kernel(Bh, Bl, vec)})
                row["ms"], row["ms_spread"] = turns["kernel"]
                row["library_ms"], row["library_ms_spread"] = turns["library"]
                row["plain_ms"] = time_ms(torch, lambda: plain(Bh, Bl, vec),
                                          reps=5)
                bound_s, bound_by = dg.bound_seconds(n, m, F32_PEAK, MEM_RATE)
                row["bound_ms"] = bound_s * 1e3
                row["bound_by"] = bound_by
                row["vs_library"] = row["ms"] / row["library_ms"]
                row["share_of_bound"] = row["bound_ms"] / row["ms"]
            row["ok"] = bool(ok and torch.isfinite(got).all())
            emit("kernel", name=name, **row)
            if not row["ok"]:
                fail(f"{name} disagrees with its plain version or the f64 "
                     f"product, or with itself ({label})")
            if row.get("share_of_bound", 0.0) > 1.0:
                fail(f"{name} ({label}) timed below its byte bound: "
                     f"{row['ms']} ms against {row['bound_ms']} ms")
            rows[(name, label)] = row
        if label == "main":
            apply_times(torch, B64)
        del B64, Bh, Bl
        torch.cuda.empty_cache()
    return rows


def apply_times(torch, B64) -> None:
    """Device ms of one preconditioner apply on the factor B64 with a
    random upper-triangular W2: the f64 split apply (cuBLAS) and the df64
    apply with 3 and with 2 components (the kernels plus the f32 GEMVs of
    the third component)."""
    from mlff_tpu_torch.solvers import preconditioners as pc

    n, m = B64.shape
    gen = torch.Generator(device="cuda").manual_seed(3)
    W2 = torch.triu(torch.randn((m, m), generator=gen, dtype=torch.float64,
                                device="cuda")) / m
    v = torch.randn(n, generator=gen, dtype=torch.float64, device="cuda")
    P = pc.WoodburySplitPreconditioner(B=B64, W2=W2, lam=1e-10, info={})
    times = {"xla_ms": time_ms(torch, lambda: P(v))}
    for comps in (3, 2):
        Bh, Bl, Bm = pc._split_pad_b(B64, n, m, comps)
        P = pc.DF64WoodburyPreconditioner(Bh=Bh, Bl=Bl, W2=W2, lam=1e-10,
                                          Bm=Bm)
        times[f"df64_{comps}_components_ms"] = time_ms(torch, lambda: P(v))
    emit("apply", n=n, m=m, **times)


def zoo_full(torch, tr, task, ds, held, mae_ref, counters) -> dict:
    """The factor preconditioners at the main task's full width.  Returns
    the kernel launches of the phase."""
    from mlff_tpu_torch.models.predict import Predictor

    fp, dg = counters
    fp.desc_forces_fused.launches = 0
    dg.df64_bt_v.launches = 0
    dg.df64_b_x.launches = 0
    n = int(np.asarray(task["F_train"]).size)
    for name, extra in ZOO_FULL:
        solver = "cg_cholesky" if name == "cg_cholesky" else "cg"
        kw = {} if solver == "cg_cholesky" else {"str_preconditioner": name}
        before = (dg.df64_bt_v.launches, dg.df64_b_x.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.train(dict(task, solver_name=solver, **extra),
                     n_columns=K_COLUMNS, **kw)
        train_s = time.perf_counter() - t0
        info = tr.last_info
        _, F = Predictor(m, fast=True, device=tr.device).predict(ds["R"][held])
        mae = float(np.abs(F - ds["F"][held]).mean())
        iters = int(m["solver_iters"])
        row = dict(
            strategy=name, n=n, k=K_COLUMNS, **extra,
            build_s=info.get("total_time_preconditioner",
                             info.get("total_time_cholesky_s")),
            factor_s=info.get("total_time_cholesky_s"),
            iters=iters, converged=bool(m["is_conv"]),
            cg_s=info["total_time_cg"], train_s=train_s,
            remaining_diag_error=info.get("remaining_diag_error"),
            min_pivot=info.get("min_pivot"),
            force_mae_held_out=mae, force_mae_held_out_train=mae_ref,
            df64_launches=[dg.df64_bt_v.launches - before[0],
                           dg.df64_b_x.launches - before[1]])
        emit("zoo_full", **row)
        if not m["is_conv"] or iters > ZOO_MAX_ITERS:
            fail(f"zoo_full {name}: converged={m['is_conv']} in {iters} PCG "
                 f"iterations (limit {ZOO_MAX_ITERS})")
        if not (np.all(np.isfinite(F))
                and abs(mae / mae_ref - 1.0) <= MAE_RATIO_LIMIT):
            fail(f"zoo_full {name}: held-out force MAE {mae} against "
                 f"{mae_ref} of the train phase's model")
        if extra.get("apply_impl") == "df64" and min(row["df64_launches"]) == 0:
            fail(f"zoo_full {name}: the df64 apply of a Cholesky factor did "
                 "not launch both df64 kernels")
    launches = {"fused_predict": fp.desc_forces_fused.launches,
                "df64_bt_v": dg.df64_bt_v.launches,
                "df64_b_x": dg.df64_b_x.launches}
    if min(launches.values()) == 0:
        fail(f"zoo_full did not launch every kernel: {launches}")
    return launches


def zoo_dense(torch, dev) -> None:
    """Every strategy string, the spectrum, a restarted solve, the fused
    Cholesky method and the analytic solver at a size the dense families
    allow."""
    from mlff_tpu_torch.data.synthetic import make_benchmark_dataset
    from mlff_tpu_torch.models.gdml import Trainer
    from mlff_tpu_torch.models.predict import Predictor
    from mlff_tpu_torch.models.task import create_task
    from mlff_tpu_torch.solvers.iterative import ALL_STRATEGIES

    N = ZOO_DENSE_N_TRAIN
    ds, perms = make_benchmark_dataset("ethanol", n_samples=N + 50, seed=11,
                                       n_train=N)
    task = create_task(ds, N, ds, n_valid=min(50, N_HELD_LARGE), sig=SIG,
                       solver="cg",
                       perms=perms)
    task["solver_maxiter"] = ZOO_DENSE_MAX_ITERS
    tr = Trainer(device=dev)
    R10 = np.asarray(task["R_train"])[:10]

    t0 = time.perf_counter()
    m_an = tr.train(dict(task, solver_name="analytic"))
    _, F_an = Predictor(m_an, device=dev).predict(R10)
    scale = float(np.abs(F_an).max())
    emit("zoo_dense", row="analytic", n=27 * N,
         train_s=time.perf_counter() - t0, max_abs_F=scale)
    if not (F_an.shape == (10, 9, 3) and np.all(np.isfinite(F_an))):
        fail("zoo_dense: the analytic model's forces are not finite")

    def check(label, m):
        """A converged cg model's forces against the analytic model's."""
        _, F = Predictor(m, device=dev).predict(R10)
        err = float(np.abs(F - F_an).max())
        if m["is_conv"] and not err <= ANALYTIC_ATOL_REL * scale:
            fail(f"zoo_dense {label}: forces miss the analytic model's by "
                 f"{err} (max |F| {scale})")
        return err

    svd_cache: dict = {}
    for strategy in ALL_STRATEGIES:
        t0 = time.perf_counter()
        m = tr.train(task, break_percentage=ZOO_DENSE_FRACTION,
                     str_preconditioner=strategy, svd_cache=svd_cache)
        info = tr.last_info
        emit("zoo_dense", row="strategy", strategy=strategy, n=27 * N,
             k=len(m["inducing_pts_idxs"]),
             build_s=info["total_time_preconditioner"],
             iters=int(m["solver_iters"]), converged=bool(m["is_conv"]),
             cg_s=info["total_time_cg"], train_s=time.perf_counter() - t0,
             max_abs_err_F_vs_analytic=check(strategy, m))
        if not m["is_conv"] and strategy not in ZOO_CONTROLS:
            fail(f"zoo_dense {strategy}: not converged in "
                 f"{m['solver_iters']} iterations")

    # the spectrum of P^-1 (K + lam I): real parts, all positive
    m = tr.train(task, break_percentage=ZOO_DENSE_FRACTION,
                 str_preconditioner="lev_random", flag_eigvals=True)
    ev, ev_K = tr.last_info["eigvals"], tr.last_info["eigvals_K"]
    emit("zoo_dense", row="flag_eigvals", strategy="lev_random",
         iters=int(m["solver_iters"]), eig_min=float(ev.min()),
         eig_max=float(ev.max()), eig_K_min=float(ev_K.min()),
         eig_K_max=float(ev_K.max()))
    if not (ev.shape == (27 * N,) and np.all(np.isfinite(ev)) and ev.min() > 0
            and m["solver_iters"] == 10):
        fail("zoo_dense flag_eigvals: the preconditioned spectrum is not "
             "positive, or the 10-iteration cap did not hold")

    # restarts from a deliberately small inducing set
    m = tr.train(dict(task, n_inducing_pts_init=2), break_percentage=None,
                 str_preconditioner="lev_random", allow_restarts=True)
    emit("zoo_dense", row="allow_restarts", strategy="lev_random",
         num_restarts=int(m["num_restarts"]), iters=int(m["solver_iters"]),
         converged=bool(m["is_conv"]), k_final=len(m["inducing_pts_idxs"]),
         max_abs_err_F_vs_analytic=check("allow_restarts", m))
    if not m["is_conv"] or m["num_restarts"] < 1:
        fail(f"zoo_dense allow_restarts: converged={m['is_conv']} after "
             f"{m['num_restarts']} restarts")

    m = tr.train(dict(task, nystrom_method="chol"),
                 break_percentage=ZOO_DENSE_FRACTION,
                 str_preconditioner="lev_random")
    emit("zoo_dense", row="nystrom_method_chol", strategy="lev_random",
         iters=int(m["solver_iters"]), converged=bool(m["is_conv"]),
         build_s=tr.last_info["total_time_preconditioner"],
         max_abs_err_F_vs_analytic=check("nystrom_method=chol", m))
    if not m["is_conv"]:
        fail("zoo_dense nystrom_method=chol: not converged")


def launch_counts(reset: bool = False) -> dict:
    """Every kernel wrapper's launch count, read (and set to 0 with
    ``reset``).  The user's layers take the f64 Predictor and the f64 apply,
    as the JAX package does, so their phases read 0 for each."""
    from mlff_tpu_torch.ops import df64_gemv as dg
    from mlff_tpu_torch.ops import fused_predict as fp

    wrappers = {"fused_predict": fp.desc_forces_fused,
                "df64_bt_v": dg.df64_bt_v, "df64_b_x": dg.df64_b_x}
    counts = {name: fn.launches for name, fn in wrappers.items()}
    if reset:
        for fn in wrappers.values():
            fn.launches = 0
    return counts


def run_cli(argv, cwd) -> tuple[object, str]:
    """``cli.main(argv)`` from directory ``cwd``: its return value and what
    it printed (the progress UI and the tables), kept off this script's
    stdout, whose lines are JSON."""
    from mlff_tpu_torch import cli

    buf = io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(buf):
            out = cli.main([str(a) for a in argv])
    finally:
        os.chdir(old)
    return out, buf.getvalue()


def load_npz(path) -> dict:
    with np.load(path, allow_pickle=True) as f:
        return {k: f[k] for k in f.files}


def cli_reference(small: dict) -> None:
    """``all`` on the reference phase's small ethanol set with --device cuda
    and with --device cpu, each in its own directory: the same sigma, PCG
    iterations within 2, the test tables' force MAE within 1e-4."""
    from mlff_tpu_torch.utils import io as mio

    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ethanol_small.npz")
        mio.save_dataset(path, small)
        for d in ("cuda", "cpu"):
            wd = os.path.join(tmp, d)
            os.mkdir(wd)
            t0 = time.perf_counter()
            res, _ = run_cli(["all", path, "30", "--n-valid", "5", "--sig",
                              "10", "--solver", "cg", "--preconditioner",
                              "lev_random", "--break-percentage", "0.25",
                              "--n-test", "5", "--device", d], wd)
            (best,) = glob.glob(os.path.join(wd, "*", "best_model.npz"))
            m = load_npz(best)
            runs[d] = dict(seconds=time.perf_counter() - t0,
                           sig=float(m["sig"]), iters=int(m["solver_iters"]),
                           P=int(m["perms"].shape[0]), test=res.as_dict())
    f_cuda, f_cpu = runs["cuda"]["test"]["f_mae"], runs["cpu"]["test"]["f_mae"]
    rel = abs(f_cuda - f_cpu) / abs(f_cpu)
    emit("cli_reference", cuda=runs["cuda"], cpu=runs["cpu"],
         rel_err_f_mae=rel)
    if runs["cuda"]["sig"] != runs["cpu"]["sig"]:
        fail("cli_reference: the card and the CPU selected different sigmas")
    if abs(runs["cuda"]["iters"] - runs["cpu"]["iters"]) > CLI_ITERS_SLACK:
        fail(f"cli_reference: {runs['cuda']['iters']} PCG iterations on the "
             f"card against {runs['cpu']['iters']} on the CPU")
    if not rel <= CLI_MAE_RTOL:
        fail(f"cli_reference: test force MAE {f_cuda} on the card against "
             f"{f_cpu} on the CPU")


@contextlib.contextmanager
def timed_calls(owner, names, seconds: dict):
    """Time every call of ``owner.<name>`` into ``seconds[name]`` (a list),
    so that one run of the ``all`` verb reports each stage."""
    real = {name: getattr(owner, name) for name in names}

    def timed(name):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real[name](*args, **kwargs)
            finally:
                seconds.setdefault(name, []).append(time.perf_counter() - t0)
        return call

    for name in names:
        setattr(owner, name, timed(name))
    try:
        yield seconds
    finally:
        for name, fn in real.items():
            setattr(owner, name, fn)


def finite_table(table: dict, use_E: bool) -> bool:
    """Every error of an EvalResult finite; the energy errors are NaN by
    design when the model predicts no energies."""
    return all(np.isfinite(v) for k, v in table.items()
               if use_E or not k.startswith("e_"))


def cli_all(torch, ds_all: dict, tmp: str) -> None:
    """The user's pipeline at full width through the CLI on the card's
    default device: ``all`` (create, train both sigmas, select, test), then
    ``validate`` of each model and of best_model.npz, ``show`` and
    ``resume``."""
    from mlff_tpu_torch import cli
    from mlff_tpu_torch.utils import io as mio

    path = os.path.join(tmp, "ethanol_1466.npz")
    mio.save_dataset(path, ds_all)
    torch.cuda.reset_peak_memory_stats()
    launch_counts(reset=True)
    seconds: dict = {}
    with timed_calls(cli, ("cmd_create", "cmd_train", "cmd_select",
                           "cmd_test"), seconds), \
            timed_calls(cli.Trainer, ("train",), seconds):
        test, _ = run_cli(["all", path, str(N_TRAIN), "--n-valid",
                           str(CLI_N_VALID), "--sig", *CLI_SIGS, "--solver",
                           "cg", "--preconditioner", "lev_random",
                           "--break-percentage", CLI_BREAK, "--n-test",
                           str(CLI_N_TEST)], tmp)
    (task_dir,) = {os.path.dirname(p) for p in
                   glob.glob(os.path.join(tmp, "*", "task-sig*.npz"))}
    per_sig, valid = {}, {}
    for sig, train_s in zip(CLI_SIGS, seconds["train"]):
        name = f"model-sig{float(sig):04g}.npz"
        m = load_npz(os.path.join(task_dir, name))
        iters = int(m["solver_iters"])
        res, _ = run_cli(["validate", os.path.join(task_dir, name), path], tmp)
        valid[sig] = res.f_mae
        per_sig[sig] = dict(iters=iters, converged=bool(m["is_conv"]),
                            train_s=train_s,
                            cg_s=float(m["total_time_cg"]),
                            preconditioner_s=float(
                                m["total_time_preconditioner"]),
                            ms_per_iter=float(m["total_time_cg"]) * 1e3
                            / max(iters, 1),
                            valid_f_mae=res.f_mae)
    best_path = os.path.join(task_dir, "best_model.npz")
    best = load_npz(best_path)
    best_valid, _ = run_cli(["validate", best_path, path], tmp)
    _, shown = run_cli(["show", best_path], tmp)
    t0 = time.perf_counter()
    resumed_path, _ = run_cli(["resume", best_path, path, "--preconditioner",
                               "lev_random", "--break-percentage", CLI_BREAK],
                              tmp)
    resume_s = time.perf_counter() - t0
    resumed = load_npz(os.path.join(tmp, resumed_path))
    counts = launch_counts()
    P = int(best["perms"].shape[0])
    sig_best = f"{float(best['sig']):g}"
    table = test.as_dict()
    use_E = bool(best["use_E"])
    emit("cli_all", n=27 * N_TRAIN, P=P, k=len(best["inducing_pts_idxs"]),
         break_percentage=CLI_BREAK, create_s=sum(seconds["cmd_create"]),
         train_verb_s=sum(seconds["cmd_train"]),
         select_s=sum(seconds["cmd_select"]), test_s=sum(seconds["cmd_test"]),
         sigmas=per_sig, selected_sig=sig_best,
         best_valid_f_mae=best_valid.f_mae, test=table, use_E=use_E,
         shown_lines=len(shown.splitlines()),
         resume_new_iters=int(resumed["solver_iters"])
         - int(best["solver_iters"]),
         resume_converged=bool(resumed["is_conv"]), resume_s=resume_s,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         kernel_launches=counts)
    if not per_sig["10"]["converged"]:
        fail("cli_all: the sigma = 10 model did not converge")
    if P == 6 and per_sig["10"]["iters"] > MAX_ITERS:
        fail(f"cli_all: {per_sig['10']['iters']} PCG iterations at P = 6 > "
             f"{MAX_ITERS}")
    want = min(valid, key=valid.get)
    if sig_best != want or best_valid.f_mae != valid[want]:
        fail(f"cli_all: best_model.npz has sigma {sig_best}, validation "
             f"force MAEs {valid}")
    if table["n_points"] != CLI_N_TEST:
        fail(f"cli_all: the test table has {table['n_points']} points")
    if not (finite_table(table, use_E)
            and finite_table(best_valid.as_dict(), use_E)
            and all(np.isfinite(v) for v in valid.values())):
        fail(f"cli_all: a non-finite error in {table}")
    if not shown.startswith("model file:"):
        fail("cli_all: show did not print a model file")
    if not resumed["is_conv"]:
        fail("cli_all: the resumed solve did not converge")


def rule_of_thumb(task: dict, train_iters: int, tmp: str) -> None:
    """The paper's k-sweep on the main system through the harness, then its
    optimal-k analysis and the fit of (slope, k_unity)."""
    import pickle

    from mlff_tpu_torch.experiments import harness
    from mlff_tpu_torch.experiments import rule_of_thumb as rot

    n = int(np.asarray(task["F_train"]).size)
    launch_counts(reset=True)
    sweep = harness.minimum_preconditioner_size(
        task, "lev_random", percentages=np.array(ROT_KS) / n, out_dir=tmp)
    counts = launch_counts()
    k = np.rint(sweep["lev_random_percentage"] * n).astype(int)
    iters = sweep["lev_random_cgsteps"].astype(int)
    t_solve = sweep["lev_random_total_time_solve"]
    t_pre = sweep["lev_random_total_time_preconditioner"]
    t_cg = sweep["lev_random_total_time_cg"]
    # each k's own record, pickled in the reference's schema
    conv = {}
    for p in glob.glob(os.path.join(tmp, "**", "*.pickle"), recursive=True):
        with open(p, "rb") as f:
            rec = pickle.load(f)
        conv[int(rec["k"])] = bool(rec["is_conv"])
    opt = rot.optimal_precon_k(k, t_solve, t_pre, t_cg, n, "ethanol")
    slope, k_unity = rot.fit_slope(k, iters, n)
    paper = rot.get_params("ethanol")[:2]
    emit("rule_of_thumb", n=n, P=int(task["perms"].shape[0]),
         sig=float(task["sig"]),
         rows=[dict(k=int(a), iters=int(b), converged=conv.get(int(a)),
                    preconditioner_s=float(c), cg_s=float(d),
                    solve_s=float(e))
               for a, b, c, d, e in zip(k, iters, t_pre, t_cg, t_solve)],
         rule_of_thumb_k=rot.rule_of_thumb(n, paper[1], paper[0]),
         optimal_experimental_k=opt["optimal_experimental_k"],
         rule_of_thumb_k_specific=opt["rule_of_thumb_k_specific"],
         rule_of_thumb_factor_specific=opt["rule_of_thumb_factor_specific"],
         naive_factor=opt["naive_factor"], fitted_slope=slope,
         fitted_k_unity=k_unity, paper_slope=paper[0],
         paper_k_unity=paper[1], train_iters=train_iters,
         kernel_launches=counts)
    if list(k) != list(ROT_KS) or sorted(conv) != list(ROT_KS):
        fail(f"rule_of_thumb: the sweep ran k = {list(k)}, pickled "
             f"{sorted(conv)}")
    if not all(conv.values()):
        fail(f"rule_of_thumb: unconverged runs {conv}")
    if abs(int(iters[ROT_KS.index(K_COLUMNS)]) - train_iters) > CLI_ITERS_SLACK:
        fail(f"rule_of_thumb: k = {K_COLUMNS} took "
             f"{iters[ROT_KS.index(K_COLUMNS)]} iterations, the train phase "
             f"{train_iters}")
    s = iters[np.argsort(k)].astype(float)
    if not (s[0] > ROT_FIRST_OVER_LAST * s[-1]
            and np.mean(np.diff(s) <= 0) > ROT_NONINCREASING_SHARE):
        fail(f"rule_of_thumb: the iteration curve {list(s)} does not fall")


def benchmark_models(torch, dev, ds_all: dict) -> None:
    """Analytic against PCG at the rule-of-thumb k on cli_all's data
    through experiments.benchmark_models.train_model, both models' test
    errors by evaluate, and the analytic solve's peak device memory with
    the ridge on K's diagonal against K + reg * I formed with an identity."""
    from mlff_tpu_torch.experiments import benchmark_models as bm
    from mlff_tpu_torch.models.evaluate import evaluate
    from mlff_tpu_torch.models.gdml import Trainer
    from mlff_tpu_torch.models.predict import Predictor
    from mlff_tpu_torch.models.task import create_task
    from mlff_tpu_torch.ops import kernel as knl
    from mlff_tpu_torch.solvers import analytic as an
    from mlff_tpu_torch.utils.sampling import draw_strat_sample

    launch_counts(reset=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    m_an = bm.train_model(ds_all, N_TRAIN, "analytic")
    peak_train_an = torch.cuda.max_memory_allocated() / 1e9
    m_cg = bm.train_model(ds_all, N_TRAIN, "cg")
    err_an = evaluate(m_an, ds_all, n_points=100)
    err_cg = evaluate(m_cg, ds_all, n_points=100)
    counts = launch_counts()
    # the 100 test geometries evaluate drew
    excl = np.concatenate([m_an["idxs_train"], m_an["idxs_valid"]])
    idxs = draw_strat_sample(ds_all["E"], 100, excl_idxs=excl, seed=0)
    _, F_an = Predictor(m_an, device=dev).predict(ds_all["R"][idxs])
    _, F_cg = Predictor(m_cg, device=dev).predict(ds_all["R"][idxs])
    scale = float(np.abs(F_an).max())
    err_F = float(np.abs(F_cg - F_an).max())

    # the analytic solve alone: peak memory above the kernel cache, with the
    # ridge added to K's diagonal, then with the dense identity
    task = create_task(ds_all, N_TRAIN, ds_all,
                       n_valid=min(200, ds_all["R"].shape[0] - N_TRAIN - 1),
                       sig=SIG, solver="analytic")
    tr = Trainer(device=dev)
    spec, S, X, Jc, P_idx = tr.build_kernel_inputs(task)
    y, _, _ = tr.labels(task)
    cache = knl.build_cache(X, Jc, S, P_idx, SIG, float(task["lam"]),
                            device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    alphas = an.solve_analytic(spec, cache, y)
    solve_s = time.perf_counter() - t0
    peak_diag = (torch.cuda.max_memory_allocated() - base) / 1e9
    torch.cuda.reset_peak_memory_stats()
    K = knl.assemble_full(spec, cache)
    A = K + an.ANALYTIC_REG * torch.eye(K.shape[0], dtype=K.dtype, device=dev)
    L, info = torch.linalg.cholesky_ex(A)
    y_dev = torch.as_tensor(y, dtype=torch.float64, device=dev)
    alphas_eye = torch.cholesky_solve(y_dev[:, None], L)[:, 0].cpu().numpy()
    peak_eye = (torch.cuda.max_memory_allocated() - base) / 1e9
    del K, A, L, cache, X, Jc, S
    torch.cuda.empty_cache()
    alpha_err = float(np.abs(alphas - alphas_eye).max()
                      / np.abs(alphas_eye).max())
    n = 27 * N_TRAIN
    emit("benchmark_models", n=n, P=int(m_an["perms"].shape[0]),
         runtime_analytic_s=float(m_an["solver_runtime_s"]),
         runtime_cg_s=float(m_cg["solver_runtime_s"]),
         speedup=float(m_an["solver_runtime_s"] / m_cg["solver_runtime_s"]),
         f_mae_analytic=err_an.f_mae, f_mae_cg=err_cg.f_mae,
         cg_iters=int(m_cg["solver_iters"]),
         cg_converged=bool(m_cg["is_conv"]),
         k=len(m_cg["inducing_pts_idxs"]),
         peak_mem_gb=peak_train_an, analytic_solve_s=solve_s,
         solve_peak_mem_gb=peak_diag,
         solve_peak_mem_gb_dense_identity=peak_eye,
         saved_gb=peak_eye - peak_diag, dense_K_gb=n * n * 8 / 1e9,
         same_alphas_as_dense_identity=bool(np.array_equal(alphas,
                                                           alphas_eye)),
         rel_err_alphas_vs_dense_identity=alpha_err,
         cholesky_info=int(info),
         max_abs_err_F_cg_vs_analytic=err_F, max_abs_F=scale,
         kernel_launches=counts)
    if not (np.all(np.isfinite(F_an)) and np.all(np.isfinite(F_cg))):
        fail("benchmark_models: non-finite forces")
    if not err_F <= ANALYTIC_ATOL_REL * scale:
        fail(f"benchmark_models: the cg model's forces miss the analytic "
             f"model's by {err_F} (max |F| {scale})")
    if not alpha_err <= 1e-12:
        fail("benchmark_models: the ridge on K's diagonal changed the "
             "analytic coefficients")


def held_out_errors(model, R, E, F, dev, fast=False):
    """(force MAE, energy MAE, E_pred, F_pred) of ``model`` on R."""
    from mlff_tpu_torch.models.predict import Predictor

    E_p, F_p = Predictor(model, fast=fast, device=dev).predict(R)
    return (float(np.abs(F_p - F).mean()), float(np.abs(E_p - E).mean()),
            E_p, F_p)


def train_ecstr(torch, dev, ds, perms) -> dict:
    """Energy-constrained training at full width (n + N = 32,648, k = 1536):
    (a) the f64 apply, (b) apply_impl="df64" with the two df64 kernels on
    the (32,648, 1536) factor in every PCG iteration, (c) the df64 apply of
    the column-blocked build; then the analytic constrained solve of the
    same task, and Predictor(fast=True) on the constrained model.  Each line
    sets every kernel count to 0 before its training and reads it after.
    Returns {line: launches}."""
    from mlff_tpu_torch.models.gdml import Trainer
    from mlff_tpu_torch.models.predict import Predictor
    from mlff_tpu_torch.models.task import create_task

    task = create_task(ds, N_TRAIN, ds, n_valid=50, sig=SIG, solver="cg",
                       perms=perms, use_E_cstr=True)
    held = np.setdiff1d(np.arange(N_SAMPLES), task["idxs_train"])
    R_h, E_h, F_h = ds["R"][held], ds["E"][held], ds["F"][held]
    tr = Trainer(device=dev)
    n_ext = 27 * N_TRAIN + N_TRAIN
    lines, launches, models = {}, {}, {}
    for line, extra in (("f64", {}), ("df64", {"apply_impl": "df64"}),
                        ("colblock", {"apply_impl": "df64",
                                      "nystrom_block_cols": COLBLOCK_COLS})):
        launch_counts(reset=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = tr.train(dict(task, **extra), n_columns=K_COLUMNS,
                     str_preconditioner="lev_random")
        train_s = time.perf_counter() - t0
        counts = launch_counts()
        info = tr.last_info
        iters = int(m["solver_iters"])
        f_mae, e_mae, _, _ = held_out_errors(m, R_h, E_h, F_h, dev)
        row = dict(line=line, n=n_ext, k=len(m["inducing_pts_idxs"]),
                   components=info["nystrom"].get("components"),
                   n_blocks=info["nystrom"].get("n_blocks", 1),
                   converged=bool(m["is_conv"]), iters=iters,
                   train_s=train_s,
                   preconditioner_s=info["total_time_preconditioner"],
                   cg_s=info["total_time_cg"],
                   ms_per_iter=info["total_time_cg"] * 1e3 / max(iters, 1),
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   gram_guard_fired=info["nystrom"]["gram_guard_fired"],
                   force_mae_held_out=f_mae, energy_mae_held_out=e_mae,
                   c=float(m["c"]), **{f"launches_{line}": counts})
        emit("train_ecstr", **row)
        lines[line], launches[line], models[line] = row, counts, m
        if row["k"] != K_COLUMNS:
            fail(f"train_ecstr {line}: k = {row['k']}, not {K_COLUMNS}")
        if not m["is_conv"] or iters > ECSTR_MAX_ITERS:
            fail(f"train_ecstr {line}: converged={m['is_conv']} in {iters} "
                 f"PCG iterations (limit {ECSTR_MAX_ITERS})")
        if m["alphas_E"].shape != (N_TRAIN,) or m["c"] != float(
                np.mean(task["E_train"])):
            fail(f"train_ecstr {line}: the model lacks its energy "
                 "coefficients or its constant")
        if counts["fused_predict"]:
            fail(f"train_ecstr {line}: the fused kernel ran: {counts}")
        if line == "f64":
            if counts["df64_bt_v"] or counts["df64_b_x"]:
                fail(f"train_ecstr f64 launched a df64 kernel: {counts}")
            continue
        if min(counts["df64_bt_v"], counts["df64_b_x"]) < iters:
            fail(f"train_ecstr {line}: {counts} df64 launches for {iters} "
                 "PCG iterations")
        ref = lines["f64"]
        for key in ("force_mae_held_out", "energy_mae_held_out"):
            if not abs(row[key] / ref[key] - 1.0) <= MAE_RATIO_LIMIT:
                fail(f"train_ecstr {line}: {key} {row[key]} against "
                     f"{ref[key]} of the f64 apply")

    # the analytic constrained solve of the same task, on the card
    launch_counts(reset=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m_an = tr.train(dict(task, solver_name="analytic"))
    an_s = time.perf_counter() - t0
    solve_peak = torch.cuda.max_memory_allocated() / 1e9
    f_an, e_an, E_an, F_an = held_out_errors(m_an, R_h, E_h, F_h, dev)
    _, _, E_cg, F_cg = held_out_errors(models["f64"], R_h, E_h, F_h, dev)
    err_F = float(np.abs(F_cg - F_an).max())
    err_E = float(np.abs(E_cg - E_an).max())
    scale_F = float(np.abs(F_an).max())
    range_E = float(E_h.max() - E_h.min())
    counts = launch_counts()
    emit("train_ecstr", line="analytic", n=n_ext, train_s=an_s,
         solve_peak_mem_gb=solve_peak, dense_K_gb=n_ext * n_ext * 8 / 1e9,
         force_mae_held_out=f_an, energy_mae_held_out=e_an,
         max_abs_err_F_pcg_vs_analytic=err_F, max_abs_F=scale_F,
         max_abs_err_E_pcg_vs_analytic=err_E, held_out_E_range=range_E,
         launches_analytic=counts)
    if not (np.all(np.isfinite(F_an)) and np.all(np.isfinite(E_an))):
        fail("train_ecstr analytic: non-finite predictions")
    if not (err_F <= ANALYTIC_ATOL_REL * scale_F
            and err_E <= ANALYTIC_ATOL_REL * range_E):
        fail(f"train_ecstr: the PCG model misses the analytic model by "
             f"{err_F} in forces (max |F| {scale_F}) and {err_E} in "
             f"energies (range {range_E})")
    del m_an

    # Predictor(fast=True) on the constrained model: the JAX package's rule
    # sends it through the f64 contraction, so the fused kernel stays idle
    m = models["f64"]
    R_all = np.concatenate([R_h, task["R_train"]])
    launch_counts(reset=True)
    fast = Predictor(m, fast=True, device=dev)
    fast.predict(R_all[:8])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    E_f, F_f = fast.predict(R_all)
    ms = (time.perf_counter() - t0) * 1e3 / len(R_all)
    counts = launch_counts()
    E_s, F_s = Predictor(m, fast=False, device=dev).predict(R_all)
    same = bool(np.array_equal(E_f, E_s) and np.array_equal(F_f, F_s))
    emit("train_ecstr", line="predict_fast", geometries=len(R_all),
         routed_fast=bool(fast.fast), same_bits_as_f64=same,
         ms_per_geometry=ms, launches_predict=counts)
    if counts["fused_predict"] or fast.fast or not same:
        fail(f"train_ecstr: Predictor(fast=True) on a constrained model took "
             f"the fused kernel or other bits: {counts}, same={same}")
    launches["predict"] = counts
    return launches


def zoo_ecstr(torch, dev) -> None:
    """The constrained system at a size the dense families allow
    (N_train = 120, n + N = 3,360, k/(n + N) = 15%): the analytic solve and
    every factor and Nystrom family, each converged model held to the
    analytic model's forces and energies on training geometries."""
    from mlff_tpu_torch.data.synthetic import make_benchmark_dataset
    from mlff_tpu_torch.models.gdml import Trainer
    from mlff_tpu_torch.models.predict import Predictor
    from mlff_tpu_torch.models.task import create_task

    N = ZOO_DENSE_N_TRAIN
    ds, perms = make_benchmark_dataset("ethanol", n_samples=N + 50, seed=11,
                                       n_train=N)
    task = create_task(ds, N, ds, n_valid=min(50, N_HELD_LARGE), sig=SIG,
                       solver="cg", perms=perms, use_E_cstr=True)
    task["solver_maxiter"] = ZOO_DENSE_MAX_ITERS
    tr = Trainer(device=dev)
    R10 = np.asarray(task["R_train"])[:10]
    E_train = np.asarray(task["E_train"]).ravel()
    range_E = float(E_train.max() - E_train.min())

    t0 = time.perf_counter()
    m_an = tr.train(dict(task, solver_name="analytic"))
    E_an, F_an = Predictor(m_an, device=dev).predict(R10)
    scale = float(np.abs(F_an).max())
    emit("zoo_ecstr", row="analytic", n=28 * N,
         train_s=time.perf_counter() - t0, max_abs_F=scale,
         train_E_range=range_E)
    if not (np.all(np.isfinite(F_an)) and np.all(np.isfinite(E_an))):
        fail("zoo_ecstr: the analytic model's predictions are not finite")

    for label, strategy, extra, kw in ZOO_ECSTR:
        t0 = time.perf_counter()
        m = tr.train(dict(task, **extra), str_preconditioner=strategy,
                     **dict({"break_percentage": ZOO_DENSE_FRACTION}, **kw))
        info = tr.last_info
        E, F = Predictor(m, device=dev).predict(R10)
        err_F = float(np.abs(F - F_an).max())
        err_E = float(np.abs(E - E_an).max())
        control = strategy.startswith("eigvec_")
        emit("zoo_ecstr", row=label, strategy=strategy, n=28 * N,
             k=len(m["inducing_pts_idxs"]),
             build_s=info["total_time_preconditioner"],
             iters=int(m["solver_iters"]), converged=bool(m["is_conv"]),
             num_restarts=int(m.get("num_restarts", 0)),
             cg_s=info["total_time_cg"], train_s=time.perf_counter() - t0,
             max_abs_err_F_vs_analytic=err_F,
             max_abs_err_E_vs_analytic=err_E, control=control)
        if control:
            continue
        if not m["is_conv"]:
            fail(f"zoo_ecstr {label}: not converged in {m['solver_iters']} "
                 "iterations")
        if not (err_F <= ANALYTIC_ATOL_REL * scale
                and err_E <= ANALYTIC_ATOL_REL * range_E):
            fail(f"zoo_ecstr {label}: misses the analytic model by {err_F} "
                 f"in forces (max |F| {scale}) and {err_E} in energies "
                 f"(range {range_E})")
        if kw.get("allow_restarts") and m["num_restarts"] < 1:
            fail("zoo_ecstr allow_restarts: no restart")


def cli_ecstr(small: dict) -> None:
    """``cli.main(["all", ..., "--E-cstr"])`` on the reference phase's small
    set with --device cuda and --device cpu: the same sigma, iterations
    within 2, test force and energy MAE within 1e-4 relative.  At
    ``--tol 1e-6``, as tests/test_torch_cli.py compares two cg pipelines:
    at the default 1e-4 the card's and the CPU's solves stopped 2
    iterations apart with energy MAEs 3e-3 apart on an NVIDIA H100 80GB
    HBM3 at 700.00 W (a constrained model's energies cancel two large
    terms)."""
    from mlff_tpu_torch.utils import io as mio

    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ethanol_small.npz")
        mio.save_dataset(path, small)
        for d in ("cuda", "cpu"):
            wd = os.path.join(tmp, d)
            os.mkdir(wd)
            t0 = time.perf_counter()
            res, _ = run_cli(["all", path, "30", "--n-valid", "5", "--sig",
                              "10", "--solver", "cg", "--preconditioner",
                              "lev_random", "--break-percentage", "0.25",
                              "--tol", "1e-6", "--n-test", "5", "--E-cstr",
                              "--device", d], wd)
            (best,) = glob.glob(os.path.join(wd, "*", "best_model.npz"))
            m = load_npz(best)
            runs[d] = dict(seconds=time.perf_counter() - t0,
                           sig=float(m["sig"]), iters=int(m["solver_iters"]),
                           has_alphas_E="alphas_E" in m, test=res.as_dict())
    rel = {f: abs(runs["cuda"]["test"][f] - runs["cpu"]["test"][f])
           / abs(runs["cpu"]["test"][f]) for f in ("f_mae", "e_mae")}
    emit("cli_ecstr", cuda=runs["cuda"], cpu=runs["cpu"],
         rel_err_f_mae=rel["f_mae"], rel_err_e_mae=rel["e_mae"])
    if not (runs["cuda"]["has_alphas_E"] and runs["cpu"]["has_alphas_E"]):
        fail("cli_ecstr: a model without energy coefficients")
    if runs["cuda"]["sig"] != runs["cpu"]["sig"]:
        fail("cli_ecstr: the card and the CPU selected different sigmas")
    if abs(runs["cuda"]["iters"] - runs["cpu"]["iters"]) > CLI_ITERS_SLACK:
        fail(f"cli_ecstr: {runs['cuda']['iters']} PCG iterations on the card "
             f"against {runs['cpu']['iters']} on the CPU")
    if not max(rel.values()) <= CLI_MAE_RTOL:
        fail(f"cli_ecstr: test MAEs part by {rel} between card and CPU")


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def norm_rel(got, want) -> float:
    """||got - want|| / ||want|| (tests/test_ozaki.py's measure)."""
    return float((got - want).norm() / want.norm())


class _LogLines(logging.Handler):
    """Collects the messages of one logger while it is attached."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def precision(torch, dev, tr, task, ds, held, ref: dict) -> None:
    """Phase precision: every arithmetic option of the solve on the main
    task, against the train phase's f64 solve (``ref``: its iterations,
    lam, inducing columns, build seconds and the f64 Predictor's held-out
    force MAE); then the n = 157,491 OTF matvecs and the split factor's
    Gram under both build engines, and IR-CG on zoo_dense's system.  One
    line per part, each with the card's name and power limit."""
    from mlff_tpu_torch.data.synthetic import make_benchmark_dataset
    from mlff_tpu_torch.models.predict import Predictor
    from mlff_tpu_torch.models.task import create_task
    from mlff_tpu_torch.ops import kernel as knl
    from mlff_tpu_torch.solvers import ir_cg
    from mlff_tpu_torch.solvers import preconditioners as pc

    card_ = card()
    t_phase = time.perf_counter()
    spec, S, X, Jc, P_idx = tr.build_kernel_inputs(task)
    lam = ref["lam"]
    cache = knl.build_cache(X, Jc, S, P_idx, SIG, lam, device=dev)
    y_dev = torch.as_tensor(tr.labels(task)[0], device=dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    v = torch.randn(cache.n, generator=gen, dtype=torch.float64, device=dev)
    Kv = knl.matvec_psd(cache, v)
    f64_ms = time_ms(torch, lambda: knl.matvec_psd(cache, v))

    def trained(extra: dict) -> tuple[dict, dict]:
        """Train the main task with ``extra`` task fields; the model and its
        numbers (the true f64 residual of its coefficients included)."""
        t0 = time.perf_counter()
        m = tr.train(dict(task, **extra), n_columns=K_COLUMNS,
                     str_preconditioner="lev_random")
        train_s = time.perf_counter() - t0
        info = tr.last_info
        iters = int(m["solver_iters"])
        _, F = Predictor(m, device=dev).predict(ds["R"][held])
        x = torch.as_tensor(-np.asarray(m["alphas_F"]).ravel(), device=dev)
        r = knl.matvec_psd(dataclasses.replace(cache, lam=float(m["lam"])),
                           x) - y_dev
        return m, dict(
            converged=bool(m["is_conv"]), iters=iters,
            train_iters=ref["iters"], train_s=train_s,
            preconditioner_s=info["total_time_preconditioner"],
            cg_s=info["total_time_cg"],
            ms_per_iter=info["total_time_cg"] * 1e3 / max(iters, 1),
            true_resid=float(r.norm() / y_dev.norm()),
            force_mae_held_out=float(np.abs(F - ds["F"][held]).mean()),
            force_mae_held_out_f64=ref["mae"])

    def mae_ok(row) -> bool:
        return abs(row["force_mae_held_out"] / ref["mae"] - 1.0) \
            <= MAE_RATIO_LIMIT

    # (a) matvec_dtype="ozaki"
    state = knl.ozaki_matvec_state(cache)
    row_a = dict(part="a_matvec_ozaki", card=card_, n=cache.n,
                 rel_err_matvec_vs_f64=norm_rel(
                     knl.matvec_psd_ozaki(state, v), Kv),
                 matvec_ms=time_ms(torch, lambda: knl.matvec_psd_ozaki(
                     state, v), reps=5),
                 matvec_f64_ms=f64_ms,
                 state_digit_bytes=sum(
                     d.numel() * d.element_size()
                     for sl in (state.Xq_sl, state.Xqt_sl, state.Ae1_sl)
                     for d in sl[1]))
    del state
    m, row = trained({"matvec_dtype": "ozaki"})
    ok_fast, errF, errE, max_F, _ = fast_against_f64(m, ds["R"][held], dev)
    row_a.update(row, fast_max_abs_err_F_vs_f64=errF,
                 fast_max_abs_err_E_vs_f64=errE, max_abs_F=max_F)
    emit("precision", **row_a)
    if not row_a["rel_err_matvec_vs_f64"] <= PRECISION_MATVEC_RTOL:
        fail("precision (a): the Ozaki matvec misses the f64 one by "
             f"{row_a['rel_err_matvec_vs_f64']}")
    if not (row_a["converged"] and row_a["iters"] <= MAX_ITERS
            and mae_ok(row_a) and ok_fast):
        fail(f"precision (a): the Ozaki-matvec training: {row_a}")

    # (b) apply_impl="ozaki"
    P64 = pc.nystrom_preconditioner(spec, cache, ref["inducing"], lam)
    Poz = pc.ozaki_from_split(pc.WoodburySplitPreconditioner(
        B=P64.B.clone(), W2=P64.W2, lam=P64.lam, info=P64.info))
    row_b = dict(part="b_apply_ozaki", card=card_, n=cache.n,
                 m=P64.B.shape[1],
                 rel_err_apply_vs_f64=norm_rel(Poz(v), P64(v)),
                 apply_ms=time_ms(torch, lambda: Poz(v)),
                 apply_f64_ms=time_ms(torch, lambda: P64(v)),
                 digit_bytes=Poz.info["digit_bytes"],
                 digit_bytes_over_B_bytes=Poz.info["digit_bytes"]
                 / (P64.B.numel() * 8))
    del P64, Poz
    _, row = trained({"apply_impl": "ozaki"})
    row_b.update(row)
    emit("precision", **row_b)
    if not row_b["rel_err_apply_vs_f64"] <= PRECISION_APPLY_RTOL:
        fail("precision (b): the Ozaki apply misses the f64 one by "
             f"{row_b['rel_err_apply_vs_f64']}")
    if not (row_b["converged"] and abs(row_b["iters"] - ref["iters"])
            <= PRECISION_ITERS_SLACK and mae_ok(row_b)):
        fail(f"precision (b): the Ozaki-apply training: {row_b}")

    # (c) MLFF_BUILD_GEMM=ozaki, read once per process: set, reset, restore
    saved = os.environ.get("MLFF_BUILD_GEMM"), pc._BUILD_GEMM_MODE
    os.environ["MLFF_BUILD_GEMM"] = "ozaki"
    pc._BUILD_GEMM_MODE = None
    try:
        _, row = trained({})
        ny = tr.last_info["nystrom"]
    finally:
        if saved[0] is None:
            os.environ.pop("MLFF_BUILD_GEMM", None)
        else:
            os.environ["MLFF_BUILD_GEMM"] = saved[0]
        pc._BUILD_GEMM_MODE = saved[1]
    row_c = dict(part="c_build_ozaki", card=card_, n=cache.n, **row,
                 build_gemm=ny["build_gemm"],
                 gram_guard_fired=ny["gram_guard_fired"],
                 gram_probe_err=ny["gram_probe_err"],
                 factorization_s=ny["factorization_s"],
                 factorization_f64_s=ref["factorization_s"],
                 gram_probe_err_f64=ref["gram_probe_err"],
                 nystrom_stages=ny["stages"])
    emit("precision", **row_c)
    if not (row_c["build_gemm"] == "ozaki" and not row_c["gram_guard_fired"]
            and row_c["converged"] and abs(row_c["iters"] - ref["iters"])
            <= PRECISION_ITERS_SLACK and mae_ok(row_c)):
        fail(f"precision (c): the Ozaki-built training: {row_c}")

    # (d) the reduced-precision matvecs, on the calibrated system where the
    # JAX package records divergence: they must terminate and stay honest
    for dtype, mv in (("mixed", lambda: knl.matvec_psd_mixed(cache, v)),
                      ("float32", lambda: knl.matvec_psd(
                          knl.downcast_cache(cache), v))):
        rel = norm_rel(mv(), Kv)
        _, row = trained({"matvec_dtype": dtype,
                          "solver_maxiter": 3 * ref["iters"]})
        row_d = dict(part=f"d_matvec_{dtype}", card=card_, n=cache.n,
                     rel_err_matvec_vs_f64=rel, solver_maxiter=3
                     * ref["iters"], **row)
        emit("precision", **row_d)
        if row_d["converged"] and not row_d["true_resid"] \
                <= PRECISION_RESID_LIMIT:
            fail(f"precision (d): {dtype} reports convergence with a true "
                 f"residual of {row_d['true_resid']}")
    del Kv

    # (e) n = 157,491 on the OTF cache: the matvecs and the Gram engines
    molecule, n_train, k = PRECISION_157K
    ds_l, perms_l = make_benchmark_dataset(
        molecule, n_samples=n_train + N_HELD_LARGE, seed=11, n_train=n_train)
    task_l = create_task(ds_l, n_train, ds_l, n_valid=50, sig=SIG,
                         solver="cg", perms=perms_l)
    spec_l, S, X, Jc, P_idx = tr.build_kernel_inputs(task_l)
    otf = knl.build_cache(X, Jc, S, P_idx, SIG, lam, pairwise=False,
                          device=dev)
    del X, Jc, S
    v = torch.randn(otf.n, generator=gen, dtype=torch.float64, device=dev)
    Kv = knl.matvec_psd(otf, v)
    state = knl.ozaki_matvec_state(otf)
    row_e = dict(part="e_157k", card=card_, n=otf.n, N_train=n_train, k=k,
                 otf_tile=knl._otf_tile(n_train, otf.Xqt.shape[0]),
                 rel_err_ozaki_otf_vs_f64=norm_rel(
                     knl.matvec_psd_ozaki(state, v), Kv),
                 rel_err_mixed_otf_vs_f64=norm_rel(
                     knl.matvec_psd_mixed(otf, v), Kv),
                 matvec_ozaki_otf_ms=time_ms(
                     torch, lambda: knl.matvec_psd_ozaki(state, v), reps=2),
                 matvec_f64_otf_ms=time_ms(
                     torch, lambda: knl.matvec_psd(otf, v), reps=3))
    del state, Kv
    rng = np.random.default_rng(0)
    lev, order = pc.leverage_scores(spec_l, otf, lam,
                                    int(np.ceil(k / otf.n * n_train)), rng)
    idx = pc.select_by_leverage("lev_random", lev, order, k, rng)
    K_nm = knl.assemble_columns(spec_l, otf, idx)
    W1 = torch.as_tensor(pc._host_whiten_factor(
        pc._host_sym(K_nm[torch.as_tensor(idx, device=dev)]), 1e-10, "chol"),
        device=dev)
    B = K_nm @ W1
    del K_nm, W1, otf
    for impl in ("f64", "ozaki"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner = pc._gram(B, impl)
        torch.cuda.synchronize()
        row_e[f"gram_{impl}_s"] = time.perf_counter() - t0
        row_e[f"gram_probe_err_{impl}"] = pc._gram_probe(
            B, pc._host_sym(inner))
        del inner
    del B
    torch.cuda.empty_cache()
    emit("precision", **row_e)
    if not row_e["rel_err_ozaki_otf_vs_f64"] <= PRECISION_MATVEC_RTOL:
        fail("precision (e): the Ozaki OTF matvec misses the f64 one by "
             f"{row_e['rel_err_ozaki_otf_vs_f64']}")
    if not max(row_e["gram_probe_err_f64"], row_e["gram_probe_err_ozaki"]) \
            <= max(0.1 * lam, 1e-12):
        fail(f"precision (e): a Gram fails the build's guard: {row_e}")

    # (f) the memory-ceiling switch on the main task's 0.39 GB factor
    saved = os.environ.get(CEILING_ENV)
    os.environ[CEILING_ENV] = PRECISION_CEILING_GB
    lines = _LogLines()
    pc.log.addHandler(lines)
    try:
        _, row = trained({})
        ny = tr.last_info["nystrom"]
    finally:
        pc.log.removeHandler(lines)
        if saved is None:
            os.environ.pop(CEILING_ENV, None)
        else:
            os.environ[CEILING_ENV] = saved
    switch = [ln for ln in lines.lines if "using column blocks of" in ln]
    row_f = dict(part="f_memory_ceiling", card=card_,
                 ceiling_gb=float(PRECISION_CEILING_GB),
                 factor_gb=27 * N_TRAIN * K_COLUMNS * 8 / 1e9,
                 block_cols=ny.get("block_cols"), n_blocks=ny.get("n_blocks"),
                 log_line=switch[0] if switch else None, **row)
    emit("precision", **row_f)
    if not (row_f["block_cols"] == 512 and switch
            and switch[0].endswith("column blocks of 512")
            and row_f["converged"] and abs(row_f["iters"] - ref["iters"])
            <= PRECISION_ITERS_SLACK):
        fail(f"precision (f): the ceiling switch: {row_f}")

    # (g) IR-CG on zoo_dense's system: converges at lam = 1e-6 within
    # IR_MAX_OUTER steps, reports the f32 floor at lam = 1e-10
    N = ZOO_DENSE_N_TRAIN
    ds_z, perms_z = make_benchmark_dataset("ethanol", n_samples=N + 50,
                                           seed=11, n_train=N)
    task_z = create_task(ds_z, N, ds_z, n_valid=50, sig=SIG, solver="cg",
                         perms=perms_z)
    spec_z, S, X, Jc, P_idx = tr.build_kernel_inputs(task_z)
    b = torch.as_tensor(tr.labels(task_z)[0], device=dev)
    for lam_ir, kw, want in ((1e-6, {"inner_maxiter": 300}, True),
                             (1e-10, {"inner_maxiter": 100, "max_outer": 3},
                              False)):
        c = knl.build_cache(X, Jc, S, P_idx, SIG, lam_ir, device=dev)
        idx = pc.select_random(c.n, c.n // 8, np.random.default_rng(0))
        P = pc.nystrom_preconditioner(spec_z, c, idx, lam_ir)
        res = ir_cg.ir_pcg_kernel(spec_z, c, b, P.fused_T(), lam_ir,
                                  tol=1e-4, inner_tol=1e-2, **kw)
        emit("precision", part="g_ir_cg", card=card_, n=c.n, lam=lam_ir,
             converged=res.converged, outer_iters=res.outer_iters,
             inner_iters_total=res.inner_iters_total, resid=res.resid,
             time_s=res.time_s)
        if res.converged != want or res.outer_iters > (
                IR_MAX_OUTER if want else kw["max_outer"]):
            fail(f"precision (g): IR-CG at lam = {lam_ir}: converged="
                 f"{res.converged} in {res.outer_iters} outer steps")
    emit("precision", part="phase", card=card_,
         seconds=time.perf_counter() - t_phase)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs the port on the card only",
              file=sys.stderr)
        sys.exit(2)

    from mlff_tpu_torch import resolve_device
    from mlff_tpu_torch.data.synthetic import (
        benchmark_perms, make_benchmark_dataset, make_dataset)
    from mlff_tpu_torch.models.gdml import Trainer
    from mlff_tpu_torch.models.predict import Predictor
    from mlff_tpu_torch.models.task import create_task
    from mlff_tpu_torch.ops import cuda_build
    from mlff_tpu_torch.ops import descriptor as dsc
    from mlff_tpu_torch.ops import df64_gemv as dg
    from mlff_tpu_torch.ops import fused_predict as fp
    from mlff_tpu_torch.ops import kernel as knl

    dev = resolve_device("cuda")

    # -- build -------------------------------------------------------------
    sources = ["fused_predict", "df64_gemv"]
    t0 = time.perf_counter()
    reports = cuda_build.build(sources)
    build_s = time.perf_counter() - t0
    emit("build", seconds=build_s, kernels=sources,
         ptxas=[ln for r in reports.values()
                for ln in cuda_build.ptxas_lines(r)],
         # queries per block, threads, shared bytes, resident blocks per SM
         fused_predict_geometry={g.width: fp.library_geometry(
             fp._library(), g.width) for g in fp.GEOMETRIES},
         # queries, rows / columns per tile, depth, threads, shared bytes and
         # resident blocks per SM of the two passes
         fused_predict_wide_geometry=fp.library_wide_geometry(fp._library()))
    spills = [ln for r in reports.values() for ln in cuda_build.spill_lines(r)]
    if spills:
        fail(f"ptxas reports spills: {spills}")

    # -- kernel ------------------------------------------------------------
    ds, perms = make_benchmark_dataset("ethanol", n_samples=N_SAMPLES,
                                       seed=11, n_train=N_TRAIN)
    task = create_task(ds, N_TRAIN, ds, n_valid=50, sig=SIG, solver="cg",
                       perms=perms)
    tr = Trainer(device=dev)
    spec, S, X, Jc, P_idx = tr.build_kernel_inputs(task)
    cache = knl.build_cache(X, Jc, S, P_idx, SIG, 1e-10, device=dev)
    rng = np.random.default_rng(1)
    w = torch.as_tensor(rng.normal(size=(N_TRAIN, spec.dim)), device=dev)
    wt = knl.perm_expand_w(w, cache.P_idx).contiguous()
    Xqt = cache.Xqt.contiguous()
    held = np.setdiff1d(np.arange(N_SAMPLES), task["idxs_train"])
    X_held, _ = dsc.descriptors_from_R(
        spec, torch.as_tensor(ds["R"][held], dtype=torch.float64, device=dev))
    fused_rows = fused_predict_rows(torch, cache.Xq[:512], Xqt, wt,
                                    (knl.SQRT5 / SIG) * X_held)
    del cache, w, wt, Xqt
    wide_rows = fused_wide_rows(torch)
    df64_rows = df64_kernel_rows(torch)

    # -- reference: the card against the CPU on a small training ------------
    small = make_dataset("ethanol", n_samples=40, seed=3)
    small["z"] = np.asarray([6, 6, 8, 1, 1, 1, 1, 1, 1])
    stask = create_task(small, 30, small, n_valid=5, sig=SIG, solver="cg",
                        perms=benchmark_perms("ethanol"))
    held_s = np.setdiff1d(np.arange(40), stask["idxs_train"])
    for apply_impl in ("xla", "df64"):
        preds = {}
        for d in ("cuda", "cpu"):
            m = Trainer(device=d).train(dict(stask, apply_impl=apply_impl),
                                        n_columns=200,
                                        str_preconditioner="lev_random")
            preds[d] = (m["solver_iters"],) + Predictor(m, device=d).predict(
                small["R"][held_s])
        scale = np.abs(preds["cpu"][2]).max()
        err = float(np.abs(preds["cuda"][2] - preds["cpu"][2]).max() / scale)
        emit("reference", apply_impl=apply_impl, iters_cuda=preds["cuda"][0],
             iters_cpu=preds["cpu"][0], rel_err_F=err)
        if abs(preds["cuda"][0] - preds["cpu"][0]) > 2 or not err <= 1e-4:
            fail(f"the small training on the card disagrees with the CPU "
                 f"port (apply_impl={apply_impl})")

    # -- train: the main path ----------------------------------------------
    fp.desc_forces_fused.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = tr.train(task, n_columns=K_COLUMNS, str_preconditioner="lev_random")
    train_s = time.perf_counter() - t0
    info = tr.last_info
    n = int(np.asarray(task["F_train"]).size)
    emit("train", n=n, k=K_COLUMNS, P=int(perms.shape[0]),
         cache_build_s=info["cache_build_s"],
         preconditioner_s=info["total_time_preconditioner"],
         cg_s=info["total_time_cg"], train_s=train_s,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         iters=int(model["solver_iters"]), jax_f64_iters=JAX_F64_ITERS,
         converged=bool(model["is_conv"]),
         gram_guard_fired=info["nystrom"]["gram_guard_fired"],
         gram_probe_err=info["nystrom"]["gram_probe_err"],
         nystrom_stages=info["nystrom"]["stages"])
    train_ref = dict(iters=int(model["solver_iters"]), lam=float(model["lam"]),
                     inducing=np.asarray(model["inducing_pts_idxs"]),
                     factorization_s=info["nystrom"]["factorization_s"],
                     gram_probe_err=info["nystrom"]["gram_probe_err"])
    if not model["is_conv"]:
        fail("the PCG solve did not converge")
    if model["solver_iters"] > MAX_ITERS:
        fail(f"{model['solver_iters']} PCG iterations > {MAX_ITERS}")

    # -- predict: through the fused kernel ---------------------------------
    fast = Predictor(model, fast=True, device=dev)
    t0 = time.perf_counter()
    E_h, F_h = fast.predict(ds["R"][held])
    t1 = time.perf_counter()
    E_t, F_t = fast.predict(task["R_train"])
    t2 = time.perf_counter()
    launches = fp.desc_forces_fused.launches
    if launches == 0:
        fail("Predictor(fast=True) did not launch the fused kernel")
    exact = Predictor(model, fast=False, device=dev)
    E_h64, F_h64 = exact.predict(ds["R"][held])
    t3 = time.perf_counter()
    E_t64, F_t64 = exact.predict(task["R_train"])
    t4 = time.perf_counter()
    F_all, F_all64 = np.concatenate([F_h, F_t]), np.concatenate([F_h64, F_t64])
    E_all, E_all64 = np.concatenate([E_h, E_t]), np.concatenate([E_h64, E_t64])
    okF, errF = close(F_all, F_all64, np.abs(F_all64).max())
    E_c = E_all64 - model["c"]
    okE, errE = close(E_all - model["c"], E_c, np.abs(E_c).max())
    shapes_ok = F_h.shape == (len(held), 9, 3) and E_t.shape == (N_TRAIN,)
    finite = bool(np.all(np.isfinite(F_all)) and np.all(np.isfinite(E_all)))
    mae = float(np.abs(F_h - ds["F"][held]).mean())
    emit("predict", launches=launches, held_out=len(held),
         force_mae_held_out=mae,
         max_abs_err_F_vs_f64=errF, max_abs_err_E_vs_f64=errE,
         max_abs_F=float(np.abs(F_all64).max()),
         f32_contraction_rel_err=f32_contraction_error(
             torch, exact, ds["R"][held]),
         ms_per_geometry_held_out=(t1 - t0) * 1e3 / len(held),
         ms_per_geometry_train=(t2 - t1) * 1e3 / N_TRAIN,
         ms_per_geometry_train_f64_plain=(t4 - t3) * 1e3 / N_TRAIN,
         use_E=bool(model["use_E"]),
         ok=okF and okE and shapes_ok and finite)
    if not (okF and okE and shapes_ok and finite):
        fail("Predictor(fast=True) disagrees with the f64 Predictor")

    # -- train_otf: the main shape on the on-the-fly matvec ------------------
    launches_new = {"train_otf": train_otf(
        torch, dev, task, ds, held, {"iters": int(model["solver_iters"]),
                                     "cg_s": info["total_time_cg"]}, mae)}

    # -- train_df64, train_colblock_df64: the df64 apply path ---------------
    mae_xla = float(np.abs(F_h64 - ds["F"][held]).mean())
    df64_launches = {}
    for phase, extra, components in (
            ("train_df64", {}, 3),
            ("train_colblock_df64", {"nystrom_block_cols": COLBLOCK_COLS}, 2)):
        dg.df64_bt_v.launches = 0
        dg.df64_b_x.launches = 0
        t0 = time.perf_counter()
        m_df = tr.train(dict(task, apply_impl="df64", **extra),
                        n_columns=K_COLUMNS, str_preconditioner="lev_random")
        train_s = time.perf_counter() - t0
        launches_df = {"df64_bt_v": dg.df64_bt_v.launches,
                       "df64_b_x": dg.df64_b_x.launches}
        info = tr.last_info
        iters = int(m_df["solver_iters"])
        _, F_df = Predictor(m_df, device=dev).predict(ds["R"][held])
        mae = float(np.abs(F_df - ds["F"][held]).mean())
        emit(phase, n=n, k=K_COLUMNS, components=info["nystrom"]["components"],
             n_blocks=info["nystrom"].get("n_blocks", 1),
             converged=bool(m_df["is_conv"]), iters=iters,
             xla_iters=int(model["solver_iters"]),
             cg_s=info["total_time_cg"],
             ms_per_iter=info["total_time_cg"] * 1e3 / max(iters, 1),
             preconditioner_s=info["total_time_preconditioner"],
             train_s=train_s, launches=launches_df,
             gram_guard_fired=info["nystrom"]["gram_guard_fired"],
             gram_probe_err=info["nystrom"]["gram_probe_err"],
             force_mae_held_out=mae, force_mae_held_out_xla=mae_xla)
        if info["nystrom"]["components"] != components:
            fail(f"{phase} built {info['nystrom']['components']} components, "
                 f"not {components}")
        if not m_df["is_conv"] or iters > MAX_ITERS:
            fail(f"{phase}: converged={m_df['is_conv']} in {iters} PCG "
                 f"iterations (limit {MAX_ITERS})")
        if min(launches_df.values()) == 0:
            fail(f"{phase} did not launch both df64 kernels: {launches_df}")
        if not (np.all(np.isfinite(F_df))
                and abs(mae / mae_xla - 1.0) <= MAE_RATIO_LIMIT):
            fail(f"{phase}: held-out force MAE {mae} against {mae_xla} of the "
                 "f64 model")
        df64_launches[phase] = launches_df

    # -- zoo_full, zoo_dense: the rest of the preconditioner zoo -------------
    zoo_launches = zoo_full(torch, tr, task, ds, held, mae_xla, (fp, dg))
    zoo_dense(torch, dev)

    # -- train_157k, train_aspirin, train_catcher, nanotube: large systems ---
    for phase, molecule, n_train, k, limit in LARGE:
        launches_new[phase] = large_system(torch, dev, phase, molecule,
                                           n_train, k, limit)
    launches_new["nanotube"] = nanotube(torch, dev)

    # -- cli_reference, cli_all, rule_of_thumb, benchmark_models: the layers
    # a user meets, through their entry points on the card ------------------
    cli_reference(small)
    ds_all, _ = make_benchmark_dataset("ethanol", n_samples=CLI_N_SAMPLES,
                                       seed=11, n_train=N_TRAIN)
    with tempfile.TemporaryDirectory() as tmp:
        cli_all(torch, ds_all, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        rule_of_thumb(task, int(model["solver_iters"]), tmp)
    benchmark_models(torch, dev, ds_all)

    # -- train_ecstr, zoo_ecstr, cli_ecstr: energy constraints ---------------
    ecstr = train_ecstr(torch, dev, ds, perms)
    zoo_ecstr(torch, dev)
    cli_ecstr(small)

    # -- precision: the arithmetic options of the solve ----------------------
    precision(torch, dev, tr, task, ds, held, dict(train_ref, mae=mae_xla))

    full = fused_rows["full"]
    kernels = [{
        "name": "fused_predict", "route": "cuda",
        "source": "mlff_tpu_torch/csrc/fused_predict.cu",
        "replaces": "mlff_tpu/ops/pallas_predict.py:52",
        "launches": launches, "launches_zoo_full": zoo_launches["fused_predict"],
        "launches_train_otf": launches_new["train_otf"],
        "launches_train_157k": launches_new["train_157k"],
        "launches_train_ecstr_predict": ecstr["predict"]["fused_predict"],
        "max_abs_err": full["max_abs_err_F"],
        "ms": full["ms"], "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
        "library_ms": None, "ms_spread": full["ms_spread"],
        "share_of_bound": full["share_of_bound"]}]
    wide = wide_rows["aspirin"]
    kernels.append({
        "name": "fused_predict_wide", "route": "cuda",
        "source": "mlff_tpu_torch/csrc/fused_predict.cu",
        "replaces": "mlff_tpu/ops/pallas_predict.py:52",
        "launches": launches_new["train_aspirin"],
        "launches_train_catcher": launches_new["train_catcher"],
        "launches_nanotube": launches_new["nanotube"],
        "max_abs_err": wide["max_abs_err_F"],
        "ms": wide["ms"], "plain_ms": wide["plain_ms"],
        "bound_ms": wide["bound_ms"], "bound_by": wide["bound_by"],
        "library_ms": None, "ms_spread": wide["ms_spread"],
        "share_of_bound": wide["share_of_bound"],
        "ms_by_shape": {k: v["ms"] for k, v in wide_rows.items()}})
    for name, line in (("df64_bt_v", 41), ("df64_b_x", 118)):
        main_row = df64_rows[(name, "main")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mlff_tpu_torch/csrc/df64_gemv.cu",
            "replaces": f"mlff_tpu/ops/pallas_df64.py:{line}",
            "launches": df64_launches["train_df64"][name],
            "launches_zoo_full": zoo_launches[name],
            "launches_train_ecstr_df64": ecstr["df64"][name],
            "launches_train_ecstr_colblock": ecstr["colblock"][name],
            "ecstr_shape": {k: df64_rows[(name, "ecstr")][k] for k in (
                "n", "m", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "library_ms", "share_of_bound")},
            "max_abs_err": main_row["max_abs_err"],
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "ms_spread": main_row["ms_spread"],
            "library_ms_spread": main_row["library_ms_spread"],
            "vs_library": main_row["vs_library"],
            "share_of_bound": main_row["share_of_bound"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
