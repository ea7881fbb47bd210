#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``mlff_tpu_torch``) once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line of its own numbers:

  build      compile every CUDA kernel from csrc/, one nvcc per source, all
             at once; ptxas's registers and spills (a spill in a df64 kernel
             fails the run)
  kernel     each kernel against its plain PyTorch version on the card, at
             the main path's full shape and at a ragged one; times, bound.
             The df64 passes also at a second ragged shape with several
             slabs (4099 x 1030) and at the shape the JAX package profiled
             them at (75,006 x 3840), at every shape against the f64 cuBLAS
             product of the unsplit B; at the two large shapes kernel and
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

Then the kernel table as one JSON line, the card's name and power limit as
nvidia-smi reports them, and as the last line
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Any failed phase
exits non-zero without that line; without a CUDA card the script exits
non-zero before any phase.
"""

from __future__ import annotations

import json
import subprocess
import sys
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
DF64_SHAPES = (("main", 31482, K_COLUMNS), ("ragged", 1001, 130),
               ("ragged_slabs", 4099, 1030), ("profiled", 75006, 3840))
DF64_TIMED = ("main", "profiled")
DF64_RTOL = 3e-12
COLBLOCK_COLS = 512     # 3 column blocks of the k = 1536 factor
# a df64 model and the f64 model of the same task, both converged to the
# same tolerance, predict held-out forces of the same quality: their force
# MAEs agree within 10%, which still catches a broken solve
MAE_RATIO_LIMIT = 0.1


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
    from mlff_tpu_torch.ops import df64_gemv as dg
    from mlff_tpu_torch.ops import fused_predict as fp
    from mlff_tpu_torch.ops import kernel as knl

    dev = resolve_device("cuda")

    # -- build -------------------------------------------------------------
    sources = ["fused_predict", "df64_gemv"]
    t0 = time.perf_counter()
    reports = cuda_build.build(sources)
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for r in reports.values() for ln in r.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    emit("build", seconds=build_s, kernels=sources, ptxas=ptxas)
    spills = [ln.strip() for ln in reports.get("df64_gemv", "").splitlines()
              if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads"
              not in ln]
    if spills:
        fail(f"ptxas reports spills in a df64 kernel: {spills}")

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
    rows = []
    for label, B in (("full", 512), ("ragged", 7)):
        Xq = cache.Xq[:B].contiguous()
        Mr = Xqt.shape[0] if label == "full" else Xqt.shape[0] - 37
        args = (Xq, Xqt[:Mr].contiguous(), wt[:Mr].contiguous(), SIG)
        F_k, E_k = fp.desc_forces_fused(*args)
        F_r, E_r = fp.desc_forces_fused_ref(*args)
        torch.cuda.synchronize()
        F_k, E_k, F_r, E_r = (t.cpu().numpy() for t in (F_k, E_k, F_r, E_r))
        okF, errF = close(F_k, F_r, np.abs(F_r).max())
        okE, errE = close(E_k, E_r, np.abs(E_r).max())
        row = {"shape": label, "B": B, "M": Mr, "D": spec.dim,
               "max_abs_err_F": errF, "max_abs_err_E": errE,
               "max_abs_F": float(np.abs(F_r).max()), "ok": okF and okE}
        if label == "full":
            row["ms"] = time_ms(torch, lambda: fp.desc_forces_fused(*args))
            # the f64 Gram distances alone, the part of "ms" outside the
            # hand-written kernels
            row["dist_ms"] = time_ms(
                torch, lambda: knl.pairwise_dist_gram(args[0], args[1]))
            row["plain_ms"] = time_ms(
                torch, lambda: fp.desc_forces_fused_ref(*args))
            bound_s, bound_by = fp.bound_seconds(B, Mr, spec.dim, F64_PEAK,
                                                 MEM_RATE)
            row["bound_ms"] = bound_s * 1e3
            row["bound_by"] = bound_by
        rows.append(row)
        emit("kernel", name="fused_predict", **row)
        if not row["ok"]:
            fail(f"fused_predict disagrees with its plain version ({label})")
    del cache, w, wt, Xqt
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
    if not model["is_conv"]:
        fail("the PCG solve did not converge")
    if model["solver_iters"] > MAX_ITERS:
        fail(f"{model['solver_iters']} PCG iterations > {MAX_ITERS}")

    # -- predict: through the fused kernel ---------------------------------
    held = np.setdiff1d(np.arange(N_SAMPLES), task["idxs_train"])
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

    full = rows[0]
    kernels = [{
        "name": "fused_predict", "route": "cuda",
        "source": "mlff_tpu_torch/csrc/fused_predict.cu",
        "replaces": "mlff_tpu/ops/pallas_predict.py:52",
        "launches": launches, "max_abs_err": full["max_abs_err_F"],
        "ms": full["ms"], "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
        "library_ms": None}]
    for name, line in (("df64_bt_v", 41), ("df64_b_x", 118)):
        main_row = df64_rows[(name, "main")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mlff_tpu_torch/csrc/df64_gemv.cu",
            "replaces": f"mlff_tpu/ops/pallas_df64.py:{line}",
            "launches": df64_launches["train_df64"][name],
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
