"""The port's measurement tools (``mlff_tpu_torch/tools/``: bench,
bench_time_to_solution, bench_k_sweep_31k, bench_scaling,
bench_molecule_table, bench_nanotube, run_500k) on the CPU at a small size.

Each tool runs with ``--device cpu``, its size cut through the test-only
keyword or its own ``--n-train``.  The tools that train the benchmark
workload (calibrated ethanol, P = 6, sigma = 10) are held to
``mlff_tpu.models.gdml.Trainer`` on the same task: the same inducing
columns and iterations within 2 (``tests/test_torch_train_e2e.py``'s rule)
or 3%, whichever is more: at k = 128 (the molecule table's k at this n) a
one-ulp change of one force label moves the JAX package's own count from
314 to 310, and the port counts 310.
Every tool's line has the keys of the root tool it ports, minus the TPU-only
ones, plus ``device``; device numbers are null on the CPU.  The copies of
the root tools' reference constants equal the originals.

``bench_scaling``'s construction (random dense T, 50 PCG iterations at tol
0, ``tools/bench_scaling.py:43-67``) is held to the JAX package's: n and k
exactly, the operator and preconditioner products and the residual of the
first three iterations to 1e-10.  The preconditioner lam^-1 (I - T^T T) of
a random T is indefinite and lam = 1e-10, so rounding grows fast: the JAX
construction with one label moved by one ulp parts from itself by 1e-4
after 10 iterations and by 0.83 of the residual after 50 (n = 540).  The
50-iteration residual is therefore held to be finite, not to a tolerance.
"""

import importlib
import json
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mlff_tpu.data.synthetic import (  # noqa: E402
    make_benchmark_dataset as jax_benchmark_dataset)
from mlff_tpu.data.synthetic import make_dataset as jax_make_dataset  # noqa: E402
from mlff_tpu.models.gdml import Trainer as JaxTrainer  # noqa: E402
from mlff_tpu.models.task import create_task as jax_create_task  # noqa: E402
from mlff_tpu.ops import descriptor as jdsc  # noqa: E402
from mlff_tpu.ops import kernel as jknl  # noqa: E402
from mlff_tpu.solvers.cg import PCGSolver as JaxPCGSolver  # noqa: E402
from mlff_tpu.solvers.preconditioners import (  # noqa: E402
    WoodburyPreconditioner as JaxWoodbury)
from mlff_tpu_torch.models.gdml import Trainer  # noqa: E402
from mlff_tpu_torch.ops import kernel as tknl  # noqa: E402
from mlff_tpu_torch.tools import bench  # noqa: E402
from mlff_tpu_torch.tools import benchlib  # noqa: E402
from mlff_tpu_torch.tools import bench_k_sweep_31k as ksweep  # noqa: E402
from mlff_tpu_torch.tools import bench_molecule_table as table  # noqa: E402
from mlff_tpu_torch.tools import bench_nanotube as nanotube  # noqa: E402
from mlff_tpu_torch.tools import bench_scaling as scaling  # noqa: E402
from mlff_tpu_torch.tools import bench_time_to_solution as tts  # noqa: E402
from mlff_tpu_torch.tools import run_500k  # noqa: E402

from .torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
N_TRAIN, K = 30, 200            # n = 810
TABLE_K = 128                   # bench_molecule_table's k at n = 810
ITERS_RTOL = 0.03               # see the module docstring
TPU_ONLY = {"tunnel_warmup_s", "mxu_util_pct", "north_star"}

BENCH_KEYS = {
    "metric", "value", "unit", "workload", "converged", "iters", "k",
    "strategy", "matvec_dtype", "apply_impl", "t_cache_build_cold_s",
    "t_cache_build_warm_s", "t_preconditioner_s", "t_cg_s", "t_finalize_s",
    "solve_warm_s", "wall_total_s", "matvec_nnz_per_s", "vs_baseline",
    "vs_baseline_warm", "vs_baseline_wall", "device", "warmup_s",
    "matvec_f64_device_ms"}
TTS_KEYS = {"metric", "value", "unit", "converged", "iters", "k",
            "t_preconditioner_s", "t_cg_s", "wall_total_s", "workload",
            "s_per_iter", "vs_baseline", "device"}
SWEEP_KEYS = {"metric", "rows", "best_k", "best_solver_s", "device"}
SWEEP_ROW_KEYS = {"k", "solver_s", "t_pre_s", "t_cg_s", "iters", "converged",
                  "wall_s"}
SCALING_KEYS = {"n_train", "n", "k", "cache_build_s", "resid_50",
                "s_per_iter", "ms_per_iter", "matvec_nnz_per_s", "device"}
TABLE_ROW_KEYS = {"molecule", "n", "P", "k", "k_over_n_pct", "converged",
                  "iters", "solve_s", "t_cache_warm_s", "t_cache_cold_s",
                  "t_preconditioner_s", "t_cg_s", "wall_s"}
TABLE_ENTRY_KEYS = {"best_solve_s", "best_k", "reference_optimal_s",
                    "reference_optimal_k", "speedup"}
NANOTUBE_KEYS = {"metric", "value", "unit", "converged", "iters", "k",
                 "labels", "matvec_impl", "t_preconditioner_s", "t_cg_s",
                 "wall_total_s", "vs_baseline", "device"}
RUN500K_KEYS = {
    "metric", "value", "unit", "workload", "converged", "iters", "k",
    "k_over_n_pct", "matvec_dtype", "t_cache_build_s", "t_preconditioner_s",
    "t_cg_s", "s_per_iter", "wall_s", "true_residual_rel",
    "gram_probe_err", "gram_guard_fired", "peak_mem_gb",
    "archived_at_same_kn", "vs_archived_best", "vs_archived_same_kn",
    "device"}

_JAX_MODELS: dict = {}


def jax_model(k: int, maxiter: int | None = None) -> dict:
    """The benchmark task at N_TRAIN trained by the JAX package (f64
    matvec, lev_random), once per (k, maxiter)."""
    if (k, maxiter) not in _JAX_MODELS:
        ds, perms = jax_benchmark_dataset("ethanol", n_samples=N_TRAIN + 60,
                                          seed=11, n_train=N_TRAIN)
        task = jax_create_task(ds, N_TRAIN, ds, n_valid=50, sig=10.0,
                               solver="cg", perms=perms)
        if maxiter:
            task["solver_maxiter"] = maxiter
        _JAX_MODELS[k, maxiter] = JaxTrainer().train(
            task, n_columns=k, str_preconditioner="lev_random")
    return _JAX_MODELS[k, maxiter]


def assert_same_training(model: dict, want: dict) -> None:
    np.testing.assert_array_equal(model["inducing_pts_idxs"],
                                  want["inducing_pts_idxs"])
    want_iters = int(want["solver_iters"])
    assert (abs(int(model["solver_iters"]) - want_iters)
            <= max(2, ITERS_RTOL * want_iters))
    assert bool(model["is_conv"]) == bool(want["is_conv"])


def assert_finite_numbers(out: dict) -> None:
    for key, value in out.items():
        if isinstance(value, float):
            assert math.isfinite(value), key


def last_json_line(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# -- bench --------------------------------------------------------------------

def test_bench_matches_the_jax_training():
    out, model = bench.bench(CPU, k=K, strategy="lev_random",
                             matvec_dtype="float64", apply_impl="xla",
                             warmup_s=0.0, n_train=N_TRAIN)
    assert set(out) == BENCH_KEYS and not set(out) & TPU_ONLY
    assert out["converged"] and out["metric"] == "time_to_solution_ethanol_n810"
    assert out["device"] == "cpu" and out["matvec_f64_device_ms"] is None
    assert out["value"] == pytest.approx(out["t_cache_build_cold_s"]
                                         + out["t_preconditioner_s"]
                                         + out["t_cg_s"], rel=1e-12)
    assert out["vs_baseline"] == pytest.approx(bench.BASELINE_S / out["value"])
    assert_finite_numbers({k: v for k, v in out.items()
                           if k != "matvec_f64_device_ms"})
    assert_same_training(model, jax_model(K))


@pytest.mark.parametrize("maxiter,rc", [(None, 0), (10, 1)],
                         ids=["converged", "capped"])
def test_bench_main_prints_one_line_and_exits_by_convergence(
        maxiter, rc, monkeypatch, capsys):
    monkeypatch.setenv("BENCH_K", str(K))
    assert bench.main(["--device", "cpu"], n_train=N_TRAIN,
                      maxiter=maxiter) == rc
    line = last_json_line(capsys)
    assert set(line) == BENCH_KEYS and line["k"] == K
    assert line["converged"] is (rc == 0)
    if maxiter:
        assert line["iters"] == maxiter


def test_bench_knobs_default_to_the_f64_matvec(monkeypatch):
    for name in ("BENCH_K", "BENCH_STRATEGY", "BENCH_MATVEC", "BENCH_APPLY"):
        monkeypatch.delenv(name, raising=False)
    assert bench.knobs() == {"k": 1536, "strategy": "lev_random",
                             "matvec_dtype": "float64", "apply_impl": "xla"}
    monkeypatch.setenv("BENCH_APPLY", "df64")
    assert bench.knobs()["apply_impl"] == "df64"


# -- the reference constants ----------------------------------------------------

@pytest.mark.parametrize("port,root,names", [
    (bench, "bench", ("BASELINE_S", "N_TRAIN")),
    (benchlib, "bench", ("SIG",)),
    (tts, "tools.bench_time_to_solution", ("REFERENCE_MIN",)),
    (table, "tools.bench_molecule_table", ("REFERENCE", "DEFAULT_KFRAC")),
    (nanotube, "tools.bench_nanotube", ("REFERENCE_MIN_N31400",)),
    (run_500k, "tools.run_500k", ("ARCHIVED", "N_TRAIN")),
    (benchlib, "tools.run_500k", ("SIG",)),
    (scaling, "tools.bench_scaling", ("N_ATOMS", "SIG", "LAM")),
], ids=["bench", "bench_sig", "time_to_solution", "molecule_table",
        "nanotube", "run_500k", "run_500k_sig", "scaling"])
def test_reference_constants_are_the_root_tools(port, root, names):
    ref = importlib.import_module(root)
    for name in names:
        assert getattr(port, name) == getattr(ref, name), name


def test_reference_seconds_as_the_root_tool():
    ref = importlib.import_module("tools.bench_time_to_solution")
    for molecule, n in (("ethanol", 31482), ("aspirin", 31374),
                        ("ethanol", 503982), ("nanotube", 31080),
                        ("ethanol", 810), ("methane", 31400)):
        assert (tts.reference_seconds(molecule, n)
                == ref.reference_seconds(molecule, n))


# -- bench_time_to_solution, bench_k_sweep_31k -----------------------------------

def test_time_to_solution_matches_the_jax_training():
    args = tts.parser().parse_args(["--benchmark-data", "--n-train",
                                    str(N_TRAIN), "--k", str(K),
                                    "--device", "cpu"])
    out, model = tts.run(args)
    assert set(out) == TTS_KEYS and not set(out) & TPU_ONLY
    assert out["converged"] and out["workload"] == "calibrated+perms"
    assert out["vs_baseline"] is None       # no reference scale near n = 810
    assert_finite_numbers(out)
    assert_same_training(model, jax_model(K))


def test_k_sweep_matches_the_jax_training(capsys):
    args = ksweep.parser().parse_args(["--benchmark-data", "--n-train",
                                       str(N_TRAIN), "--ks", str(TABLE_K),
                                       str(K), "--device", "cpu"])
    out, models = ksweep.run(args)
    assert set(out) == SWEEP_KEYS
    assert [r["k"] for r in out["rows"]] == [TABLE_K, K]
    for row in out["rows"]:
        assert set(row) == SWEEP_ROW_KEYS and row["converged"]
        assert_finite_numbers(row)
    assert out["best_k"] in (TABLE_K, K)
    for k, model in zip((TABLE_K, K), models):
        assert_same_training(model, jax_model(k))


# -- bench_scaling ---------------------------------------------------------------

def jax_scaling_solver(n_train: int):
    """tools/bench_scaling.py:43-67 in the JAX package: (cache, P, solver,
    b, k)."""
    ds = jax_make_dataset("ethanol", n_samples=n_train, seed=7)
    spec = jdsc.make_spec(scaling.N_ATOMS)
    S = jdsc.incidence_matrix(spec)
    P_idx = jnp.asarray(jdsc.desc_perms(scaling.ethanol_perms()),
                        dtype=jnp.int32)
    X, Jc = jdsc.descriptors_from_R(spec, jnp.asarray(ds["R"]))
    cache = jknl.build_cache(X, Jc, S, P_idx, scaling.SIG, scaling.LAM)
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.normal(size=cache.n))
    k = max(1, int(0.1 * cache.n))
    T = jnp.asarray(rng.normal(size=(k, cache.n)) / np.sqrt(cache.n))
    P = JaxWoodbury(T=T, lam=jnp.asarray(scaling.LAM))
    solver = JaxPCGSolver((lambda c, v: jknl.matvec_psd(c, v), cache),
                          precon=P, chunk=50)
    return cache, P, solver, b, k


@pytest.mark.parametrize("n_train", [20, 40])
def test_scaling_construction_matches_the_jax_one(n_train):
    cache, solver, b, k, _ = scaling.setup(n_train, CPU)
    j_cache, j_P, j_solver, j_b, j_k = jax_scaling_solver(n_train)
    assert (cache.n, k) == (j_cache.n, j_k) == (27 * n_train, 27 * n_train
                                                // 10)
    np.testing.assert_array_equal(b.numpy(), np.asarray(j_b))
    Kb = tknl.matvec_psd(cache, b).numpy()
    j_Kb = np.asarray(jknl.matvec_psd(j_cache, j_b))
    assert np.linalg.norm(Kb - j_Kb) <= 1e-12 * np.linalg.norm(j_Kb)
    Pb = solver.precon(b).numpy()
    j_Pb = np.asarray(j_P.as_op()[0](j_P.as_op()[1], j_b))
    assert np.linalg.norm(Pb - j_Pb) <= 1e-12 * np.linalg.norm(j_Pb)
    for iters in (1, 2, 3):
        got = solver.solve(b, tol=0.0, maxiter=iters)
        want = j_solver.solve(j_b, tol=0.0, maxiter=iters)
        assert got.num_iters == want.num_iters == iters
        assert abs(got.resid - want.resid) <= 1e-10 * want.resid
    assert math.isfinite(solver.solve(b, tol=0.0, maxiter=50).resid)


def test_scaling_prints_one_line_per_size(capsys):
    rows = scaling.main(["--sizes", "20", "40", "--iters", "10",
                         "--device", "cpu"])
    printed = [json.loads(ln) for ln in
               capsys.readouterr().out.strip().splitlines()]
    assert printed == rows and [r["n"] for r in rows] == [540, 1080]
    for row in rows:
        assert set(row) == SCALING_KEYS and row["device"] == "cpu"
        assert row["k"] == row["n"] // 10
        assert_finite_numbers(row)


# -- bench_molecule_table ---------------------------------------------------------

def test_molecule_table_row_matches_the_jax_training():
    row, model = table.run_one("ethanol", TABLE_K, {}, CPU, N_TRAIN)
    assert set(row) == TABLE_ROW_KEYS and row["converged"]
    assert (row["n"], row["P"], row["k"]) == (810, 6, TABLE_K)
    assert row["solve_s"] == pytest.approx(
        row["t_cache_warm_s"] + row["t_preconditioner_s"] + row["t_cg_s"])
    assert_finite_numbers(row)
    assert_same_training(model, jax_model(TABLE_K))


def test_molecule_table_writes_only_to_out(tmp_path, monkeypatch, capsys):
    root_table = ROOT / "tools" / "molecule_table.json"
    before = root_table.read_bytes(), root_table.stat().st_mtime_ns
    work = tmp_path / "cwd"
    work.mkdir()
    monkeypatch.chdir(work)
    printed = table.main(["ethanol", "--device", "cpu"], n_train=N_TRAIN)
    assert last_json_line(capsys) == json.loads(json.dumps(printed))
    assert not list(work.iterdir())
    assert (root_table.read_bytes(), root_table.stat().st_mtime_ns) == before
    entry = printed["molecules"]["ethanol"]
    assert set(entry) == TABLE_ENTRY_KEYS and entry["best_k"] == TABLE_K
    assert entry["reference_optimal_s"] == 48.0

    out = tmp_path / "table.json"
    table.main(["ethanol", "--out", str(out), "--device", "cpu"],
               n_train=N_TRAIN)
    written = json.loads(out.read_text())
    assert [r["k"] for r in written["ethanol"]["rows"]] == [TABLE_K]
    assert not list(work.iterdir())


# -- bench_nanotube -------------------------------------------------------------

def test_nanotube_line_on_the_square_layout():
    args = nanotube.parser().parse_args(["--n-train", "2", "--k", "64",
                                         "--device", "cpu"])
    assert (args.precon, args.labels) == ("cholesky_panel", "manufactured")
    out, _ = nanotube.run(args, maxiter=20)
    assert set(out) == NANOTUBE_KEYS and not set(out) & TPU_ONLY
    assert out["metric"] == "time_to_solution_nanotube_n2220"
    assert out["matvec_impl"] == "square" and out["iters"] == 20
    assert_finite_numbers(out)


# -- run_500k -----------------------------------------------------------------

def test_run_500k_probe_matches_the_jax_training(tmp_path):
    args = run_500k.parser().parse_args([
        "--k", str(K), "--probe", "--ckpt", str(tmp_path / "ck.npz"),
        "--device", "cpu"])
    assert args.matvec == "float64"
    out, model = run_500k.run(args, n_train=N_TRAIN)
    assert set(out) == RUN500K_KEYS and not set(out) & TPU_ONLY
    assert out["iters"] == run_500k.PROBE_ITERS and not out["converged"]
    assert out["peak_mem_gb"] is None and out["device"] == "cpu"
    assert out["gram_guard_fired"] is False
    assert_finite_numbers(out)
    assert_same_training(model, jax_model(K, maxiter=run_500k.PROBE_ITERS))


def test_run_500k_checkpoints_and_resumes_to_convergence(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    monkeypatch.setenv("MLFF_CKPT_EVERY_S", "0")
    ckpt = tmp_path / "ck.npz"
    base = ["--k", str(K), "--ckpt", str(ckpt), "--device", "cpu"]
    run_500k.main(base + ["--probe"], n_train=N_TRAIN)
    probe = last_json_line(capsys)
    assert ckpt.exists() and not probe["converged"]
    run_500k.main(base + ["--resume"], n_train=N_TRAIN)
    resumed = last_json_line(capsys)
    assert resumed["converged"] and resumed["iters"] > probe["iters"]
    assert resumed["true_residual_rel"] <= 1.3e-4
    assert not ckpt.exists()         # a converged run removes its checkpoint


# -- the timers --------------------------------------------------------------

def test_preconditioner_and_cg_times_fit_in_the_training():
    """The preconditioner's time ends on a synchronized device, so the two
    phase times the tools add up lie within the Trainer's own wall time."""
    import time

    from mlff_tpu_torch.data.synthetic import make_benchmark_dataset
    from mlff_tpu_torch.models.task import create_task

    ds, perms = make_benchmark_dataset("ethanol", n_samples=N_TRAIN + 60,
                                       seed=11, n_train=N_TRAIN)
    task = create_task(ds, N_TRAIN, ds, n_valid=50, sig=10.0, solver="cg",
                       perms=perms)
    t0 = time.perf_counter()
    model = Trainer(device="cpu").train(task, n_columns=K,
                                        str_preconditioner="lev_random")
    wall = time.perf_counter() - t0
    t_pre, t_cg = model["total_time_preconditioner"], model["total_time_cg"]
    assert 0 < t_pre and 0 < t_cg
    assert t_pre + t_cg + model["cache_build_s"] <= wall

