"""The port's per-layer timing tools (``mlff_tpu_torch/tools/time_*``,
``exp_f32_apply``) and the profiler reader (``utils/timing.py``) on the
CPU at small sizes.

Each tool keeps its root tool's constants and argument defaults (the root
``tools/profile_*.py``, ``probe_otf_parts.py``, ``exp_f32_apply.py``,
``make_example_figures.py``: their parsers are read by stopping their
``main`` at ``parse_args``, their constants from the module or, where the
root keeps one inside ``main``, from its source).  Each tool's ``main``
runs with ``--device cpu``: every line names the device "cpu" and carries
null in every device-time field (times, shares, launch counts).

Parity against the JAX package on the same NumPy inputs:

- ``exp_f32_apply.f32_apply`` against the root's ``f32_apply`` on f32
  factors (rtol 1e-5), and the experiment's iteration counts with both
  applies against the JAX package's ``pcg`` within 2 or 3%
  (``tests/test_torch_strategy_order.py``'s rule);
- ``time_chunk_parts``' loop as it is and with the identity in place of
  the apply and of the matvec: each residual of the first CHUNK_ITERS = 3
  iterations within 1e-10 of the JAX ``PCGSolver`` with the same swap.
  Both packages apply the port's split factors (B, W2): the two packages'
  host factorizations agree to ~3e-12, which the system's lam = 1e-10
  amplifies, and with the matvec replaced by the identity CG runs on a
  preconditioner whose spectrum spans ten decades, where the same
  factors part by 2e-8 at the fourth iteration and 2e-3 at the fifth
  (f64 rounding in another order, not a fault);
- ``time_matvec``'s stage outputs against the same stages written with
  ``mlff_tpu/ops/kernel.py`` and ``descriptor.py`` (1e-12 of each stage's
  scale), its last stage ``matvec_psd`` itself;
- ``time_ozaki_matvec``'s agreement of the Ozaki and the f64 matvec
  (<= 1e-12, the chip phase's limit);
- ``time_woodbury_f32``'s f32-pair error against the root's formula
  evaluated by JAX in f32 (within 4x of each other).
"""

import argparse
import ast
import importlib
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mlff_tpu.data.synthetic import make_dataset as jax_make_dataset  # noqa: E402
from mlff_tpu.ops import descriptor as jdsc  # noqa: E402
from mlff_tpu.ops import kernel as jknl  # noqa: E402
from mlff_tpu.solvers import preconditioners as jpc  # noqa: E402
from mlff_tpu.solvers.cg import PCGSolver as JaxPCGSolver  # noqa: E402
from mlff_tpu.solvers.cg import pcg as jax_pcg  # noqa: E402
from mlff_tpu_torch.tools import benchlib as bl  # noqa: E402
from mlff_tpu_torch.tools import exp_f32_apply  # noqa: E402
from mlff_tpu_torch.tools import make_example_figures  # noqa: E402
from mlff_tpu_torch.tools import time_cg_iter  # noqa: E402
from mlff_tpu_torch.tools import time_chunk_parts  # noqa: E402
from mlff_tpu_torch.tools import time_factorization  # noqa: E402
from mlff_tpu_torch.tools import time_matvec  # noqa: E402
from mlff_tpu_torch.tools import time_nanotube_iter  # noqa: E402
from mlff_tpu_torch.tools import time_otf_parts  # noqa: E402
from mlff_tpu_torch.tools import time_ozaki_loop  # noqa: E402
from mlff_tpu_torch.tools import time_ozaki_matvec  # noqa: E402
from mlff_tpu_torch.tools import time_woodbury_apply  # noqa: E402
from mlff_tpu_torch.tools import time_woodbury_f32  # noqa: E402
from mlff_tpu_torch.utils import timing  # noqa: E402

from .torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
N_TRAIN, K = 12, 64             # n = 324
CHUNK_ITERS = 3                 # see the module docstring
ITERS_RTOL = 0.03

# -- the root tools' constants and argument defaults ----------------------------

# (port module, root module, module constants, {port constant: the root
# main's local of the same value})
PAIRS = [
    (time_chunk_parts, "tools.profile_chunk_parts",
     ("N_ATOMS", "SIG", "LAM"), {}),
    (time_cg_iter, "tools.profile_cg_iter", ("N_ATOMS", "SIG", "LAM"), {}),
    (time_matvec, "tools.profile_matvec",
     ("N_TRAIN", "N_ATOMS", "SIG", "LAM", "LOOP"), {}),
    (time_woodbury_apply, "tools.profile_woodbury_apply", (), {}),
    (time_woodbury_f32, "tools.profile_woodbury_f32", (), {}),
    (exp_f32_apply, "tools.exp_f32_apply", ("N_ATOMS", "SIG", "LAM"), {}),
    (time_factorization, "tools.profile_factorization", (), {"LAM": "lam"}),
    (time_nanotube_iter, "tools.profile_nanotube_iter", ("SIG", "LAM"), {}),
    (time_ozaki_matvec, "tools.profile_ozaki_matvec", (), {}),
    (time_ozaki_loop, "tools.profile_ozaki_loop", (), {"N_CH": "N_CH"}),
    (time_otf_parts, "tools.probe_otf_parts", (), {"S_DIGITS": "s"}),
    (make_example_figures, "tools.make_example_figures", ("STRATEGIES",), {}),
]


class _Parsed(Exception):
    pass


def root_defaults(ref, monkeypatch) -> dict:
    """{dest: default} of the parser the root tool's ``main`` builds ({} for
    a tool without one, whose ``main`` is not run): its ``main`` runs up to
    ``parse_args``."""
    if "ArgumentParser" not in Path(ref.__file__).read_text():
        return {}
    seen = {}

    def stop(self, *args, **kwargs):
        seen["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    try:
        ref.main()
    except _Parsed:
        pass
    return {a.dest: a.default for a in seen["parser"]._actions
            if a.dest != "help"}


def root_locals(path: Path) -> dict:
    """{name: value} of every ``name = <literal>`` in a root file's source,
    inside functions too."""
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            try:
                out[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    return out


@pytest.mark.parametrize("port,root,names,local", PAIRS,
                         ids=[p[1].split(".")[-1] for p in PAIRS])
def test_tool_keeps_the_root_constants_and_defaults(port, root, names, local,
                                                    monkeypatch):
    ref = importlib.import_module(root)
    for name in names:
        assert getattr(port, name) == getattr(ref, name), name
    literals = root_locals(ROOT / (root.replace(".", "/") + ".py"))
    for name, root_name in local.items():
        assert getattr(port, name) == literals[root_name], name
    want = root_defaults(ref, monkeypatch)
    got = {a.dest: a.default for a in port.parser()._actions
           if a.dest != "help"}
    assert {k: got.get(k, "missing") for k in want} == want
    assert got["device"] is None                  # cuda unless asked


# -- each tool's main on the CPU ------------------------------------------------

# every key that names a time, a share, a rate or a launch count
DEVICE_FIELD = re.compile(r"(^|_)(ms|s)(_|$)|share|gb_per_s|launches|"
                          r"top_kernels|speedup|window")

MAINS = [
    (time_chunk_parts, ["--n-train", N_TRAIN, "--k", K, "--apply-impl",
                        "df64"], {}),
    (time_cg_iter, ["--n-train", N_TRAIN, "--k", K, "--chunks", 5, 10], {}),
    (time_matvec, [], {"n_train": N_TRAIN}),
    (time_woodbury_apply, ["--n", 300, "--m", 40], {}),
    (time_woodbury_f32, ["--n", 300, "--m", 40], {}),
    (time_factorization, ["--n", 500, "--m", 40], {}),
    (time_nanotube_iter, ["--n-train", 2, "--k", 64], {}),
    (time_ozaki_matvec, ["--n-train", N_TRAIN, "--k", K, "--iters", 10], {}),
    (time_ozaki_loop, [], {"n_train": N_TRAIN}),
    (time_otf_parts, ["--t", 8, "--m", 300, "--reps", 1], {}),
]


def assert_cpu_lines(lines: list, printed: str) -> None:
    assert lines and printed.count("\n") == len(lines)
    for line in lines:
        assert line["device"] == "cpu"
        for key, value in line.items():
            if DEVICE_FIELD.search(key):
                values = value if isinstance(value, list) else [value]
                assert all(v is None for v in values), (key, value)


@pytest.mark.parametrize("tool,argv,kw", MAINS,
                         ids=[m[0].__name__.split(".")[-1] for m in MAINS])
def test_main_on_the_cpu_prints_no_device_number(tool, argv, kw, capsys):
    lines = tool.main([str(a) for a in argv] + ["--device", "cpu"], **kw)
    assert_cpu_lines(lines, capsys.readouterr().out)


@pytest.fixture(scope="module")
def exp_lines():
    return exp_f32_apply.main(["--n-train", str(N_TRAIN), "--k", str(K),
                               "--device", "cpu"])


def test_exp_f32_apply_main_on_the_cpu_prints_no_device_number(exp_lines):
    assert [ln["apply"] for ln in exp_lines] == ["f64", "f32"]
    assert_cpu_lines(exp_lines, "\n" * len(exp_lines))
    for line in exp_lines:
        assert np.isfinite(line["true_resid"])
        if line["converged"]:
            assert line["true_resid"] <= 1.3e-4


# -- parity against the JAX package ----------------------------------------------

def test_f32_apply_matches_the_root_f32_apply():
    ref = importlib.import_module("tools.exp_f32_apply")
    rng = np.random.default_rng(3)
    n, m, lam = 400, 48, 1e-3
    B32 = (rng.normal(size=(n, m)) / np.sqrt(n)).astype(np.float32)
    W2 = rng.normal(size=(m, m)) / m
    v = rng.normal(size=n)
    want = np.asarray(ref.f32_apply(
        (jnp.asarray(B32), jnp.asarray(W2), lam), jnp.asarray(v)))
    got = exp_f32_apply.f32_apply(
        (torch.as_tensor(B32), torch.as_tensor(W2), lam),
        torch.as_tensor(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_exp_f32_apply_iterations_match_the_jax_pcg(exp_lines):
    """The root experiment's steps in the JAX package at the same size:
    both applies' iterations within 2 or 3%, the same convergence."""
    ref = importlib.import_module("tools.exp_f32_apply")
    ds = jax_make_dataset("ethanol", n_samples=N_TRAIN, seed=11)
    spec = jdsc.make_spec(ref.N_ATOMS)
    X, Jc = jdsc.descriptors_from_R(spec, jnp.asarray(ds["R"]))
    cache = jknl.build_cache(X, Jc, jdsc.incidence_matrix(spec),
                             jnp.asarray(np.arange(spec.dim)[None, :]),
                             ref.SIG, ref.LAM)
    rng = np.random.default_rng(0)
    lev, order = jpc.leverage_scores(spec, cache, ref.LAM, 25, rng)
    idxs = jpc.select_by_leverage("lev_random", lev, order, K, rng)
    y = np.asarray(ds["F"], dtype=np.float64).reshape(-1)[:cache.n]
    y = jnp.asarray(y / y.std())
    P = jpc.nystrom_preconditioner(spec, cache, idxs, ref.LAM)
    state32 = (P.B.astype(jnp.float32), P.W2, P.lam)
    want = {
        "f64": jax_pcg((jknl.matvec_psd, cache), y, precon=P, tol=1e-4,
                       maxiter=8000),
        "f32": jax_pcg((jknl.matvec_psd, cache), y,
                       precon=(ref.f32_apply, state32), tol=1e-4,
                       maxiter=8000)}
    for line in exp_lines:
        res = want[line["apply"]]
        assert line["converged"] == bool(res.converged)
        assert (abs(line["iters"] - int(res.num_iters))
                <= max(2, ITERS_RTOL * int(res.num_iters)))


@pytest.fixture(scope="module")
def chunk_system():
    """The tool's system in both packages, the JAX one applying the port's
    split factors."""
    spec, cache, _ = bl.ethanol_system(N_TRAIN, CPU, time_chunk_parts.SIG,
                                       time_chunk_parts.LAM)
    rng = np.random.default_rng(0)
    P = time_chunk_parts.preconditioner(spec, cache, K, "xla", rng)
    b = torch.as_tensor(rng.standard_normal(cache.n))
    ds = jax_make_dataset("ethanol", n_samples=N_TRAIN, seed=11)
    jspec = jdsc.make_spec(9)
    X, Jc = jdsc.descriptors_from_R(jspec, jnp.asarray(ds["R"]))
    jcache = jknl.build_cache(X, Jc, jdsc.incidence_matrix(jspec),
                              jnp.asarray(np.arange(jspec.dim)[None, :]),
                              time_chunk_parts.SIG, time_chunk_parts.LAM)
    jP = jpc.WoodburySplitPreconditioner(
        B=jnp.asarray(P.B.numpy()), W2=jnp.asarray(P.W2.numpy()),
        lam=jnp.asarray(P.lam))
    cases = time_chunk_parts.cases(
        time_chunk_parts.matvec_of(cache, "float64"), P)
    return cases, b, jcache, jP


def _jax_identity(state, v):
    return v


@pytest.mark.parametrize("case", ["full", "matvec_only", "apply_only"])
def test_chunk_parts_cases_match_the_jax_solver(chunk_system, case):
    cases, b, jcache, jP = chunk_system
    mv = {"full": (jknl.matvec_psd, jcache),
          "matvec_only": (jknl.matvec_psd, jcache),
          "apply_only": (_jax_identity, None)}[case]
    pc = None if case == "matvec_only" else jP
    want = JaxPCGSolver(mv, pc, chunk=time_chunk_parts.CHUNK).solve(
        jnp.asarray(b.numpy()), tol=1e-300, maxiter=CHUNK_ITERS)
    got = time_chunk_parts.solve(*cases[case], b, iters=CHUNK_ITERS)
    assert got.num_iters == int(want.num_iters) == CHUNK_ITERS
    np.testing.assert_allclose(got.resid_hist, np.asarray(want.resid_hist),
                               rtol=1e-10)


def test_chunk_runner_runs_one_chunk_of_the_solver(chunk_system):
    """``benchlib.chunk_runner`` queues exactly the solver's first chunk:
    its iterate equals a solve of one chunk."""
    from mlff_tpu_torch.solvers.cg import PCGSolver

    cases, b, _, _ = chunk_system
    mv, pc = cases["full"]
    x = bl.chunk_runner(PCGSolver(mv, pc, chunk=5), b, 5)()
    want = time_chunk_parts.solve(mv, pc, b, iters=5, chunk=5)
    np.testing.assert_array_equal(x.numpy(), want.x)


def test_split_takes_the_identity_cases_apart():
    rows = {"full": {"t": 1.0}, "matvec_only": {"t": 0.7},
            "apply_only": {"t": 0.5}, "vector_ops": {"t": 0.2}}
    out = time_chunk_parts.split(rows, "t")
    assert out["matvec"] == pytest.approx(0.5)
    assert out["apply"] == pytest.approx(0.3)
    assert out["sum_over_full"] == pytest.approx(1.0)
    rows["full"]["t"] = None
    assert time_chunk_parts.split(rows, "t") is None


def jax_stages(n_train: int) -> dict:
    """The matvec's stages written with the JAX package's functions, on the
    root tool's system (seed 7, the six permutations of atoms 0-2)."""
    import itertools

    ds = jax_make_dataset("ethanol", n_samples=n_train, seed=7)
    spec = jdsc.make_spec(9)
    perms = []
    for p3 in itertools.permutations([0, 1, 2]):
        p = np.arange(9)
        p[:3] = p3
        perms.append(p)
    P_idx = jnp.asarray(jdsc.desc_perms(np.stack(perms)), dtype=jnp.int32)
    X, Jc = jdsc.descriptors_from_R(spec, jnp.asarray(ds["R"]))
    c = jknl.build_cache(X, Jc, jdsc.incidence_matrix(spec), P_idx, 10.0,
                         1e-10)
    v = jnp.asarray(np.random.default_rng(0).normal(size=c.n))
    N, A = c.X.shape[0], c.S.shape[1]
    w = jdsc.d_desc_dot_vec(c.Jc, c.S, v.reshape(N, A, 3))
    wt = jknl.perm_expand_w(w, c.P_idx)
    ct = jnp.sum(c.Xqt * wt, axis=1)
    dot = c.Xq @ wt.T - ct[None, :]
    G = c.A_exp * dot
    rowsum = jnp.sum(G, axis=1, keepdims=True)
    F1 = c.Xq * rowsum - G @ c.Xqt
    F2 = c.A_exp1 @ wt
    out = {"w": w, "gather": wt, "ct": ct, "dot": dot, "G": G,
           "rowsum": rowsum, "F1": F1, "F2": F2,
           "full": jknl.matvec_psd(c, v)}
    return {k: np.asarray(val) for k, val in out.items()}


def test_matvec_stages_match_the_jax_kernel():
    from mlff_tpu_torch.ops import kernel as knl

    cache, v0, _ = time_matvec.system(N_TRAIN, CPU)
    got = time_matvec.stage_outputs(cache, v0)
    want = jax_stages(N_TRAIN)
    assert list(got) == list(time_matvec.STAGES) == list(want)
    for name in time_matvec.STAGES:
        g, w = got[name].numpy(), want[name]
        assert g.shape == w.shape, name
        assert np.abs(g - w).max() <= 1e-12 * np.abs(w).max(), name
    np.testing.assert_array_equal(got["full"].numpy(),
                                  knl.matvec_psd(cache, v0).numpy())
    assert list(time_matvec.stage_outputs(cache, v0, "dot")) == [
        "w", "gather", "ct", "dot"]


def test_ozaki_matvec_agrees_with_f64():
    from mlff_tpu_torch.models.gdml import Trainer

    task, _ = bl.benchmark_task("ethanol", N_TRAIN)
    _, cache = bl.rebuild_cache(Trainer(device=CPU), task)
    fns, _ = time_ozaki_matvec.matvecs(cache)
    v = torch.as_tensor(np.random.default_rng(0).normal(size=cache.n))
    assert time_ozaki_matvec.agreement(fns, v) <= 1e-12


def test_grouped_digit_products_equal_the_engines():
    from mlff_tpu_torch.ops import ozaki

    rng = np.random.default_rng(6)
    A = torch.as_tensor(rng.normal(size=(20, 300)))
    B = torch.as_tensor(rng.normal(size=(300, 9)))
    A_sl = ozaki.slice_digits(A, axis=1, s=7)
    B_sl = ozaki.slice_digits(B, axis=0, s=7)
    want = ozaki.gemm_presliced(A_sl, B_sl)
    got = time_ozaki_loop.gemm_grouped(A_sl, B_sl)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-15
    assert float(((got - A @ B).abs().max() / (A @ B).abs().max())) <= 1e-13


@pytest.mark.parametrize("direction", ["bt_v", "b_x"])
def test_f32_pair_error_is_the_roots(direction):
    """The port's f32-pair product error against the root's formula
    (``tools/profile_woodbury_f32.py``: hi/lo split of B and of the vector,
    three f32 GEMVs) evaluated by JAX, both against the f64 oracle."""
    rng = np.random.default_rng(1)
    n, m = 3000, 64
    B = rng.standard_normal((n, m)) / np.sqrt(n)
    v, x = rng.standard_normal(n), rng.standard_normal(m)
    Bh = jnp.asarray(B.astype(np.float32))
    Bl = jnp.asarray((B - B.astype(np.float32)).astype(np.float32))
    if direction == "bt_v":
        vh = v.astype(np.float32)
        vl = (v - vh.astype(np.float64)).astype(np.float32)
        root = vh @ Bh + vl @ Bh + vh @ Bl
        ref = B.T @ v
    else:
        xh = x.astype(np.float32)
        xl = (x - xh.astype(np.float64)).astype(np.float32)
        root = Bh @ xh + Bh @ xl + Bl @ xh
        ref = B @ x
    root_err = (np.abs(np.asarray(root, dtype=np.float64) - ref).max()
                / np.abs(ref).max())
    port_err = time_woodbury_f32.accuracy(
        torch.as_tensor(B), torch.as_tensor(v),
        torch.as_tensor(x))[f"{direction}_pair"]
    assert root_err / 4 <= port_err <= 4 * root_err


# -- the profiler reader ---------------------------------------------------------

def test_device_profile_of_cpu_work_has_no_device_fields():
    x = torch.zeros(8)
    prof = timing.device_profile(torch, lambda: x + 1.0, warmup=1, reps=2)
    assert prof["reps"] == 2
    assert all(v is None for k, v in prof.items() if k != "reps")


@pytest.mark.parametrize("intervals,want", [
    ([(0.0, 2.0), (5.0, 6.0)], 3.0),        # disjoint
    ([(0.0, 2.0), (1.0, 3.0)], 3.0),        # overlapping
    ([(0.0, 5.0), (1.0, 2.0), (4.0, 7.0)], 7.0),   # nested, then past it
])
def test_union_counts_overlaps_once(intervals, want):
    assert timing.union_us(intervals) == want
    assert timing.union_us(intervals[::-1]) == want


def test_summary_of_device_events():
    events = [("gemv", 0.0, 400.0), ("axpy", 300.0, 500.0),
              ("gemv", 1000.0, 1400.0)]
    out = timing.summarize_device_events(events, window_ms=2.0, reps=2)
    assert out["device_busy_ms"] == pytest.approx(0.9)
    assert out["busy_share"] == pytest.approx(0.45)
    assert out["idle_share"] == pytest.approx(0.55)
    assert out["launches"] == 1.5
    assert out["top_kernels"][0] == {"name": "gemv", "calls": 1.0,
                                     "ms": pytest.approx(0.4)}
    with pytest.raises(RuntimeError, match="no CUDA activity"):
        timing.summarize_device_events([], window_ms=1.0, reps=1)


def test_factorization_stages_split_host_sym():
    """``time_factorization`` times ``_host_sym`` as its copy and its host
    symmetrization: together they give ``_host_sym``'s matrix."""
    from mlff_tpu_torch.solvers import preconditioners as pc

    M = torch.as_tensor(np.random.default_rng(8).normal(size=(30, 30)))
    np.testing.assert_array_equal(
        time_factorization.symmetrized(M.cpu().numpy()), pc._host_sym(M))
