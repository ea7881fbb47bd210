"""The PCG iteration as one in-place step (``solvers/cg.py``), on the CPU.

The step over the solver's own buffers must give the loop it replaced bit
for bit: that loop (``_run_before``, kept here as it was) built new tensors
every iteration.  Chunks are compared one by one from the same state,
across a convergence that falls mid-chunk (masked iterations, NaN log
entries) and from a resumed count (``it0 > 0``); whole solves are compared
through ``_pcg_drive``, with a start vector and with residual replacement,
which hands the next chunk a residual that is not the solver's buffer.

On one card the step is captured as a CUDA graph and replayed; the counters
the capture moved are carried to the replays (``utils.trace.counted`` and
``add``), and the spans it opened are not kept (``utils.trace.unrecorded``),
which is checked here exactly.  The CPU and a row-sharded operator over
gloo keep the eager step and never capture; a row-sharded operator over
NCCL is graphed like one card.  The card tests in
``tests/test_torch_cuda.py`` hold the replayed step to the eager one.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mlff_tpu_torch.solvers import cg  # noqa: E402
from mlff_tpu_torch.solvers import preconditioners as pc  # noqa: E402
from mlff_tpu_torch.utils import trace  # noqa: E402

from .torch_threads import one_torch_thread  # noqa: E402,F401

N, RANK, LAM = 96, 40, 1e-2


def _run_before(self, state, threshold, max_steps):
    """``PCGSolver._run`` before the step was factored out of it."""
    state.done = state.done | (state.resid <= threshold)
    resid_log = torch.full((self.chunk,), float("nan"),
                           dtype=state.r.dtype, device=state.r.device)
    x, r, p, rho, resid, it, done = (state.x, state.r, state.p, state.rho,
                                     state.resid, state.it, state.done)
    for i in range(max_steps):
        active = ~done
        z = self.precon(r)
        rho_new = cg._dot(self.layout, r, z)
        beta = torch.where(it == 0, torch.zeros_like(rho_new),
                           rho_new / rho)
        p_new = z + beta * p
        q = self.matvec(p_new)
        alpha = rho_new / cg._dot(self.layout, p_new, q)
        x = torch.where(active, x + alpha * p_new, x)
        r_new = r - alpha * q
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        rho = torch.where(active, rho_new, rho)
        resid = torch.where(active, cg._norm(self.layout, r_new), resid)
        resid_log[i] = torch.where(active, resid, resid_log[i])
        it = it + active.to(it.dtype)
        done = done | (resid <= threshold)
    return cg.CGState(x, r, p, rho, resid, it, done), resid_log


@pytest.fixture(scope="module")
def system():
    """(matvec, preconditioner, b): an SPD kernel-like operator with a
    spread spectrum, and a split Woodbury preconditioner of a rank-40
    Nystrom factor of it (the apply of the production path)."""
    rng = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng.normal(size=(N, N)))
    eig = np.geomspace(1e2, 1e-2, N)
    K = torch.as_tensor((Q * eig) @ Q.T)
    cols = np.sort(rng.choice(N, RANK, replace=False))
    C = K[:, cols]
    L = torch.linalg.cholesky(K[cols][:, cols])
    B = torch.linalg.solve_triangular(L, C.T, upper=False).T    # (N, k)
    U, s, _ = torch.linalg.svd(B, full_matrices=False)
    # lam^-1 (I - U diag(s^2 / (s^2 + lam)) U^T): the Woodbury inverse of
    # B B^T + lam I, with W2 W2^T = diag(1 / (s^2 + lam)) and B = U s
    P = pc.WoodburySplitPreconditioner(
        B=U * s, W2=torch.diag(1.0 / torch.sqrt(s**2 + LAM)), lam=LAM,
        info={})
    A = K + LAM * torch.eye(N, dtype=K.dtype)
    b = torch.as_tensor(rng.normal(size=N))
    return (lambda v: A @ v), P, b


def _start(solver, b, it0=0):
    """``_pcg_drive``'s start state at x = 0."""
    r0 = b - solver.matvec(torch.zeros_like(b))
    return cg.CGState(
        x=torch.zeros_like(b), r=r0, p=torch.zeros_like(b),
        rho=torch.ones((), dtype=b.dtype), resid=torch.linalg.norm(r0),
        it=torch.full((), it0, dtype=torch.int64),
        done=torch.zeros((), dtype=torch.bool))


def _same(got, want):
    for f in cg._FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def _threshold(solver, b, first):
    """(k, threshold): the first iteration k >= ``first`` whose residual
    is below all before it, and a threshold between the two, so that the
    solve converges at iteration k."""
    _, log = _run_before(solver, _start(solver, b),
                         torch.zeros((), dtype=b.dtype), solver.chunk)
    log = log.numpy()
    low = np.minimum.accumulate(log)
    k = next(k for k in range(first, len(log)) if log[k - 1] < low[k - 2])
    return k, float(np.sqrt(log[k - 1] * low[k - 2]))


# (chunk, it0, steps of each chunk): convergence inside the third
CHUNKS = {"mid_chunk": (6, 0, (6, 6, 6, 6)),
          "resumed_partial": (7, 7, (7, 7, 5, 7))}


@pytest.mark.parametrize("case", sorted(CHUNKS))
def test_step_gives_the_loop_before_it_bit_for_bit(system, case):
    """Chunk by chunk from one state: the iterate, residual, direction,
    rho, residual norm, count, flag and log equal the loop's; the
    convergence falls inside the third chunk, so its last steps and the
    whole fourth chunk are masked and log NaN."""
    matvec, P, b = system
    chunk, it0, steps = CHUNKS[case]
    solver = cg.PCGSolver(matvec, P, chunk=chunk)
    k, thr = _threshold(cg.PCGSolver(matvec, P, chunk=64), b,
                        sum(steps[:2]) + 1)
    assert k < sum(steps[:3])
    threshold = torch.tensor(thr, dtype=b.dtype)
    mine, theirs = _start(solver, b, it0), _start(solver, b, it0)
    for n in steps:
        mine, log = solver._run(mine, threshold, n)
        theirs, want = _run_before(solver, theirs, threshold, n)
        _same(mine, theirs)
        np.testing.assert_array_equal(log.numpy(), want.numpy())
    assert int(mine.it) == it0 + k and bool(mine.done)
    assert np.isnan(log.numpy()).all()
    assert solver.eager_steps == steps[-1]


SOLVES = {"plain": {},
          "resumed_from_x0": {"it0": 40, "x0": True},
          "residual_replacement": {"exact": True, "replace_every": 3}}


@pytest.mark.parametrize("case", sorted(SOLVES))
def test_solve_gives_the_loop_before_it_bit_for_bit(system, case,
                                                    monkeypatch):
    """A whole solve through ``_pcg_drive``, chunks of 4: the result
    equals that of the loop before under it, and the caller's
    start vector is left as it was."""
    matvec, P, b = system
    opts = dict(SOLVES[case])
    x0 = (torch.as_tensor(np.random.default_rng(1).normal(size=N)) * 1e-3
          if opts.pop("x0", False) else None)
    exact = matvec if opts.pop("exact", False) else None
    kw = dict(tol=1e-8, maxiter=200, x0=x0, **opts)
    kept = None if x0 is None else x0.clone()
    got = cg.PCGSolver(matvec, P, chunk=4, exact_matvec=exact).solve(b, **kw)
    monkeypatch.setattr(cg.PCGSolver, "_run", _run_before)
    want = cg.PCGSolver(matvec, P, chunk=4, exact_matvec=exact).solve(b,
                                                                      **kw)
    assert got.converged and got.num_iters > kw.get("it0", 0) + 8
    assert got.num_iters == want.num_iters and got.resid == want.resid
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_array_equal(got.resid_hist, want.resid_hist)
    if x0 is not None:
        assert torch.equal(x0, kept)


@pytest.mark.parametrize("times", [0, 1, 7])
def test_counted_changes_are_added_back_exactly(times):
    """``counted`` records each counter's change across a block (a new
    counter, one moved twice, one untouched); ``add(got, -1)`` takes them
    back out and ``add(got, times)`` adds them ``times`` times."""
    trace.reset("t.a", "t.b", "t.c")
    trace.count("t.b", 5)
    trace.count("t.c", 2)
    with trace.counted() as got:
        trace.count("t.a", 3)
        trace.count("t.b")
        trace.count("t.b", 2)
    assert got == {"t.a": 3, "t.b": 3}
    trace.add(got, -1)
    assert (trace.counter("t.a"), trace.counter("t.b")) == (0, 5)
    trace.add(got, times)
    assert trace.counter("t.a") == 3 * times
    assert trace.counter("t.b") == 5 + 3 * times
    assert trace.counter("t.c") == 2
    trace.reset("t.a", "t.b", "t.c")


def test_unrecorded_keeps_no_span_that_closes_inside_it():
    """The spans that close inside ``unrecorded`` leave the recording; the
    span open around it, and those before and after, stay; off the
    recording it does nothing."""
    with trace.unrecorded():
        with trace.span("t.off"):
            pass
    with trace.recording() as rec:
        with trace.span("t.before"):
            pass
        with trace.span("t.capture"), trace.unrecorded():
            with trace.span("t.call"):
                with trace.span("t.collective"):
                    pass
        with trace.span("t.after"):
            pass
    assert [s.name for s in rec.spans] == ["t.before", "t.capture",
                                           "t.after"]
    assert rec.spans[2].parent is None


def _graph_counts():
    return trace.counter(cg.GRAPH_CAPTURES), trace.counter(cg.GRAPH_ITERS)


def test_cpu_solve_never_captures(system):
    matvec, P, b = system
    before = _graph_counts()
    res = cg.pcg(matvec, b, precon=P, tol=1e-8)
    assert res.converged and res.num_iters > 0
    assert _graph_counts() == before


def test_sharded_solve_never_captures(system, tmp_path):
    """A one-rank gloo group in this process: the row-sharded solve runs
    the eager step (its dot products are collectives), counts no capture
    and no replayed iteration, and equals the unsharded solve."""
    import torch.distributed as dist

    from mlff_tpu_torch.parallel.mesh import RowShard

    matvec, P, b = system
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "s"), 1))
    try:
        layout = RowShard(dist.group.WORLD).layout([N])
        before = _graph_counts()
        got = cg.pcg(matvec, b, precon=P, tol=1e-8, layout=layout)
        assert _graph_counts() == before
    finally:
        dist.destroy_process_group()
    want = cg.pcg(matvec, b, precon=P, tol=1e-8)
    assert got.converged and got.num_iters == want.num_iters
    np.testing.assert_allclose(got.x, want.x, rtol=1e-12, atol=1e-14)


# (vectors on CUDA, the layout's group backend or None for no layout,
# graphed)
RULE = {"card": (True, None, True), "card_nccl": (True, "nccl", True),
        "card_gloo": (True, "gloo", False), "host": (False, None, False)}


@pytest.mark.parametrize("case", sorted(RULE))
def test_a_card_solve_is_graphed_unless_gloo_stages_it(case):
    """The rule reads the input alone: a CUDA right-hand side with no row
    layout, or with one over an NCCL group; a gloo group, which stages
    every collective through the host, and the CPU stay eager."""
    is_cuda, backend, graphed = RULE[case]
    layout = (None if backend is None else
              SimpleNamespace(shard=SimpleNamespace(backend=backend)))
    assert cg._graphed(SimpleNamespace(is_cuda=is_cuda), layout) is graphed
