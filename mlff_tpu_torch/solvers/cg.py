"""Preconditioned conjugate gradients, scipy-semantics-compatible, chunked.

PyTorch port of ``mlff_tpu.solvers.cg`` (reference:
sgdml/solvers/iterative_solver.py:874-1005).  Same math, same stopping rule
(||r|| <= tol * ||b||, recursively updated residual, checked before each
iteration), same iteration counting as scipy's ``cg``.

The iterations run in chunks whose device work is queued without a host
round trip: convergence is tracked as a device flag, iterations after it
leave the state unchanged (masked with ``torch.where``), and the host reads
the flag, the iteration count and the chunk's residual log in ONE transfer
per chunk.  The host loop between chunks handles convergence, the
stagnation telemetry (the reference's 100-step efficiency window),
residual replacement and checkpointing.

On a row-sharded operator (``layout``, a ``parallel.mesh.VecLayout``) the
vectors are this rank's rows: the dot products and norms are all-reduced,
so every rank takes the same steps and stops at the same iteration, and the
iterate handed to the checkpoint callback and returned is gathered whole on
every rank.

On the card (``b`` on CUDA, with no ``layout`` or a layout over an NCCL
group) a chunk's iterations are not queued op by op from Python: the
solve's first iteration runs eagerly as the warm-up, one iteration is then
captured as a CUDA graph over fixed state buffers, and every later
iteration of the solve replays it (the host queues one graph launch instead
of ~57 kernels).  On a row-sharded operator the graph holds the iteration's
NCCL collectives too; every rank captures at the same step and replays as
often, since the host loop decides from all-reduced values.  The graph is
released when the solve returns, before the group can be torn down.  On
the CPU, and over a gloo group (which stages each collective through host
memory), the same iteration runs eagerly.
"""

from __future__ import annotations

import collections
import functools
import os
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..utils import trace

# Window length for the solver-effectiveness estimate
# (reference iterative_solver.py:57-63).
CG_STEPS_HIST_LEN = 100

# counters (utils.trace): iterations run by replaying the captured
# iteration, and captures (one per graphed solve, on every rank)
GRAPH_ITERS = "cg.graph_iters"
GRAPH_CAPTURES = "cg.graph_captures"

_FIELDS = ("x", "r", "p", "rho", "resid", "it", "done")


@dataclass
class CGState:
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rho: torch.Tensor      # r^T z from the previous accepted step
    resid: torch.Tensor    # ||r||
    it: torch.Tensor       # global iteration counter (device int64)
    done: torch.Tensor     # convergence flag (device bool)


@dataclass
class CGResult:
    x: np.ndarray
    converged: bool
    num_iters: int
    resid: float
    resid_hist: np.ndarray
    eff: int = 0
    time_s: float = 0.0
    stagnated: bool = False


def _identity(v):
    return v


def _dot(layout, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a, b) if layout is None else layout.shard.dot(a, b)


def _norm(layout, r: torch.Tensor) -> torch.Tensor:
    return (torch.linalg.norm(r) if layout is None
            else torch.sqrt(layout.shard.dot(r, r)))


def _graphed(b: torch.Tensor, layout) -> bool:
    """Whether the iteration is captured and replayed: the vectors on CUDA,
    and no row layout or one whose group is NCCL, which leaves the
    collectives' tensors on the card (gloo stages them through the
    host)."""
    return b.is_cuda and (layout is None or layout.shard.backend == "nccl")


def _whole(layout, x: torch.Tensor) -> np.ndarray:
    """The iterate as a host array, gathered on a row-sharded operator."""
    return (x if layout is None else layout.gather(x)).cpu().numpy()


class PCGSolver:
    """PCG on the operator ``matvec(v)`` with preconditioner ``precon(v)``
    (identity when None), advancing ``chunk`` iterations per host check."""

    def __init__(self, matvec: Callable, precon: Callable | None = None,
                 chunk: int = 25, exact_matvec: Callable | None = None,
                 layout=None):
        self.matvec = matvec
        self.precon = _identity if precon is None else precon
        self.chunk = chunk
        self.exact = exact_matvec
        self.layout = layout
        self.eager_steps = 0      # the last chunk's first steps, run eagerly
        self._release()

    def _run(self, state: CGState, threshold: torch.Tensor, max_steps: int):
        """Up to ``max_steps`` iterations queued on the device; returns the
        state and the (chunk,) residual log (NaN where no iteration ran),
        both over the solver's own buffers, which the next call
        overwrites.  Iterations after convergence change nothing."""
        loop = self._loop
        if loop is None:
            loop = self._loop = _Loop(state, threshold, self.chunk)
        loop.load(state, threshold)
        if _graphed(state.r, self.layout):
            self._replay(loop, max_steps)
        else:
            for _ in range(max_steps):
                self._step(loop)
            self.eager_steps = max_steps
        return loop.state(), loop.log

    def _step(self, s: _Loop) -> None:
        """One PCG iteration on the buffers ``s``, in place.  After
        convergence it changes nothing but the log entry (NaN) and
        ``slot``."""
        active = ~s.done
        z = self.precon(s.r)
        rho_new = _dot(self.layout, s.r, z)
        # first iteration overall: p = z; afterwards p = z + beta p
        beta = torch.where(s.it == 0, s.zero, rho_new / s.rho)
        p_new = z + beta * s.p
        q = self.matvec(p_new)
        alpha = rho_new / _dot(self.layout, p_new, q)
        torch.where(active, s.x + alpha * p_new, s.x, out=s.x)
        r_new = s.r - alpha * q
        torch.where(active, r_new, s.r, out=s.r)
        torch.where(active, p_new, s.p, out=s.p)
        torch.where(active, rho_new, s.rho, out=s.rho)
        torch.where(active, _norm(self.layout, r_new), s.resid, out=s.resid)
        s.log.index_copy_(0, s.slot,
                          torch.where(active, s.resid, s.nan).view(1))
        s.slot.add_(1)
        s.it.add_(active)
        s.done |= s.resid <= s.threshold

    def _replay(self, loop: _Loop, steps: int) -> None:
        """``steps`` iterations on the card: the solve's first iteration
        eagerly (the warm-up, on the capture stream, so that its first-use
        allocations and the collectives' setup are made outside the
        capture), then one iteration captured as a CUDA graph, replayed for
        this and every later iteration.  The capture records without
        running: the counters it moved are taken back out, and added again
        per replay, and the spans it opened are not kept.  It holds only
        this thread's calls to account (``thread_local``): NCCL's watchdog
        thread queries its events meanwhile."""
        self.eager_steps = 0
        if steps and self._graph is None:
            stream, anchor = _capture_target(loop.r.device)
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                self._step(loop)
                with trace.span("cg.capture"), trace.counted() as counts, \
                        trace.unrecorded():
                    graph = torch.cuda.CUDAGraph()
                    graph.capture_begin(pool=anchor.pool(),
                                        capture_error_mode="thread_local")
                    try:
                        self._step(loop)
                    finally:
                        graph.capture_end()
            torch.cuda.current_stream().wait_stream(stream)
            trace.add(counts, -1)
            trace.count(GRAPH_CAPTURES)
            self._graph, self._graph_counts = graph, counts
            self.eager_steps = 1
        for _ in range(steps - self.eager_steps):
            self._graph.replay()
        if steps:
            trace.add(self._graph_counts, steps - self.eager_steps)

    def _release(self) -> None:
        """Drop the buffers and the graph, whose kernels read the
        operator's and the preconditioner's tensors."""
        self._loop = self._graph = self._graph_counts = None

    def solve(self, b: torch.Tensor, **kwargs) -> CGResult:
        try:
            return _pcg_drive(self, b, **kwargs)
        finally:
            self._release()


class _Loop:
    """The tensors one iteration reads and writes in place: the ``CGState``
    fields, the threshold, the chunk's residual log and ``slot``, the log
    entry the next iteration writes (a device index, so that one captured
    iteration serves every step of a chunk); and the constants 0 and NaN,
    which a Python number would make anew, one fill kernel each, per
    iteration."""

    def __init__(self, state: CGState, threshold: torch.Tensor, chunk: int):
        for f in _FIELDS:
            setattr(self, f, torch.empty_like(getattr(state, f)))
        self.threshold = torch.empty_like(threshold)
        self.log = torch.empty(chunk, dtype=state.r.dtype,
                               device=state.r.device)
        self.slot = torch.empty(1, dtype=torch.int64, device=state.r.device)
        self.zero = torch.zeros_like(state.rho)
        self.nan = torch.full_like(state.resid, float("nan"))

    def load(self, state: CGState, threshold: torch.Tensor) -> None:
        """Start a chunk from ``state``: copy in each field that is not
        already this buffer, flag convergence, empty the log."""
        for f in _FIELDS:
            src = getattr(state, f)
            if src is not getattr(self, f):
                getattr(self, f).copy_(src)
        self.threshold.copy_(threshold)
        self.done |= self.resid <= self.threshold
        self.log.fill_(float("nan"))
        self.slot.zero_()

    def state(self) -> CGState:
        return CGState(*(getattr(self, f) for f in _FIELDS))


@functools.lru_cache(maxsize=None)
def _capture_target(device: torch.device):
    """(stream, graph) of the captures on ``device``, one each per
    process.  The warm-up leaves its first-use allocations (cuBLAS
    workspaces, kernel scratch) on the stream.  The graph, of one kernel
    and never replayed, holds the memory pool that every capture shares
    (``CUDAGraph.pool``): a released graph's blocks serve the next
    capture, where a pool of its own per solve would stay reserved until
    the allocator runs short."""
    with torch.cuda.device(device):
        stream, anchor = torch.cuda.Stream(), torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            anchor.capture_begin()
            torch.zeros(1, device=device)
            anchor.capture_end()
    return stream, anchor


def pcg(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    precon: Callable[[torch.Tensor], torch.Tensor] | None = None,
    chunk: int | None = None,
    exact_matvec: Callable | None = None,
    layout=None,
    **kwargs,
) -> CGResult:
    """One-shot convenience wrapper around PCGSolver.

    ``chunk=None`` picks the iterations per host check by problem size:
    larger systems amortize the check over more iterations, at most
    ``chunk - 1`` masked iterations past convergence.  Huge systems (seconds
    per matvec) check often instead.

    ``exact_matvec``: full-precision operator for residual replacement when
    ``matvec`` is inexact — see _pcg_drive.  ``layout``: the row layout of
    a sharded operator (``b`` and the vectors are this rank's rows)."""
    if chunk is None:
        n = b.shape[0] if layout is None else layout.n
        chunk = 25 if n < 16384 else (50 if n < 49152 else 100)
        if n >= 300_000:
            chunk = 6
    return PCGSolver(matvec, precon, chunk, exact_matvec=exact_matvec,
                     layout=layout).solve(b, **kwargs)


def _pcg_drive(
    solver: PCGSolver,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    tol: float = 1e-4,
    maxiter: int | None = None,
    callback: Callable | None = None,
    checkpoint_callback: Callable | None = None,
    checkpoint_every_s: float | None = None,
    it0: int = 0,
    break_on_stagnation: bool = False,
    replace_every: int = 50,
) -> CGResult:
    """Host driver for the chunked device loop.

    callback(num_iters, resid, eff) is invoked once per chunk with host
    values; checkpoint_callback(x_np, num_iters, resid) roughly every
    ``checkpoint_every_s`` seconds (the reference's unconverged-model
    snapshots, iterative_solver.py:919-954).

    The solver's ``exact`` operator enables residual replacement for
    inexact operators: every ~``replace_every`` iterations, and before
    accepting convergence, the recursive residual is replaced by the true
    residual b - A_exact x, keeping the search direction and rho.

    On a sharded operator (the solver's ``layout``) the checkpoint callback
    runs on every rank with the gathered iterate (the caller writes on one
    rank).

    Spans (``utils.trace``): ``cg``, from the loop's start to the iterate
    in host memory (its seconds are ``time_s``; attribute ``iters``), and
    per chunk ``cg.chunk``, the host queueing it (attributes ``steps``
    queued and ``iters`` run), and ``cg.read``, its one transfer; in the
    first chunk of a graphed solve, ``cg.capture``.  Counter
    ``cg.graph_iters``: the iterations that ran by replay.
    """
    matvec, chunk, layout = solver.matvec, solver.chunk, solver.layout
    exact_matvec = solver.exact
    n = b.shape[0] if layout is None else layout.n
    if checkpoint_every_s is None:
        checkpoint_every_s = float(os.environ.get("MLFF_CKPT_EVERY_S", "120"))
    if maxiter is None:
        maxiter = 10 * n

    x0 = torch.zeros_like(b) if x0 is None else x0.to(b)
    r0 = b - matvec(x0)
    state = CGState(
        x=x0, r=r0, p=torch.zeros_like(b),
        rho=torch.ones((), dtype=b.dtype, device=b.device),
        resid=_norm(layout, r0),
        it=torch.full((), it0, dtype=torch.int64, device=b.device),
        done=torch.zeros((), dtype=torch.bool, device=b.device),
    )
    threshold_t = tol * _norm(layout, b)
    threshold = float(threshold_t)

    resid_hist: list[np.ndarray] = []
    steps_hist: collections.deque = collections.deque(maxlen=CG_STEPS_HIST_LEN)
    prev_resid = float(state.resid)
    eff = 0
    stagnated = False

    with trace.timed("cg") as t_cg:
        t_last_ckpt = t_cg.start
        it_after = it0
        last_replace = it0
        while True:
            it_before = it_after
            remaining = maxiter - (it_before - it0)
            if remaining <= 0:
                break
            steps = min(chunk, remaining)
            with trace.span("cg.chunk") as queued:
                state, resid_log = solver._run(state, threshold_t, steps)
            with trace.span("cg.read"):
                # the one host transfer of the chunk: [log..., it, done, resid]
                head = torch.stack([state.it.to(b.dtype),
                                    state.done.to(b.dtype), state.resid])
                fetched = torch.cat([resid_log, head]).cpu().numpy()
            it_after, done = int(fetched[-3]), bool(fetched[-2])
            queued.set("steps", steps)
            queued.set("iters", it_after - it_before)
            # the chunk's iterations are its first steps, the eager ones first
            trace.count(GRAPH_ITERS,
                        max(0, it_after - it_before - solver.eager_steps))
            resid_now = float(fetched[-1])

            if exact_matvec is not None and (
                done or it_after - last_replace >= replace_every
            ):
                # van der Vorst-style residual replacement: swap in the true
                # residual but keep the search direction and rho
                r_true = b - exact_matvec(state.x)
                state.r = r_true
                state.resid = _norm(layout, r_true)
                state.done = state.resid <= threshold_t
                resid_now = float(state.resid)
                done = resid_now <= threshold
                last_replace = it_after

            log = fetched[: it_after - it_before]
            resid_hist.append(log)
            for rv in log:
                steps_hist.append(rv - prev_resid)
                prev_resid = float(rv)

            # solver effectiveness: fraction of downhill steps in the window,
            # rescaled to [-100, 100] (reference iterative_solver.py:886-897).
            arr = np.array(steps_hist)
            tot = np.abs(arr).sum()
            ratio = (-arr.clip(max=0).sum() / tot) if tot > 0 else 1.0
            eff = 0 if it_after == 0 else (int(100 * ratio) - 50) * 2
            if len(steps_hist) == CG_STEPS_HIST_LEN and eff <= 0:
                stagnated = True

            if callback is not None:
                callback(it_after, resid_now, eff)

            now = time.perf_counter()
            due = (checkpoint_callback is not None
                   and now - t_last_ckpt >= checkpoint_every_s)
            if layout is not None and checkpoint_callback is not None:
                due = layout.shard.any(due)      # the gather is collective
            if due:
                t_last_ckpt = now
                checkpoint_callback(_whole(layout, state.x), it_after,
                                    resid_now)

            if done or it_after - it0 >= maxiter or (
                    stagnated and break_on_stagnation):
                break

        resid = float(state.resid)
        x = _whole(layout, state.x)
        t_cg.set("iters", it_after - it0)
    return CGResult(
        x=x,
        converged=resid <= threshold,
        num_iters=it_after,
        resid=resid,
        resid_hist=np.concatenate(resid_hist) if resid_hist else np.zeros(0),
        eff=eff,
        time_s=t_cg.seconds,
        stagnated=stagnated and resid > threshold,
    )
