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
"""

from __future__ import annotations

import collections
import os
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

# Window length for the solver-effectiveness estimate
# (reference iterative_solver.py:57-63).
CG_STEPS_HIST_LEN = 100


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


class PCGSolver:
    """PCG on the operator ``matvec(v)`` with preconditioner ``precon(v)``
    (identity when None), advancing ``chunk`` iterations per host check."""

    def __init__(self, matvec: Callable, precon: Callable | None = None,
                 chunk: int = 25, exact_matvec: Callable | None = None):
        self.matvec = matvec
        self.precon = _identity if precon is None else precon
        self.chunk = chunk
        self.exact = exact_matvec

    def _run(self, state: CGState, threshold: torch.Tensor, max_steps: int):
        """Up to ``max_steps`` iterations queued on the device; returns the
        new state and the (chunk,) residual log (NaN where no iteration
        ran).  Iterations after convergence change nothing."""
        state.done = state.done | (state.resid <= threshold)
        resid_log = torch.full((self.chunk,), float("nan"),
                               dtype=state.r.dtype, device=state.r.device)
        x, r, p, rho, resid, it, done = (state.x, state.r, state.p, state.rho,
                                         state.resid, state.it, state.done)
        for i in range(max_steps):
            active = ~done
            z = self.precon(r)
            rho_new = torch.dot(r, z)
            # first iteration overall: p = z; afterwards p = z + beta p
            beta = torch.where(it == 0, torch.zeros_like(rho_new),
                               rho_new / rho)
            p_new = z + beta * p
            q = self.matvec(p_new)
            alpha = rho_new / torch.dot(p_new, q)
            x = torch.where(active, x + alpha * p_new, x)
            r_new = r - alpha * q
            r = torch.where(active, r_new, r)
            p = torch.where(active, p_new, p)
            rho = torch.where(active, rho_new, rho)
            resid = torch.where(active, torch.linalg.norm(r_new), resid)
            resid_log[i] = torch.where(active, resid, resid_log[i])
            it = it + active.to(it.dtype)
            done = done | (resid <= threshold)
        return CGState(x, r, p, rho, resid, it, done), resid_log

    def solve(self, b: torch.Tensor, **kwargs) -> CGResult:
        return _pcg_drive(self._run, self.matvec, b, chunk=self.chunk,
                          exact_matvec=self.exact, **kwargs)


def pcg(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    precon: Callable[[torch.Tensor], torch.Tensor] | None = None,
    chunk: int | None = None,
    exact_matvec: Callable | None = None,
    **kwargs,
) -> CGResult:
    """One-shot convenience wrapper around PCGSolver.

    ``chunk=None`` picks the iterations per host check by problem size:
    larger systems amortize the check over more iterations, at most
    ``chunk - 1`` masked iterations past convergence.  Huge systems (seconds
    per matvec) check often instead.

    ``exact_matvec``: full-precision operator for residual replacement when
    ``matvec`` is inexact — see _pcg_drive."""
    if chunk is None:
        n = b.shape[0]
        chunk = 25 if n < 16384 else (50 if n < 49152 else 100)
        if n >= 300_000:
            chunk = 6
    return PCGSolver(matvec, precon, chunk,
                     exact_matvec=exact_matvec).solve(b, **kwargs)


def _pcg_drive(
    run,
    matvec,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    tol: float = 1e-4,
    maxiter: int | None = None,
    chunk: int = 25,
    callback: Callable | None = None,
    checkpoint_callback: Callable | None = None,
    checkpoint_every_s: float | None = None,
    it0: int = 0,
    break_on_stagnation: bool = False,
    exact_matvec: Callable | None = None,
    replace_every: int = 50,
) -> CGResult:
    """Host driver for the chunked device loop.

    callback(num_iters, resid, eff) is invoked once per chunk with host
    values; checkpoint_callback(x_np, num_iters, resid) roughly every
    ``checkpoint_every_s`` seconds (the reference's unconverged-model
    snapshots, iterative_solver.py:919-954).

    ``exact_matvec`` enables residual replacement for inexact operators:
    every ~``replace_every`` iterations, and before accepting convergence,
    the recursive residual is replaced by the true residual b - A_exact x,
    keeping the search direction and rho.
    """
    n = b.shape[0]
    if checkpoint_every_s is None:
        checkpoint_every_s = float(os.environ.get("MLFF_CKPT_EVERY_S", "120"))
    if maxiter is None:
        maxiter = 10 * n

    x0 = torch.zeros_like(b) if x0 is None else x0.to(b)
    r0 = b - matvec(x0)
    state = CGState(
        x=x0, r=r0, p=torch.zeros_like(b),
        rho=torch.ones((), dtype=b.dtype, device=b.device),
        resid=torch.linalg.norm(r0),
        it=torch.full((), it0, dtype=torch.int64, device=b.device),
        done=torch.zeros((), dtype=torch.bool, device=b.device),
    )
    threshold_t = tol * torch.linalg.norm(b)
    threshold = float(threshold_t)

    resid_hist: list[np.ndarray] = []
    steps_hist: collections.deque = collections.deque(maxlen=CG_STEPS_HIST_LEN)
    prev_resid = float(state.resid)
    eff = 0
    t_start = time.perf_counter()
    t_last_ckpt = t_start
    stagnated = False

    it_after = it0
    last_replace = it0
    while True:
        it_before = it_after
        remaining = maxiter - (it_before - it0)
        if remaining <= 0:
            break
        state, resid_log = run(state, threshold_t, min(chunk, remaining))
        # the one host transfer of the chunk: [log..., it, done, resid]
        head = torch.stack([state.it.to(b.dtype), state.done.to(b.dtype),
                            state.resid])
        fetched = torch.cat([resid_log, head]).cpu().numpy()
        it_after, done = int(fetched[-3]), bool(fetched[-2])
        resid_now = float(fetched[-1])

        if exact_matvec is not None and (
            done or it_after - last_replace >= replace_every
        ):
            # van der Vorst-style residual replacement: swap in the true
            # residual but keep the search direction and rho
            r_true = b - exact_matvec(state.x)
            state.r = r_true
            state.resid = torch.linalg.norm(r_true)
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
        if (checkpoint_callback is not None
                and now - t_last_ckpt >= checkpoint_every_s):
            t_last_ckpt = now
            checkpoint_callback(state.x.cpu().numpy(), it_after, resid_now)

        if done or it_after - it0 >= maxiter or (stagnated and break_on_stagnation):
            break

    resid = float(state.resid)
    return CGResult(
        x=state.x.cpu().numpy(),
        converged=resid <= threshold,
        num_iters=it_after,
        resid=resid,
        resid_hist=np.concatenate(resid_hist) if resid_hist else np.zeros(0),
        eff=eff,
        time_s=time.perf_counter() - t_start,
        stagnated=stagnated and resid > threshold,
    )
