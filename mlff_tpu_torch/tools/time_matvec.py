"""The kernel matvec taken apart by stage on one card: prefixes of its
stages, the Woodbury apply and the whole matvec, each over 50 chained
calls.

    python3 -m mlff_tpu_torch.tools.time_matvec [--device cpu]

The port's counterpart of the root ``tools/profile_matvec.py``, on its
system: easy synthetic ethanol (N_TRAIN = 583 samples of seed 7), the six
permutations of the first three atoms (P = 6), sigma = 10, lam = 1e-10,
n = 15,741.  The stages are those of the port's matvec
(``ops/kernel.py::matvec_ref`` and ``desc_forces``), in order:

    w       the Jacobian contraction d_desc_dot_vec       (N, D)
    gather  the permuted cotangents perm_expand_w         (M, D)
    ct      sum(Xqt * wt)                                 (M,)
    dot     Xq wt^T - ct                                  (N, M)
    G       A_exp * dot                                   (N, M)
    rowsum  sum_m G                                       (N, 1)
    F1      Xq rowsum - G Xqt                             (N, D)
    F2      A_exp1 wt                                     (N, D)
    full    lam v - vec_dot_d_desc(F1 - F2): matvec_psd   (n,)

Each prefix (the stages up to and including one) runs LOOP = 50 times,
each call's input depending on the last one's output (``v + acc * 1e-30``,
as the root chains its loop), between two CUDA events: ms per call.  Then
the dense Woodbury apply ``(u - T^T (T u)) / lam`` with a random T of
0.1 n rows, and ``matvec_psd`` itself, over the same chained loop.  One JSON
line per prefix and one each for the apply and the matvec; on the CPU the
times are null and each line keeps its stage's output shape.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .. import resolve_device
from . import benchlib as bl

N_TRAIN, N_ATOMS, SIG, LAM = 583, 9, 10.0, 1e-10
LOOP = 50
STAGES = ("w", "gather", "ct", "dot", "G", "rowsum", "F1", "F2", "full")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    bl.add_device_argument(p)
    return p


def stage_outputs(cache, v: torch.Tensor, upto: str | None = None) -> dict:
    """{stage: output} of the matvec's stages on ``v``, in order, up to and
    including ``upto`` (all of them by default); the last, ``full``, is
    ``matvec_psd(cache, v)``."""
    from ..ops import descriptor as dsc
    from ..ops import kernel as knl

    N, A = cache.n_train, cache.S.shape[1]
    out = {}

    def done(name, value):
        out[name] = value
        return name == upto

    w = dsc.d_desc_dot_vec(cache.Jc, cache.S, v.reshape(N, A, 3))
    if done("w", w):
        return out
    wt = knl.perm_expand_w(w, cache.P_idx)
    if done("gather", wt):
        return out
    ct = torch.sum(cache.Xqt * wt, dim=1)
    if done("ct", ct):
        return out
    dot = cache.Xq @ wt.T - ct[None, :]
    if done("dot", dot):
        return out
    G = cache.A_exp * dot
    if done("G", G):
        return out
    rowsum = torch.sum(G, dim=1, keepdim=True)
    if done("rowsum", rowsum):
        return out
    F1 = cache.Xq * rowsum - G @ cache.Xqt
    if done("F1", F1):
        return out
    F2 = cache.A_exp1 @ wt
    if done("F2", F2):
        return out
    done("full", cache.lam * v
         - dsc.vec_dot_d_desc(cache.Jc, cache.S, F1 - F2).reshape(-1))
    return out


def chained_ms(dev, fn, v0: torch.Tensor, loop: int = LOOP) -> float | None:
    """ms per call of ``fn`` over ``loop`` chained calls by CUDA events
    (one warm loop first); None on the CPU."""
    def chain():
        acc = torch.zeros((), dtype=v0.dtype, device=v0.device)
        for _ in range(loop):
            acc = acc + torch.sum(fn(v0 + acc * 1e-30))
        return acc

    ms = bl.event_ms(dev, chain, reps=1, warmup=1)
    return None if ms is None else ms / loop


def system(n_train: int, dev):
    """(cache, v0, T) of the root tool's system."""
    from ..ops import descriptor as dsc
    from ..ops import kernel as knl
    from ..data.synthetic import make_dataset
    from .bench_scaling import ethanol_perms

    ds = make_dataset("ethanol", n_samples=n_train, seed=7)
    spec = dsc.make_spec(N_ATOMS)
    S = dsc.incidence_matrix(spec, device=dev)
    P_idx = dsc.desc_perms(ethanol_perms())
    X, Jc = dsc.descriptors_from_R(
        spec, torch.as_tensor(ds["R"], dtype=torch.float64, device=dev))
    cache = knl.build_cache(X, Jc, S, P_idx, SIG, LAM, device=dev)
    n = cache.n
    rng = np.random.default_rng(0)
    v0 = torch.as_tensor(rng.normal(size=n), device=dev)
    T = torch.as_tensor(rng.normal(size=(int(0.1 * n), n)), device=dev)
    return cache, v0, T


def run(dev, n_train: int = N_TRAIN) -> list:
    from ..ops import kernel as knl

    cache, v0, T = system(n_train, dev)
    name = bl.device_name(dev)
    shapes = {k: list(v.shape) for k, v in stage_outputs(cache, v0).items()}
    lines = []

    def emit(line):
        line = dict(line, n=cache.n, P=cache.n_perms, loop=LOOP, device=name)
        lines.append(line)
        print(json.dumps(line), flush=True)

    for stage in STAGES:
        emit({"case": "matvec_upto", "stage": stage, "shape": shapes[stage],
              "ms": chained_ms(dev, lambda v, s=stage:
                               stage_outputs(cache, v, s)[s], v0)})
    emit({"case": "woodbury_apply", "shape": list(T.shape),
          "ms": chained_ms(dev, lambda u: (u - T.T @ (T @ u)) / LAM, v0)})
    emit({"case": "matvec_psd",
          "ms": chained_ms(dev, lambda v: knl.matvec_psd(cache, v), v0)})
    return lines


def main(argv=None, n_train: int = N_TRAIN) -> list:
    """``n_train``: a test's smaller system (the tool's size is N_TRAIN)."""
    args = parser().parse_args(argv)
    return run(resolve_device(args.device), n_train)


if __name__ == "__main__":
    main()
    sys.exit(0)
