"""One CG iteration's cost at the nanotube's shapes (A = 370, D = 68,265)
on one card.

    python3 -m mlff_tpu_torch.tools.time_nanotube_iter [--n-train 28]
        [--k 4488] [--device cpu]

The port's counterpart of the root ``tools/profile_nanotube_iter.py``.  The
synthetic tube (``make_dataset("nanotube", seed=3)``, P = 1, sigma = 10,
lam = 1e-10): the packed kernel cache with its square fields (``R=``) and
the square-layout operator (``build_cache_square``).  Lines:

    matvec_psd         the packed matvec, ms per call (CUDA events)
    matvec_psd_square  the square-layout matvec (ops/kernel.py)
    assembly           k random columns (seed 0) by ``assemble_columns``
                       (the square assembly on this cache), seconds
    nystrom_build      the split Nystrom preconditioner of those columns
    apply / df64_apply ``woodbury_split_apply`` and ``df64_woodbury_apply``
    pcg_square_xla, pcg_square_none, pcg_square_df64
                       one 50-iteration chunk of ``PCGSolver`` on the
                       square matvec with the f64 apply, with none, with
                       the df64 apply: ms per iteration, busy and idle
                       share, launches per iteration (``device_profile``)
    apply_cost         pcg_square_xla - pcg_square_none per iteration

Times are null on the CPU; ``rel_err_square_vs_packed`` (one matvec of the
two layouts) is computed everywhere.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .. import resolve_device
from ..utils.timing import device_profile
from . import benchlib as bl

SIG, LAM = 10.0, 1e-10
CHUNK = 50


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n-train", type=int, default=28)
    p.add_argument("--k", type=int, default=4488)
    bl.add_device_argument(p)
    return p


def caches(n_train: int, dev) -> tuple:
    """(spec, packed cache with square fields, square cache) of the tube."""
    from ..data.synthetic import make_dataset
    from ..ops import descriptor as dsc
    from ..ops import kernel as knl

    ds = make_dataset("nanotube", n_samples=n_train, seed=3)
    A = ds["R"].shape[1]
    spec = dsc.make_spec(A)
    S = dsc.incidence_matrix(spec, device=dev)
    R = torch.as_tensor(ds["R"], dtype=torch.float64, device=dev)
    X, Jc = dsc.descriptors_from_R(spec, R)
    perms = np.arange(A)[None, :]
    P_idx = dsc.desc_perms(perms)
    cache = knl.build_cache(X, Jc, S, P_idx, SIG, LAM, R=R, device=dev)
    return spec, cache, knl.build_cache_square(R, perms, SIG, LAM,
                                               device=dev)


def chunk_line(dev, matvec, precon, b) -> dict:
    """ms per iteration and the device profile of one chunk."""
    from ..solvers.cg import PCGSolver

    runner = bl.chunk_runner(PCGSolver(matvec, precon, chunk=CHUNK), b,
                             CHUNK)
    ms = bl.event_ms(dev, runner, reps=1, warmup=1)
    prof = device_profile(torch, runner, warmup=0, reps=1, device=dev)
    return {"ms_per_iter": None if ms is None else ms / CHUNK,
            "busy_share": prof["busy_share"],
            "idle_share": prof["idle_share"],
            "launches_per_iter": (None if prof["launches"] is None
                                  else prof["launches"] / CHUNK)}


def run(args, dev) -> list:
    from ..ops import kernel as knl
    from ..solvers import preconditioners as pc

    spec, cache, sq = caches(args.n_train, dev)
    n = cache.n
    name = bl.device_name(dev)
    lines = []

    def emit(line):
        line = dict(line, n=n, k=args.k, D=spec.dim, device=name)
        lines.append(line)
        print(json.dumps(line), flush=True)

    rng = np.random.default_rng(0)
    v = torch.as_tensor(rng.standard_normal(n), device=dev)
    packed = knl.matvec_psd(cache, v)
    square = knl.matvec_psd_square(sq, v)
    emit({"case": "matvec_psd",
          "ms": bl.event_ms(dev, lambda: knl.matvec_psd(cache, v), reps=10),
          "rel_err_square_vs_packed": float((square - packed).abs().max()
                                            / packed.abs().max())})
    emit({"case": "matvec_psd_square",
          "ms": bl.event_ms(dev, lambda: knl.matvec_psd_square(sq, v),
                            reps=10)})
    idxs = pc.select_random(n, args.k, rng)
    _, s = bl.host_s(dev, lambda: knl.assemble_columns(spec, cache, idxs))
    emit({"case": "assembly", "s": s})
    P, s = bl.host_s(dev, lambda: pc.nystrom_preconditioner(spec, cache,
                                                            idxs, LAM))
    emit({"case": "nystrom_build", "s": s})
    emit({"case": "apply",
          "ms": bl.event_ms(dev, lambda: pc.woodbury_split_apply(P, v),
                            reps=10)})

    y = v / torch.linalg.norm(v)
    mv = lambda u: knl.matvec_psd_square(sq, u)       # noqa: E731
    with_apply = chunk_line(dev, mv, P, y)
    emit({"case": "pcg_square_xla", **with_apply})
    without = chunk_line(dev, mv, None, y)
    emit({"case": "pcg_square_none", **without})
    emit({"case": "apply_cost", "ms_per_iter": (
        None if without["ms_per_iter"] is None
        else with_apply["ms_per_iter"] - without["ms_per_iter"])})
    P64 = pc.df64_from_split(P)                       # consumes P.B
    emit({"case": "df64_apply",
          "ms": bl.event_ms(dev, lambda: pc.df64_woodbury_apply(P64, v),
                            reps=10)})
    emit({"case": "pcg_square_df64", **chunk_line(dev, mv, P64, y)})
    return lines


def main(argv=None) -> list:
    args = parser().parse_args(argv)
    return run(args, resolve_device(args.device))


if __name__ == "__main__":
    main()
    sys.exit(0)
