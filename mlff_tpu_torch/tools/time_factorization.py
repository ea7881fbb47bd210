"""The split Nystrom factorization's stages, each on its own, on one card.

    python3 -m mlff_tpu_torch.tools.time_factorization [--n 31482]
        [--m 2049] [--device cpu]

The port's counterpart of the root ``tools/profile_factorization.py``,
for the stages of the port's ``solvers/preconditioners.py::
_nystrom_factor_split`` at an (n, m) factor.  The columns are synthetic and
PSD-structured, made on the device from seed 0: K_nm = Z Z[idxs]^T for a
random Z (n, m) ~ N(0, 1/n) and m sorted random rows idxs, so that K_mm =
K_nm[idxs] is a Gram matrix, as a kernel's is (the host Cholesky needs
one).  Stages, each run ``REPEAT`` = 2 times, seconds on the host's clock
from a synchronized device to a synchronized device:

    gather_Kmm     K_nm[idxs] on the device
    d2h_Kmm        its copy to the host
    sym_Kmm        symmetrized from its lower triangle on the host (with
                   the copy, ``_host_sym``)
    host_W1        _host_whiten_factor (host LAPACK Cholesky, the port's
                   default method "chol_host"; the root timed eigh)
    h2d_W1         W1 to the device
    whiten         B = K_nm W1 (cuBLAS)
    gram           B^T B (cuBLAS)
    d2h_inner      the Gram's copy to the host
    sym_inner      symmetrized on the host
    gram_probe     the Gram guard's probe (_gram_probe)
    host_W2        _host_inner_isqrt (host LAPACK)
    h2d_W2         W2 to the device
    project        (B W2)^T, the fused factor that leverage scores read
                   (_nystrom_factor_eigh)

One JSON line per stage (``s`` = the runs' seconds, null on the CPU) and a
``check`` line: ``gram_probe_err`` and ``whiten_err`` = max |W1^T K_mm W1 -
I| (the whitening's quality, which the Cholesky's jitter and K_mm's
conditioning set), computed everywhere.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch

from .. import resolve_device
from . import benchlib as bl

LAM = 1e-10
RANK_TOL = 1e-10
HOST_DECOMP = "chol"
REPEAT = 2


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=31482)
    p.add_argument("--m", type=int, default=2049)
    bl.add_device_argument(p)
    return p


def columns(n: int, m: int, dev, seed: int = 0) -> tuple:
    """(K_nm (n, m), idxs (m,)): K_nm = Z Z[idxs]^T for Z ~ N(0, 1/n)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    Z = torch.randn((n, m), generator=g, dtype=torch.float64,
                    device=dev) / math.sqrt(n)
    idxs = np.sort(np.random.default_rng(seed).choice(n, size=m,
                                                      replace=False))
    return Z @ Z[torch.as_tensor(idxs, device=dev)].T, idxs


def symmetrized(M: np.ndarray) -> np.ndarray:
    """The host half of ``preconditioners._host_sym``: the symmetric matrix
    of M's lower triangle."""
    from ..solvers import preconditioners as pc

    return pc._unpack_sym(M[np.tril_indices(M.shape[0])], M.shape[0])


def stages(K_nm: torch.Tensor, idxs: np.ndarray) -> tuple[dict, dict]:
    """(state, {stage: zero-argument callable}), the stages in order; each
    reads what the stages before it left in ``state``."""
    from ..solvers import preconditioners as pc

    dev = K_nm.device
    state = {}

    def put(key, value):
        state[key] = value
        return value

    idx_dev = torch.as_tensor(idxs, device=dev)
    return state, {
        "gather_Kmm": lambda: put("Kmm_dev", K_nm[idx_dev]),
        "d2h_Kmm": lambda: put("Kmm_h", state["Kmm_dev"].cpu().numpy()),
        "sym_Kmm": lambda: put("Kmm", symmetrized(state["Kmm_h"])),
        "host_W1": lambda: put("W1_h", pc._host_whiten_factor(
            state["Kmm"].copy(), RANK_TOL, HOST_DECOMP)),
        "h2d_W1": lambda: put("W1", torch.as_tensor(
            state["W1_h"], dtype=torch.float64, device=dev)),
        "whiten": lambda: put("B", K_nm @ state["W1"]),
        "gram": lambda: put("inner_dev", state["B"].T @ state["B"]),
        "d2h_inner": lambda: put("inner_h", state["inner_dev"].cpu().numpy()),
        "sym_inner": lambda: put("inner", symmetrized(state["inner_h"])),
        "gram_probe": lambda: put("probe_err", pc._gram_probe(
            state["B"], state["inner"])),
        "host_W2": lambda: put("W2_h", pc._host_inner_isqrt(
            state["inner"].copy(), LAM, HOST_DECOMP)),
        "h2d_W2": lambda: put("W2", torch.as_tensor(
            state["W2_h"], dtype=torch.float64, device=dev)),
        "project": lambda: put("T", (state["B"] @ state["W2"]).T),
    }


def run(args, dev) -> list:
    K_nm, idxs = columns(args.n, args.m, dev)
    state, steps = stages(K_nm, idxs)
    name = bl.device_name(dev)
    lines = []

    def emit(line):
        line = dict(line, n=args.n, m=args.m, device=name)
        lines.append(line)
        print(json.dumps(line), flush=True)

    for stage, fn in steps.items():
        emit({"stage": stage, "s": [bl.host_s(dev, fn)[1]
                                    for _ in range(REPEAT)]})
    W1 = state["W1_h"]
    emit({"stage": "check", "gram_probe_err": state["probe_err"],
          "whiten_err": float(np.abs(W1.T @ state["Kmm"] @ W1
                                     - np.eye(args.m)).max())})
    return lines


def main(argv=None) -> list:
    args = parser().parse_args(argv)
    return run(args, resolve_device(args.device))


if __name__ == "__main__":
    main()
    sys.exit(0)
