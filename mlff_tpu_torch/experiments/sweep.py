"""Sweep runner: array-job index decoding and the CG-experiment entry point.

PyTorch port of ``mlff_tpu.experiments.sweep`` (reference:
scripts/cluster_main.py:9-151): an integer ``--index`` is mixed-radix-decoded
over the cross product (preconditioner x dataset) so one array job covers a
whole sweep; here the same decoding drives local process-level sweeps.  The
helpers are copies of the JAX package's; ``main`` takes ``--device``
(default ``cuda``).

    python -m mlff_tpu_torch.experiments.sweep --index 0 --out-dir data_new
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from .. import resolve_device
from ..data.synthetic import MOLECULES, make_dataset
from ..utils.log import get_logger
from .harness import harness_task, minimum_preconditioner_size, normalize_to_aspirin

log = get_logger(__name__)


def select_value(values: list, index: int) -> tuple[object, int]:
    """Pop one coordinate of a mixed-radix index
    (reference cluster_main.py:96-106): returns (values[index % len], index // len)."""
    return values[index % len(values)], index // len(values)


def decode_index(index: int, *value_lists: list) -> list:
    """Decode a flat array-job index into one combination across the given
    value lists (applied left to right, like repeated select_value calls)."""
    out = []
    for values in value_lists:
        v, index = select_value(values, index)
        out.append(v)
    return out


def create_list_percentage(
    n_kernel: int, n_measurements: int, min_columns: int,
    max_percentage: float, log_spacing: bool = True,
) -> np.ndarray:
    """k/n grid for a sweep (reference cluster_main.py:59-93 semantics)."""
    lo = min_columns / n_kernel
    fn = np.geomspace if log_spacing else np.linspace
    return fn(lo, max_percentage, n_measurements)


def main(argv=None):
    p = argparse.ArgumentParser(description="CG preconditioner sweep")
    p.add_argument("--datasets", nargs="*", default=["ethanol"],
                   choices=sorted(MOLECULES))
    p.add_argument("--preconditioners", nargs="*", default=["random_scores"])
    p.add_argument("--n-datapoints-aspirin", type=int, default=40,
                   help="aspirin-equivalent training size (n-matching)")
    p.add_argument("--n-measurements", type=int, default=8)
    p.add_argument("--min-columns", type=int, default=50)
    p.add_argument("--max-percentage", type=float, default=0.5)
    p.add_argument("--linear-spacing", action="store_true")
    p.add_argument("--calculate-eigvals", action="store_true")
    p.add_argument("--index", type=int, default=None,
                   help="array-job style flat index into the sweep cross product")
    p.add_argument("--out-dir", default="data_new")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    combos = []
    if args.index is not None:
        precon, ds_name = decode_index(
            args.index, args.preconditioners, args.datasets
        )
        combos = [(precon, ds_name)]
    else:
        combos = [(p_, d_) for p_ in args.preconditioners for d_ in args.datasets]

    for precon, ds_name in combos:
        n_train = normalize_to_aspirin(args.n_datapoints_aspirin, ds_name)
        ds = make_dataset(ds_name, n_samples=max(4 * n_train, 400))
        task = harness_task(ds, n_train)
        log.info("sweep: %s / %s (n_train=%d)", ds_name, precon, n_train)
        res = minimum_preconditioner_size(
            task, precon,
            n_measurements=args.n_measurements,
            min_columns=args.min_columns,
            max_percentage=args.max_percentage,
            log_spacing=not args.linear_spacing,
            out_dir=Path(args.out_dir),
            device=device,
        )
        log.info("cg steps: %s", res.get(f"{precon}_cgsteps"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
