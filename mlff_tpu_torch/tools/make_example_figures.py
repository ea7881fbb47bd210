"""The example harness sweeps and the paper's four figure families, through
the port's experiment harness and plotting.

    python3 -m mlff_tpu_torch.tools.make_example_figures [--out DIR]
        [--device cpu]

The port's counterpart of the root ``tools/make_example_figures.py``: real
k-sweeps and preconditioned spectra on synthetic ethanol (120 samples of
seed 7, 50 training points, sigma = 5, 30 validation points, no symmetry
search) through ``experiments.harness`` (``minimum_preconditioner_size``
for each of STRATEGIES at six k/n from 3% to 40%, ``spectra_sweep`` of
three strategies at 5, 15 and 40%), pickled in the reference schema, and
rendered by ``experiments.plotting``: CG steps against k, the spectrum
grid, the difference to the SVD baseline (eigvec_precon) and the
rule-of-thumb prediction.  Everything is written under ``--out`` (created;
default ``example_figures``): ``synthetic_ethanol/multi_strategy_sweep.pickle``,
``synthetic_ethanol/spectra_sweep.pickle`` and four PNGs.  The repository's
``examples/measurements/`` holds the JAX package's run and is never written.
Plotting needs matplotlib; the trainings run on ``--device``.  The tool
times nothing.
"""

from __future__ import annotations

import argparse
import pickle
import sys
from pathlib import Path

import numpy as np

from .. import resolve_device
from . import benchlib as bl

STRATEGIES = ("eigvec_precon", "cholesky", "lev_random", "random_scores")
SPECTRA = ("eigvec_precon", "lev_random", "random_scores")
SPECTRA_PERCENTAGES = (0.05, 0.15, 0.4)
N_SAMPLES, N_DATAPOINTS = 120, 50


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default="example_figures",
                   help="directory the pickles and figures go to")
    bl.add_device_argument(p)
    return p


def run(out: Path, dev, n_samples: int = N_SAMPLES,
        n_datapoints: int = N_DATAPOINTS) -> dict:
    """Sweeps, pickles and figures under ``out``: {name: path} of what was
    written."""
    from ..data.synthetic import make_dataset
    from ..experiments import plotting
    from ..experiments.harness import (
        harness_task, merge_sweeps, minimum_preconditioner_size,
        spectra_sweep)

    ds = make_dataset("ethanol", n_samples=n_samples, seed=7)
    task = harness_task(ds, n_datapoints=n_datapoints, sig=5.0, n_valid=30,
                        use_sym=False)
    n = int(np.asarray(task["F_train"]).size)
    bl.log(f"n = {n}")
    percentages = np.geomspace(0.03, 0.4, 6)
    sweeps = [minimum_preconditioner_size(task, s, percentages=percentages,
                                          device=dev) for s in STRATEGIES]
    merged = merge_sweeps(sweeps)
    spec = spectra_sweep(task, SPECTRA, SPECTRA_PERCENTAGES, device=dev)
    data = out / "synthetic_ethanol"
    data.mkdir(parents=True, exist_ok=True)
    paths = {"multi_strategy_sweep": data / "multi_strategy_sweep.pickle",
             "spectra_sweep": data / "spectra_sweep.pickle",
             "cg_steps_vs_k": out / "ethanol_cg_steps_vs_k.png",
             "spectrum_grid": out / "ethanol_spectrum_grid.png",
             "diff_to_svd": out / "ethanol_diff_to_svd.png",
             "rule_of_thumb": out / "ethanol_rule_of_thumb.png"}
    for key, obj in (("multi_strategy_sweep", merged),
                     ("spectra_sweep", spec)):
        with open(paths[key], "wb") as f:
            pickle.dump(obj, f)
    plotting.plot_cg_steps_vs_k(dict(zip(STRATEGIES, sweeps)), n,
                                paths["cg_steps_vs_k"])
    plotting.plot_spectrum_grid(spec, paths["spectrum_grid"])
    plotting.plot_cg_steps_difference(merged, "eigvec_precon",
                                      paths["diff_to_svd"])
    plotting.plot_rule_of_thumb_prediction(n, "ethanol",
                                           paths["rule_of_thumb"])
    bl.log(f"figures written to {out}")
    return paths


def main(argv=None, n_samples: int = N_SAMPLES,
         n_datapoints: int = N_DATAPOINTS) -> dict:
    """``n_samples``, ``n_datapoints``: a test's smaller sweep (the tool's
    size is N_SAMPLES, N_DATAPOINTS)."""
    args = parser().parse_args(argv)
    return run(Path(args.out), resolve_device(args.device), n_samples,
               n_datapoints)


if __name__ == "__main__":
    main()
    sys.exit(0)
