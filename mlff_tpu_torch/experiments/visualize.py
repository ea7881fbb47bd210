"""Molecule visualization: kernel-eigenvector atomic contributions.

PyTorch port of ``mlff_tpu.experiments.visualize`` (reference:
src/visualize_molecules.py:12-25 ``calculate_atomic_contributions`` and
src/tools/plot_routines_molecules.py): kernel eigenvectors projected onto
per-atom 3-vectors and drawn as heat on a 2-D molecule sketch.  Host code:
it takes NumPy arrays or tensors (of any device) and computes in NumPy.
matplotlib is imported when a figure is drawn (headless, ``Agg``); without
it a drawing call raises ImportError, and nothing else needs it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def pyplot():
    """matplotlib.pyplot on the headless Agg backend; ImportError naming
    matplotlib when it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("drawing figures needs matplotlib, which is not "
                          "installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def calculate_atomic_contributions(eigvec, n_atoms: int) -> np.ndarray:
    """Per-atom contribution weights of one kernel eigenvector.

    The length-n eigenvector is reshaped to (n_train, n_atoms, 3); the
    contribution of atom a is the mean over training points of the 3-vector
    norms (reference visualize_molecules.py:12-25)."""
    v = _np(eigvec).reshape(-1, n_atoms, 3)
    return np.linalg.norm(v, axis=2).mean(axis=0)


def plot_atomic_contributions(r, z, contributions, out: str | Path,
                              bond_cutoff: float = 1.8, title: str = ""):
    """2-D molecule sketch with atoms colored by contribution weight
    (reference plot_routines_molecules.plot_atomic_contributions)."""
    plt = pyplot()
    r = _np(r).reshape(-1, 3)
    xy = r[:, :2]
    fig, ax = plt.subplots(figsize=(5, 5))
    # bonds: all pairs within the cutoff
    for i in range(len(r)):
        for j in range(i + 1, len(r)):
            if np.linalg.norm(r[i] - r[j]) < bond_cutoff:
                ax.plot(*zip(xy[i], xy[j]), color="0.7", lw=1.5, zorder=1)
    sizes = 120 + 60 * (_np(z) > 1)
    sc = ax.scatter(xy[:, 0], xy[:, 1], c=_np(contributions), s=sizes,
                    cmap="viridis", edgecolors="k", zorder=2)
    fig.colorbar(sc, label="atomic contribution")
    ax.set_aspect("equal")
    ax.set_axis_off()
    if title:
        ax.set_title(title)
    fig.savefig(out, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return Path(out)


def plot_single_molecule(r, z, out, bond_cutoff: float = 1.8):
    """Plain molecule sketch (reference
    plot_routines_molecules.plot_single_molecule)."""
    return plot_atomic_contributions(
        r, z, np.zeros(len(_np(z))), out, bond_cutoff=bond_cutoff)
