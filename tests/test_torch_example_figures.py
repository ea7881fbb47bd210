"""``mlff_tpu_torch.tools.make_example_figures`` on the CPU at a small size.

The tool runs the root ``tools/make_example_figures.py``'s sweeps through
the port's experiment harness and renders its four figures through the
port's plotting: into ``--out`` it writes four PNGs and two pickles whose
keys are, key for key, those of the JAX package's pickles under
``examples/measurements/synthetic_ethanol/`` (the sweep's sizes change
values, not keys).  The repository's ``examples/measurements/`` stays
byte for byte as it is.
"""

import hashlib
import pickle
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("matplotlib")

from mlff_tpu_torch.tools import make_example_figures as mef  # noqa: E402

from .torch_threads import one_torch_thread  # noqa: E402,F401

MEASUREMENTS = Path(__file__).resolve().parent.parent / "examples" / \
    "measurements"


def tree_hashes(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_figures_and_pickles_in_the_reference_schema(tmp_path, capsys):
    before = tree_hashes(MEASUREMENTS)
    paths = mef.main(["--out", str(tmp_path), "--device", "cpu"],
                     n_samples=40, n_datapoints=6)
    assert tree_hashes(MEASUREMENTS) == before
    written = sorted(p.relative_to(tmp_path).as_posix()
                     for p in tmp_path.rglob("*") if p.is_file())
    assert written == sorted(p.relative_to(tmp_path).as_posix()
                             for p in paths.values())
    assert sum(w.endswith(".png") for w in written) == 4
    assert sum(w.endswith(".pickle") for w in written) == 2
    for p in paths.values():
        assert p.stat().st_size > 0
    for name in ("multi_strategy_sweep", "spectra_sweep"):
        with open(paths[name], "rb") as f:
            got = pickle.load(f)
        with open(MEASUREMENTS / "synthetic_ethanol" / f"{name}.pickle",
                  "rb") as f:
            want = pickle.load(f)
        assert sorted(got) == sorted(want), name
        for key in want:
            assert type(got[key]) is type(want[key]), (name, key)
    assert "figures written to" in capsys.readouterr().err
