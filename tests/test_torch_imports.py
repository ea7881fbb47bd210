"""The port stands alone: no module of ``mlff_tpu_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and the entry points run
on the card unless the caller asks for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
SOURCES = sorted(p.relative_to(ROOT).as_posix() for p in
                 [*(ROOT / "mlff_tpu_torch").rglob("*.py"),
                  ROOT / "chip_smoke.py"])
FORBIDDEN = ("jax", "jaxlib", "mlff_tpu")


def _imported_roots(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("source", SOURCES)
def test_source_imports_no_jax(source):
    tree = ast.parse((ROOT / source).read_text(), filename=source)
    bad = sorted(set(_imported_roots(tree)) & set(FORBIDDEN))
    assert not bad, f"{source} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import mlff_tpu_torch.models.gdml, mlff_tpu_torch.convert\n"
            "import mlff_tpu_torch.data.synthetic, mlff_tpu_torch.models.task\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mlff_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


@pytest.mark.parametrize("entry", ["Trainer", "Predictor", "build_cache"])
def test_entry_points_default_to_cuda(entry):
    """Without a card, an entry point called without device="cpu" raises:
    it never moves to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is honoured")
    from mlff_tpu_torch.models.gdml import Trainer
    from mlff_tpu_torch.models.predict import Predictor
    from mlff_tpu_torch.ops.kernel import build_cache

    call = {"Trainer": lambda: Trainer(),
            "Predictor": lambda: Predictor({"z": [1, 1]}),
            "build_cache": lambda: build_cache(None, None, None, None, 1.0,
                                               1e-10)}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
