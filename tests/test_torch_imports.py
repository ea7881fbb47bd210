"""The port stands alone: no module of ``mlff_tpu_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and the entry points run
on the card unless the caller asks for the CPU."""

import ast
import functools
import importlib
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
# the measurement tools' command lines, without --device
TOOL_ARGV = {"bench": [], "bench_time_to_solution": [],
             "bench_k_sweep_31k": [], "bench_scaling": [],
             "bench_molecule_table": ["ethanol"], "bench_nanotube": [],
             "run_500k": ["--probe"],
             # the per-layer timing tools
             **{name: [] for name in (
                 "time_chunk_parts", "time_cg_iter", "time_matvec",
                 "time_woodbury_apply", "time_woodbury_f32", "exp_f32_apply",
                 "time_factorization", "time_nanotube_iter",
                 "time_ozaki_matvec", "time_ozaki_loop", "time_otf_parts",
                 "make_example_figures")}}
LAZY_API = ("Trainer", "Predictor", "create_task", "make_dataset", "evaluate")


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
    """Nor matplotlib, which the card's machine lacks: the figure modules
    import it when they draw."""
    code = ("import sys\n"
            "import mlff_tpu_torch.models.gdml, mlff_tpu_torch.convert\n"
            "import mlff_tpu_torch.data.synthetic, mlff_tpu_torch.models.task\n"
            "import mlff_tpu_torch.cli, mlff_tpu_torch.experiments.harness\n"
            "import mlff_tpu_torch.parallel.mesh\n"
            "import mlff_tpu_torch.parallel.distributed\n"
            "import mlff_tpu_torch.experiments.prototypes\n"
            "import mlff_tpu_torch.experiments.plotting\n"
            "import mlff_tpu_torch.experiments.visualize\n"
            "import mlff_tpu_torch.tools.bench\n"
            "import mlff_tpu_torch.tools.bench_time_to_solution\n"
            "import mlff_tpu_torch.tools.bench_k_sweep_31k\n"
            "import mlff_tpu_torch.tools.bench_scaling\n"
            "import mlff_tpu_torch.tools.bench_molecule_table\n"
            "import mlff_tpu_torch.tools.bench_nanotube\n"
            "import mlff_tpu_torch.tools.run_500k\n"
            + "".join(f"import mlff_tpu_torch.tools.{name}\n"
                      for name in TOOL_ARGV) +
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mlff_tpu', 'matplotlib')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


@pytest.mark.parametrize("entry", ["Trainer", "Predictor", "build_cache",
                                   "cli.main", "evaluate", "cg_steps",
                                   "train_model", "gp_regression",
                                   "init_distributed",
                                   *[f"tools.{name}" for name in TOOL_ARGV]])
def test_entry_points_default_to_cuda(entry, tmp_path):
    """Without a card, an entry point called without device="cpu" (the CLI
    without --device cpu) raises: it never moves to the CPU on its own, and
    the CLI writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is honoured")
    from mlff_tpu_torch import cli
    from mlff_tpu_torch.experiments.benchmark_models import train_model
    from mlff_tpu_torch.experiments.harness import cg_steps
    from mlff_tpu_torch.models.evaluate import evaluate
    from mlff_tpu_torch.models.gdml import Trainer
    from mlff_tpu_torch.models.predict import Predictor
    from mlff_tpu_torch.experiments.prototypes import gp_regression
    from mlff_tpu_torch.ops.kernel import build_cache
    from mlff_tpu_torch.parallel.distributed import init_distributed

    call = {"Trainer": lambda: Trainer(),
            "Predictor": lambda: Predictor({"z": [1, 1]}),
            "build_cache": lambda: build_cache(None, None, None, None, 1.0,
                                               1e-10),
            "cli.main": lambda: cli.main(["all", str(tmp_path / "d.npz"), "10",
                                          "--task-dir", str(tmp_path / "t")]),
            "evaluate": lambda: evaluate({"z": [1, 1]}, {}),
            "cg_steps": lambda: cg_steps({}, "lev_random", 0.1),
            "train_model": lambda: train_model({}, 10, "cg"),
            "gp_regression": lambda: gp_regression([[0.0]], [0.0], [[0.0]]),
            # the default backend follows the default device
            "init_distributed": lambda: init_distributed(world_size=2),
            # each measurement tool, run as its command line runs it
            **{f"tools.{name}": functools.partial(
                importlib.import_module(f"mlff_tpu_torch.tools.{name}").main,
                argv) for name, argv in TOOL_ARGV.items()}}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    assert not list(tmp_path.iterdir())


def test_importing_the_package_loads_no_module_of_it():
    """The lazy top-level API keeps ``import mlff_tpu_torch`` light."""
    code = ("import sys\n"
            "import mlff_tpu_torch\n"
            "bad = [m for m in sys.modules if m.startswith('mlff_tpu_torch.')]\n"
            "assert not bad, bad\n"
            "assert callable(mlff_tpu_torch.Trainer)\n"
            "assert 'mlff_tpu_torch.models.gdml' in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


@pytest.mark.parametrize("name", LAZY_API)
def test_lazy_api_names_the_reference_objects(name):
    import mlff_tpu
    import mlff_tpu_torch

    ported, reference = getattr(mlff_tpu_torch, name), getattr(mlff_tpu, name)
    assert ported.__name__ == reference.__name__ == name
    assert ported.__module__ == reference.__module__.replace(
        "mlff_tpu.", "mlff_tpu_torch.", 1)
    with pytest.raises(AttributeError):
        getattr(mlff_tpu_torch, "no_such_name")
