"""The manifest keeps the benchmark's contract, and the harness finds every
configuration, traffic mix, limit and metric by the name it gives."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import harness
from benchmark.tests import tiny

M = harness.load_json(harness.MANIFEST)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in M["workloads"]]
METRICS = M["end_to_end"] + M["per_layer"]


def test_top_level_keys_and_sizes():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(M)) < 64 * 1024
    assert M["paths"] == ["benchmark"]
    assert 1 <= M["run_seconds"] <= 51
    assert all(isinstance(w, str) and not w.startswith("/") and ".." not in w
               for w in M["command"])


def test_names_units_and_keys():
    names = [x["name"] for x in M["configs"] + M["workloads"] + METRICS]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in M["end_to_end"]}
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def chips_errors(m: dict) -> list:
    """What breaks the rules of cells on more than one card: at most
    max(1, a quarter of the cells, rounded down) of them; each a training
    whose configuration's N divides over its cards (the row-sharded
    operator needs it)."""
    errors = []
    work = m["workloads"]
    multi = [w for w in work if w["chips"] > 1]
    if len(multi) > max(1, len(work) // 4):
        errors.append(f"{len(multi)} of {len(work)} cells on more than one "
                      "card")
    files = {c["name"]: c["file"] for c in m["configs"]}
    for w in multi:
        kind = harness.load_json(
            harness.HERE / "traffic" / f"{w['traffic']}.json")["kind"]
        if kind != "train":
            errors.append(f"{w['name']}: a {kind} cell on {w['chips']} cards")
        n = harness.load_json(harness.ROOT / files[w["config"]])["n_train"]
        if n % w["chips"]:
            errors.append(f"{w['name']}: N = {n} does not divide over "
                          f"{w['chips']} cards")
    return errors


def test_cells_on_four_cards():
    assert chips_errors(M) == []


def sharded(tmp_path, n_train: int, cells) -> dict:
    """The manifest with a configuration of ``n_train`` points and cells
    ``(name, traffic)`` on four cards of it."""
    c = harness.load_json(harness.ROOT / M["configs"][0]["file"])
    path = tmp_path / "ethanol-sharded.json"
    path.write_text(json.dumps(dict(c, name="ethanol-sharded",
                                    n_train=n_train)))
    config = dict(M["configs"][0], name="ethanol-sharded", file=str(path))
    return dict(M, configs=M["configs"] + [config], workloads=M["workloads"] + [
        {"name": name, "config": "ethanol-sharded", "traffic": traffic,
         "chips": 4, "why": "rehearsal"} for name, traffic in cells])


@pytest.mark.parametrize("n_train, cells, error", [
    (5832, [("a", "train")], None),
    (5832, [("a", "train"), ("b", "md")], f"2 of {len(CELLS) + 2} cells"),
    (5832, [("a", "predict")], "a predict cell on 4 cards"),
    (5833, [("a", "train")], "N = 5833 does not divide over 4 cards"),
], ids=["room", "past_the_share", "not_training", "rows_do_not_divide"])
def test_cells_on_four_cards_rules(tmp_path, n_train, cells, error):
    errors = chips_errors(sharded(tmp_path, n_train, cells))
    if error is None:
        assert errors == []
    else:
        assert any(error in e for e in errors), errors


def test_workloads_key_alone_picks_the_cells():
    """A metric's ``workloads`` names its cells; without the key every cell
    reports it, whatever it moves."""
    m = dict(M, per_layer=[{"name": "x", "moves": "nothing"},
                           {"name": "y", "moves": "setup_s",
                            "workloads": [CELLS[0]]}])
    first = harness.find_cell(CELLS[0], m)
    last = harness.find_cell(CELLS[-1], m)
    assert [x["name"] for x in first.per_layer] == ["x", "y"]
    assert [x["name"] for x in last.per_layer] == ["x"]


def test_held_back_cells_are_out_of_the_manifest():
    """A held-back cell's entries name nothing ``BENCHMARK.json`` has, and
    bring back entries of every kind they left."""
    names = {x["name"] for k in ("workloads", "end_to_end", "per_layer")
             for x in M[k]}
    held = {x["name"] for k in tiny.HELD_BACK for x in tiny.HELD_BACK[k]}
    assert tiny.HELD_CELLS and not names & held
    assert set(tiny.HELD_BACK) == {"workloads", "end_to_end", "per_layer"}


@pytest.mark.parametrize("name", CELLS + tiny.HELD_CELLS)
def test_cell_found_by_name(name):
    cell = harness.find_cell(name, tiny.manifest())
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(harness.reader(m["name"]).read)
    for m in cell.end_to_end:
        assert callable(harness.reader(m["name"]).read)
    assert cell.mix["kind"] in ("train", "predict")
    assert set(cell.limits) == ({"desc_err", "w_err", "resid"}
                                if cell.mix["kind"] == "train"
                                else {"F_err", "E_err"})


@pytest.mark.parametrize("config", M["configs"], ids=lambda c: c["name"])
def test_configuration_file(config):
    c = harness.load_json(harness.ROOT / config["file"])
    assert c["name"] == config["name"]
    A = len(c["z"])
    assert c["n_atoms"] == A and c["descriptor_dim"] == A * (A - 1) // 2
    assert c["n"] == 3 * A * c["n_train"]
    assert c["n_train_perms"] == c["n_train"] * c["n_perms"]
    assert len(c["perms"]) == c["n_perms"]
    assert config["reduced"] == []
    assert config["name"] in {w["config"] for w in M["workloads"]}


def test_forbidden_modules_compares_whole_top_level_names():
    assert harness.forbidden_modules(
        ["mlff_tpu_torch", "mlff_tpu_torch.ops.kernel", "jaxtyping",
         "numpy"]) == []
    assert harness.forbidden_modules(
        ["mlff_tpu.ops", "jax.numpy", "flax", "jaxlib.xla_client"]) == [
        "flax", "jax", "jaxlib", "mlff_tpu"]


def test_nothing_forbidden_is_loaded_by_a_run(tmp_path):
    """A fresh process that imports every module a run imports, the port's
    entries included, loads neither JAX nor the JAX package."""
    import subprocess
    import sys

    code = ("import benchmark.run, benchmark.harness, benchmark.devtrace, "
            "benchmark.ranks, "
            "benchmark.calibrate, benchmark.kinds.train, "
            "benchmark.kinds.predict; "
            "import mlff_tpu_torch.models.gdml, mlff_tpu_torch.models.task, "
            "mlff_tpu_torch.models.predict, "
            "mlff_tpu_torch.solvers.preconditioners; "
            "from benchmark import harness; "
            "[harness.reader(m['name']) for m in "
            "harness.load_json(harness.MANIFEST)['per_layer'] + "
            "harness.load_json(harness.MANIFEST)['end_to_end']]; "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
