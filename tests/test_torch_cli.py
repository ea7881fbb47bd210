"""The port's CLI (``python -m mlff_tpu_torch.cli``) against the JAX
package's, driven in-process on one dataset npz in separate directories,
with ``--device cpu`` for the port.

* ``all`` (create -> train -> select -> test) with ``--solver analytic``:
  equal task files key for key, models within 1e-7 relative on the
  coefficients (two LAPACKs' Cholesky solves, as in
  tests/test_torch_periodic.py), the selected model the same, the
  ``validate`` and ``test`` tables within 1e-8 relative.
* The same with ``--solver cg --preconditioner lev_random --tol 1e-6``:
  the same selected sigma, PCG iterations within +-2, tables within 1e-4
  relative, the limits of the ``reference`` phase of chip_smoke.py.  At the
  default tol 1e-4 two solves leave the validation cosine MAE ~1.3e-4
  apart; at 1e-6 the tables agree to ~1e-6.
* Files cross: a task written by the JAX CLI trains in the port's
  ``train``, and a model written by the port validates in the JAX CLI with
  the port's table; ``show`` prints what the JAX CLI prints; ``resume``
  warm-starts; a tampered dataset fails ``resume``; ``--E-cstr`` trains
  energy-constrained models whose tables (energies included) are the JAX
  CLI's.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from mlff_tpu import cli as jcli  # noqa: E402
from mlff_tpu_torch import cli  # noqa: E402
from mlff_tpu_torch.utils import io  # noqa: E402
from .torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent
FIELDS = ("f_mae", "f_rmse", "mag_mae", "mag_rmse", "cos_mae", "cos_rmse")
COMMON = ["18", "--n-valid", "20", "--sig", "4", "6", "--task-dir", "run",
          "--n-test", "30"]
SOLVERS = {
    # solver: (extra arguments, tolerance of the tables, of the coefficients)
    "analytic": ([], 1e-8, 1e-7),
    "cg": (["--solver", "cg", "--preconditioner", "lev_random",
            "--break-percentage", "0.25", "--tol", "1e-6"], 1e-4, None),
}


def _run(main, argv, cwd):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        return main([str(a) for a in argv])
    finally:
        os.chdir(old)


def _load(path):
    with np.load(path, allow_pickle=True) as f:
        return {k: f[k] for k in f.files}


def _assert_tables_close(got, want, rtol):
    assert got.n_points == want.n_points
    for field in FIELDS:
        g, w = getattr(got, field), getattr(want, field)
        assert abs(g - w) <= rtol * abs(w), (field, g, w)


@pytest.fixture(scope="module")
def ds_path(tmp_path_factory, ethanol_ds):
    path = tmp_path_factory.mktemp("clids") / "ethanol.npz"
    io.save_dataset(path, ethanol_ds)
    return path


@pytest.fixture(scope="module", params=sorted(SOLVERS))
def pipelines(request, tmp_path_factory, ds_path):
    """``all`` run by both CLIs: (solver, jax dir, port dir, jax table,
    port table)."""
    extra, _, _ = SOLVERS[request.param]
    wj = tmp_path_factory.mktemp(f"jax_{request.param}")
    wt = tmp_path_factory.mktemp(f"port_{request.param}")
    res_j = _run(jcli.main, ["all", ds_path, *COMMON, *extra], wj)
    res_t = _run(cli.main, ["all", ds_path, *COMMON, *extra,
                            "--device", "cpu"], wt)
    return request.param, wj / "run", wt / "run", res_j, res_t


def test_all_writes_the_files_of_the_jax_cli(pipelines):
    _, dj, dt, _, _ = pipelines
    names = sorted(p.name for p in dt.iterdir())
    assert names == sorted(p.name for p in dj.iterdir()) == [
        "best_model.npz", "model-sig0004.npz", "model-sig0006.npz",
        "task-sig0004.npz", "task-sig0006.npz"]
    for name in ("task-sig0004.npz", "task-sig0006.npz"):
        tj, tt = _load(dj / name), _load(dt / name)
        assert set(tt) == set(tj)
        for key in tj:
            np.testing.assert_array_equal(tt[key], tj[key], err_msg=key)


def test_all_trains_and_selects_like_the_jax_cli(pipelines):
    solver, dj, dt, res_j, res_t = pipelines
    _, table_rtol, alpha_rtol = SOLVERS[solver]
    for name in ("model-sig0004.npz", "model-sig0006.npz", "best_model.npz"):
        mj, mt = _load(dj / name), _load(dt / name)
        assert set(mt) == set(mj)
        assert str(mt["solver_name"]) == solver
        if alpha_rtol is not None:
            assert (np.abs(mt["alphas_F"] - mj["alphas_F"]).max()
                    <= alpha_rtol * np.abs(mj["alphas_F"]).max())
        else:
            assert abs(int(mt["solver_iters"]) - int(mj["solver_iters"])) <= 2
            assert bool(mt["is_conv"]) and bool(mj["is_conv"])
    assert float(_load(dt / "best_model.npz")["sig"]) == float(
        _load(dj / "best_model.npz")["sig"])
    assert res_t.n_points == 30
    _assert_tables_close(res_t, res_j, table_rtol)


def test_validate_tables_match_jax(pipelines, ds_path, capsys):
    solver, dj, dt, _, _ = pipelines
    res_j = _run(jcli.main, ["validate", dj / "best_model.npz", ds_path], dj)
    res_t = _run(cli.main, ["validate", dt / "best_model.npz", ds_path,
                            "--device", "cpu"], dt)
    _assert_tables_close(res_t, res_j, SOLVERS[solver][1])
    out = capsys.readouterr().out
    assert out.count("[validation] n=20") == 2


def test_port_model_validates_in_the_jax_cli(pipelines, ds_path):
    """A model file written by the port gives, in the JAX CLI, the table the
    port's CLI gives for it (1e-10: the same coefficients, two f64
    Predictors)."""
    _, _, dt, _, _ = pipelines
    model = dt / "best_model.npz"
    res_j = _run(jcli.main, ["validate", model, ds_path], dt)
    res_t = _run(cli.main, ["validate", model, ds_path, "--device", "cpu"], dt)
    _assert_tables_close(res_t, res_j, 1e-10)


def test_jax_task_trains_in_the_port(tmp_path, ds_path, monkeypatch):
    """``create`` by the JAX CLI, ``train`` by the port's; a snapshot every
    chunk goes to *_unconv_model.npz, which train removes at the end."""
    monkeypatch.setenv("MLFF_CKPT_EVERY_S", "0")
    _run(jcli.main, ["create", ds_path, "12", "--n-valid", "10", "--sig", "5",
                     "--solver", "cg", "--task-dir", "xrun"], tmp_path)
    saved = []
    real_save = cli.io.save_model
    monkeypatch.setattr(cli.io, "save_model",
                        lambda path, d: (saved.append(Path(path).name),
                                         real_save(path, d)))
    models = _run(cli.main, ["train", "xrun", "--preconditioner",
                             "lev_random", "--break-percentage", "0.3",
                             "--device", "cpu"], tmp_path)
    assert [p.name for p in models] == ["model-sig0005.npz"]
    assert saved[0] == "task-sig0005_unconv_model.npz"
    assert saved[-1] == "model-sig0005.npz"
    assert not list((tmp_path / "xrun").glob("*_unconv_model.npz"))
    m = io.load_model(tmp_path / models[0])
    assert bool(m["is_conv"]) and float(m["sig"]) == 5.0


def test_show_prints_what_the_jax_cli_prints(pipelines, ds_path, capsys):
    _, _, dt, _, _ = pipelines
    for path in (dt / "best_model.npz", dt / "task-sig0004.npz", ds_path):
        _run(jcli.main, ["show", path], dt)
        want = capsys.readouterr().out
        _run(cli.main, ["show", path], dt)
        assert capsys.readouterr().out == want
    assert want.startswith("dataset file:")


def test_resume_and_reset(tmp_path, ds_path):
    """resume of a converged cg model: the warm start converges at once and
    solver_iters carries over; reset removes the task directory."""
    _run(cli.main, ["create", ds_path, "12", "--n-valid", "10", "--sig", "5",
                    "--solver", "cg", "--task-dir", "rrun"], tmp_path)
    (model_path,) = _run(cli.main, ["train", "rrun", "--device", "cpu"],
                         tmp_path)
    out = _run(cli.main, ["resume", model_path, ds_path,
                          "--preconditioner", "random_scores",
                          "--break-percentage", "0.2", "--device", "cpu"],
               tmp_path)
    assert out == model_path.with_suffix(".resumed.npz")
    assert (tmp_path / out).exists()
    before = io.load_model(tmp_path / model_path)
    after = io.load_model(tmp_path / out)
    assert bool(after["is_conv"])
    assert int(before["solver_iters"]) <= int(after["solver_iters"]) \
        <= int(before["solver_iters"]) + 2
    _run(cli.main, ["reset", "rrun"], tmp_path)
    assert not (tmp_path / "rrun").exists()


def test_resume_rejects_bad_fingerprint(tmp_path, ds_path, ethanol_ds):
    bad = dict(ethanol_ds)
    bad["F"] = np.asarray(bad["F"]) * 2.0
    io.save_dataset(tmp_path / "tampered.npz", bad)
    _run(cli.main, ["create", ds_path, "10", "--n-valid", "5", "--sig", "4",
                    "--task-dir", "run2"], tmp_path)
    _run(cli.main, ["train", "run2", "--device", "cpu"], tmp_path)
    model = next((tmp_path / "run2").glob("model-*.npz"))
    with pytest.raises(ValueError, match="fingerprint"):
        _run(cli.main, ["resume", model, tmp_path / "tampered.npz",
                        "--device", "cpu"], tmp_path)


def test_energy_constraints_train_like_the_jax_cli(tmp_path_factory,
                                                   ds_path):
    """``all --E-cstr`` with the analytic solver in both CLIs: models with
    energy coefficients and c the training energies' mean, and test tables
    within 1e-6 relative, energy errors included (the constrained system's
    two LAPACK solves agree to ~1e-7 in what they predict,
    tests/test_torch_ecstr.py)."""
    argv = ["all", ds_path, "10", "--n-valid", "5", "--sig", "4",
            "--E-cstr", "--n-test", "20", "--task-dir", "erun"]
    wj, wt = (tmp_path_factory.mktemp(d) for d in ("jax_ecstr", "port_ecstr"))
    res_j = _run(jcli.main, argv, wj)
    res_t = _run(cli.main, [*argv, "--device", "cpu"], wt)
    mj, mt = (_load(w / "erun" / "best_model.npz") for w in (wj, wt))
    assert set(mt) == set(mj)
    assert mt["alphas_E"].shape == (10,)
    assert float(mt["c"]) == float(mj["c"])
    _assert_tables_close(res_t, res_j, 1e-6)
    for field in ("e_mae", "e_rmse"):
        g, w = getattr(res_t, field), getattr(res_j, field)
        assert np.isfinite(w) and abs(g - w) <= 1e-6 * abs(w), (field, g, w)


def test_module_help_exits_zero():
    proc = subprocess.run([sys.executable, "-m", "mlff_tpu_torch.cli",
                           "--help"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for verb in ("create", "train", "resume", "validate", "select", "test",
                 "show", "reset", "all"):
        assert verb in proc.stdout
