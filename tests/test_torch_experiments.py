"""The port's experiment harness against the JAX package's (the port's
counterpart of tests/test_experiments.py and of the analysis half of
tests/test_golden_archived.py).

* ``rule_of_thumb``: the closed form, the cost model, ``fit_slope``,
  ``jackknife`` and ``optimal_precon_k`` agree with JAX to 1e-12 relative
  on the same synthetic sweep (they are copies; scipy does the fits).
* ``sweep``: index decoding and the k/n grid are equal; ``main`` with
  ``--index`` writes the pickles of the JAX package's ``main``.
* ``harness``: ``cg_steps`` and ``minimum_preconditioner_size`` at
  N_train = 20 return the keys and shapes of JAX's, PCG iterations within
  +-2 (two f64 solves to tol 1e-4); ``spectra_sweep`` the same keys, and
  the same spectrum of K within 1e-8 of its largest eigenvalue.
* ``benchmark_models``: ``speedup_table`` at N_train = 10 gives the rows of
  JAX's (the same keys, the same CG iterations within +-2, the analytic
  force MAE within 1e-6 relative); ``to_latex`` prints the same table for
  the same rows.
"""

import pickle

import numpy as np
import pytest

pytest.importorskip("torch")

from mlff_tpu.experiments import benchmark_models as jbm  # noqa: E402
from mlff_tpu.experiments import harness as jh  # noqa: E402
from mlff_tpu.experiments import rule_of_thumb as jrot  # noqa: E402
from mlff_tpu.experiments import sweep as jsweep  # noqa: E402
from mlff_tpu_torch.experiments import benchmark_models as bm  # noqa: E402
from mlff_tpu_torch.experiments import harness  # noqa: E402
from mlff_tpu_torch.experiments import rule_of_thumb as rot  # noqa: E402
from mlff_tpu_torch.experiments import sweep  # noqa: E402
from .torch_threads import one_torch_thread  # noqa: E402,F401

RTOL = 1e-12
MOLECULES = sorted(rot.FITTED_PARAMS)


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    assert a.shape == b.shape
    assert np.all(np.abs(a - b) <= rtol * np.abs(b)), (a, b)


def _synthetic_sweep(seed=0, n=20000, m=1.05, k_unity=40.0):
    """A k-sweep that follows the paper's power law with 1% noise, and
    timings of a quadratic preconditioner build and a 1/k CG."""
    rng = np.random.default_rng(seed)
    k = np.geomspace(100, 0.6 * n, 15)
    steps = n * (k / k_unity) ** (-m) * np.exp(rng.normal(0, 0.01, k.size))
    t_pre = 1e-4 * k**2 / 50 * np.exp(rng.normal(0, 0.02, k.size))
    t_cg = 2000.0 / k * np.exp(rng.normal(0, 0.02, k.size))
    return n, k, steps, t_pre, t_cg


def test_fitted_params_are_the_papers():
    assert rot.FITTED_PARAMS == jrot.FITTED_PARAMS
    for name in MOLECULES + ["synthetic_ethanol", "unknown"]:
        assert rot.get_params(name) == jrot.get_params(name)


@pytest.mark.parametrize("name", ["ethanol", "aspirin", "nanotube", "default"])
def test_rule_of_thumb_closed_form_matches_jax(name):
    m, k_unity, _ = rot.get_params(name)
    for n in (540, 15741, 31482, 75000, np.int64(157491)):
        got, want = rot.rule_of_thumb(n, k_unity, m), jrot.rule_of_thumb(n, k_unity, m)
        assert isinstance(got, int) and got == want
    ns = np.geomspace(1e3, 1e6, 25)
    _close(rot.rule_of_thumb(ns, k_unity, m), jrot.rule_of_thumb(ns, k_unity, m))
    assert rot.rule_of_thumb(31482, 10, 0.87) == 2049


@pytest.mark.parametrize("name", ["ethanol", "aspirin", "nanotube"])
def test_cost_model_matches_jax_and_is_minimal_at_the_closed_form(name):
    n = 50000
    m, k_unity, pref = rot.get_params(name)
    ks = np.geomspace(10, n, 2000)
    cost = rot.rule_of_thumb_fn(ks, m, pref, k_unity, n)
    _close(cost, jrot.rule_of_thumb_fn(ks, m, pref, k_unity, n))
    k_star = rot.rule_of_thumb(n, k_unity, m)
    assert abs(np.log(k_star / ks[np.argmin(cost)])) < 0.1


def test_fit_slope_matches_jax():
    n, k, steps, _, _ = _synthetic_sweep()
    got, want = rot.fit_slope(k, steps, n), jrot.fit_slope(k, steps, n)
    _close(got, want)
    assert abs(got[0] - 1.05) < 0.05 and abs(np.log(got[1] / 40.0)) < 0.2
    _close(rot.fit_slope(k, steps, n, mask_fraction=0.3),
           jrot.fit_slope(k, steps, n, mask_fraction=0.3))


def test_jackknife_matches_jax():
    x = np.random.default_rng(3).normal(1.0, 0.1, size=9)
    _close(rot.jackknife(x), jrot.jackknife(x))
    mean, err = rot.jackknife(np.array([1.0, 1.1, 0.9, 1.0]))
    assert abs(mean - 1.0) < 1e-9 and err > 0


@pytest.mark.parametrize("name", ["ethanol", "default"])
def test_optimal_precon_k_matches_jax(name):
    n, k, _, t_pre, t_cg = _synthetic_sweep(seed=1)
    t_solve = t_pre + t_cg
    got = rot.optimal_precon_k(k, t_solve, t_pre, t_cg, n, name)
    want = jrot.optimal_precon_k(k, t_solve, t_pre, t_cg, n, name)
    assert got.keys() == want.keys()
    for key in want:
        _close(got[key], want[key])
    assert got["rule_of_thumb_factor_specific"] >= 1.0


def test_sweep_helpers_match_jax():
    lists = (["a", "b", "c"], ["x", "y"], [1, 2, 3, 4])
    for idx in range(30):
        assert sweep.decode_index(idx, *lists) == jsweep.decode_index(idx, *lists)
        assert sweep.select_value(lists[0], idx) == jsweep.select_value(lists[0], idx)
    for log_spacing in (True, False):
        _close(sweep.create_list_percentage(10000, 8, 100, 0.5, log_spacing),
               jsweep.create_list_percentage(10000, 8, 100, 0.5, log_spacing))
    for name in ("aspirin", "ethanol", "uracil", "nanotube"):
        assert harness.normalize_to_aspirin(100, name) == \
            jh.normalize_to_aspirin(100, name)


@pytest.fixture(scope="module")
def task20(ethanol_ds):
    """The harness's task at N_train = 20 (P from the symmetry search), the
    same in both packages."""
    task = jh.harness_task(ethanol_ds, n_datapoints=20, n_valid=10)
    mine = harness.harness_task(ethanol_ds, n_datapoints=20, n_valid=10)
    assert mine.keys() == task.keys()
    for key in task:
        np.testing.assert_array_equal(np.asarray(mine[key]),
                                      np.asarray(task[key]), err_msg=key)
    return task


def _assert_same_schema(got, want):
    assert got.keys() == want.keys()
    for key, val in want.items():
        if isinstance(val, np.ndarray):
            assert np.asarray(got[key]).shape == val.shape, key


def test_cg_steps_matches_jax(task20):
    want = jh.cg_steps(task20, "lev_random", 0.2)
    got = harness.cg_steps(task20, "lev_random", 0.2, device="cpu")
    _assert_same_schema(got, want)
    assert got["n_kernel"] == want["n_kernel"] == 20 * 9 * 3
    assert got["K.shape"] == want["K.shape"] and got["k"] == want["k"]
    assert got["is_conv"] and want["is_conv"]
    assert abs(int(got["lev_random_cgsteps"][0])
               - int(want["lev_random_cgsteps"][0])) <= 2
    assert got["device"] == "cpu"
    for key in ("lev_random_total_time_solve",
                "lev_random_total_time_preconditioner", "lev_random_total_time_cg"):
        assert np.all(np.isfinite(got[key])) and got[key][0] > 0


def test_minimum_preconditioner_size_matches_jax(task20, tmp_path):
    """The merged k-sweep: the same keys and shapes, iterations within +-2
    at each k, fewer iterations at the largest k than at the smallest; one
    pickle per k under the reference's directory layout."""
    ps = np.array([0.05, 0.1, 0.2, 0.4])
    want = jh.minimum_preconditioner_size(task20, "lev_random", percentages=ps)
    got = harness.minimum_preconditioner_size(
        task20, "lev_random", percentages=ps, out_dir=tmp_path, device="cpu")
    _assert_same_schema(got, want)
    _close(got["lev_random_percentage"], want["lev_random_percentage"])
    it_t, it_j = got["lev_random_cgsteps"], want["lev_random_cgsteps"]
    assert it_t.shape == (4,) and np.all(np.abs(it_t - it_j) <= 2)
    assert it_t[0] > it_t[-1]
    pickles = sorted((tmp_path / str(task20["dataset_name"]) / "lev_random"
                      / "n = 540").glob("*.pickle"))
    assert len(pickles) == 4
    with open(pickles[0], "rb") as f:
        assert "lev_random_cgsteps" in pickle.load(f)


def test_spectra_sweep_keys_match_jax(ethanol_ds):
    task = jh.harness_task(ethanol_ds, n_datapoints=8, sig=5.0, n_valid=6,
                           use_sym=False)
    grid = (("random_scores",), (0.1, 0.3))
    want = jh.spectra_sweep(task, *grid)
    got = harness.spectra_sweep(task, *grid, device="cpu")
    _assert_same_schema(got, want)
    n = int(got["K.shape"][0])
    for key in want:
        if key.startswith("eigvals_"):
            assert len(got[key]) == len(want[key]) == n, key
    raw_t, raw_j = got["eigvals_random_scores_0"], want["eigvals_random_scores_0"]
    assert np.abs(raw_t - raw_j).max() <= 1e-8 * np.abs(raw_j).max()


def test_sweep_main_writes_the_pickles_of_jax(tmp_path):
    """``--index 1`` over two strategies picks lev_random for ethanol in
    both packages; the pickles land under the same names with the same
    keys."""
    argv = ["--preconditioners", "random_scores", "lev_random", "--index",
            "1", "--n-datapoints-aspirin", "8", "--n-measurements", "2",
            "--min-columns", "60", "--max-percentage", "0.3"]
    assert jsweep.main(argv + ["--out-dir", str(tmp_path / "jax")]) == 0
    assert sweep.main(argv + ["--out-dir", str(tmp_path / "port"),
                              "--device", "cpu"]) == 0
    tree = {}
    for side in ("jax", "port"):
        files = sorted((tmp_path / side).rglob("*.pickle"))
        tree[side] = [p.relative_to(tmp_path / side).parent for p in files]
        tree[side + "_keys"] = []
        for p in files:
            with open(p, "rb") as f:
                tree[side + "_keys"].append(sorted(pickle.load(f)))
    assert tree["port"] == tree["jax"] and len(tree["port"]) == 2
    assert all(str(p).startswith("synthetic_ethanol/lev_random")
               or str(p).startswith("ethanol/lev_random") for p in tree["port"])
    assert tree["port_keys"] == tree["jax_keys"]


def test_speedup_table_and_to_latex_match_jax(tmp_path):
    want = jbm.speedup_table(["ethanol"], n_train=10)
    got = bm.speedup_table(["ethanol"], n_train=10, out_dir=tmp_path,
                           device="cpu")
    (row_t,), (row_j,) = got, want
    assert row_t.keys() == row_j.keys()
    assert row_t["n_kernel"] == row_j["n_kernel"] == 10 * 9 * 3
    assert abs(row_t["cg_iters"] - row_j["cg_iters"]) <= 2
    _close(row_t["f_mae_analytic"], row_j["f_mae_analytic"], 1e-6)
    assert row_t["runtime_analytic_s"] > 0 and row_t["runtime_cg_s"] > 0
    stored = sorted(p.relative_to(tmp_path).as_posix()
                    for p in tmp_path.rglob("*.npz"))
    assert [s.split("/")[:2] for s in stored] == [["models", "gpu"]] * 2
    assert {s.split("/")[3] for s in stored} == {"analytic", "cg"}
    assert bm.to_latex(got) == jbm.to_latex(got)
    assert bm.to_latex(got).count("\\\\\n") == 2
