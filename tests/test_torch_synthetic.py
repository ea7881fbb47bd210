"""The port's synthetic data generator is the JAX package's, to the bit.

Every card phase of ``chip_smoke.py`` draws its data from
``mlff_tpu_torch/data/synthetic.py`` while the CPU tests draw theirs from
``mlff_tpu/data/synthetic.py``; equal seeds must give bitwise-equal arrays,
so the calibration constants (temperatures, modes, jitter, geometry class,
the per-scale ``by_n_train`` overlays) of the two copies cannot drift
apart.  Both are host NumPy.
"""

import numpy as np
import pytest

from mlff_tpu.data import synthetic as js
from mlff_tpu_torch.data import synthetic as ts

# (molecule, n_train selecting the calibration entry): the card phases'
# and the measurement tools' (``mlff_tpu_torch/tools/``): run_500k's 18,666,
# bench_time_to_solution's aspirin and bench_molecule_table's uracil at
# n ~ 31,400
BENCHMARKS = [("ethanol", 1166), ("ethanol", 5833), ("aspirin", 250),
              ("catcher", 119), ("nanotube", 14), ("ethanol", 18666),
              ("aspirin", 498), ("uracil", 872)]


def _assert_same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for key in a:
        x, y = np.asarray(a[key]), np.asarray(b[key])
        assert x.dtype == y.dtype and x.shape == y.shape, key
        assert x.tobytes() == y.tobytes(), key


@pytest.mark.parametrize("name,n_train", BENCHMARKS,
                         ids=[f"{m}-{n}" for m, n in BENCHMARKS])
def test_benchmark_dataset_is_bitwise_the_jax_one(name, n_train):
    kw = dict(n_samples=6, seed=11, n_train=n_train)
    ds_t, perms_t = ts.make_benchmark_dataset(name, **kw)
    ds_j, perms_j = js.make_benchmark_dataset(name, **kw)
    _assert_same(ds_t, ds_j)
    assert perms_t.tobytes() == perms_j.tobytes()


@pytest.mark.parametrize("name", ["ethanol", "aspirin", "catcher",
                                  "nanotube"])
def test_benchmark_perms_are_the_jax_ones(name):
    p_t, p_j = ts.benchmark_perms(name), js.benchmark_perms(name)
    assert p_t.dtype == p_j.dtype and p_t.tobytes() == p_j.tobytes()
    assert np.array_equal(p_t[0], np.arange(p_t.shape[1]))


@pytest.mark.parametrize("name,seed", [("ethanol", 3), ("aspirin", 5),
                                       ("catcher", 5)])
def test_make_dataset_is_bitwise_the_jax_one(name, seed):
    _assert_same(ts.make_dataset(name, n_samples=8, seed=seed),
                 js.make_dataset(name, n_samples=8, seed=seed))
