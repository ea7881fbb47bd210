"""The port's symmetry search is the JAX package's: the five cases of
``tests/test_symmetry.py`` run through ``mlff_tpu.models.symmetry`` and
``mlff_tpu_torch.models.symmetry`` on the same inputs give the same arrays,
and the port's meet the reference test's assertions.  Both modules are host
NumPy and SciPy, so equal means equal bits."""

import numpy as np
import pytest

pytest.importorskip("torch")

from mlff_tpu.models import symmetry as jsym  # noqa: E402
from mlff_tpu_torch.models import symmetry as tsym  # noqa: E402


def _water(offset, jitter_rng=None, scale=0.0):
    """One water geometry (O, H, H) in Angstrom, optionally jittered."""
    base = np.array([
        [0.000, 0.000, 0.000],     # O
        [0.958, 0.000, 0.000],     # H
        [-0.239, 0.928, 0.000],    # H
    ])
    if jitter_rng is not None:
        base = base + scale * jitter_rng.normal(size=base.shape)
    return base + np.asarray(offset)


def _both(fn_name, *args):
    """(port result, JAX package result) of one function on one input."""
    got = getattr(tsym, fn_name)(*args)
    want = getattr(jsym, fn_name)(*args)
    np.testing.assert_array_equal(got, want)
    return got


def test_find_perms_recovers_water_h_swap():
    rng = np.random.default_rng(0)
    M = 12
    R = np.stack([_water((0, 0, 0), rng, scale=0.02) for _ in range(M)])
    for i in range(0, M, 2):
        R[i] = R[i][[0, 2, 1]]
    z = np.array([8, 1, 1])
    perms = _both("find_perms", R, z)
    assert any(np.array_equal(p, [0, 2, 1]) for p in perms)
    assert any(np.array_equal(p, [0, 1, 2]) for p in perms)


def test_covalent_adjacency_water_dimer():
    z = np.array([8, 1, 1, 8, 1, 1])
    R0 = np.vstack([_water((0, 0, 0)), _water((6.0, 0, 0))])
    adj = _both("covalent_adjacency", R0, z)
    assert adj[0, 1] and adj[0, 2] and adj[3, 4] and adj[3, 5]
    assert not adj[:3, 3:].any()


def test_find_frag_perms_water_dimer_swap():
    rng = np.random.default_rng(1)
    M = 6
    R = np.stack([
        np.vstack([
            _water((0, 0, 0), rng, scale=0.01),
            _water((6.0, 0, 0), rng, scale=0.01),
        ])
        for _ in range(M)
    ])
    z = np.array([8, 1, 1, 8, 1, 1])
    perms = _both("find_frag_perms", R, z)
    assert perms.shape[1] == 6
    assert any(p[0] == 3 and p[3] == 0 for p in perms)
    for p in perms:
        assert np.array_equal(np.sort(p), np.arange(6))
        assert np.array_equal(z[p], z)


def test_find_frag_perms_single_fragment_is_identity():
    rng = np.random.default_rng(2)
    R = np.stack([_water((0, 0, 0), rng, scale=0.01) for _ in range(3)])
    z = np.array([8, 1, 1])
    perms = _both("find_frag_perms", R, z)
    assert perms.shape == (1, 3)
    assert np.array_equal(perms[0], [0, 1, 2])


def test_find_frag_perms_different_fragments_no_swap():
    rng = np.random.default_rng(3)
    M = 4
    R = np.stack([
        np.vstack([
            _water((0, 0, 0), rng, scale=0.01),
            _water((6.0, 0, 0), rng, scale=0.01)[:2],  # O-H only
        ])
        for _ in range(M)
    ])
    z = np.array([8, 1, 1, 8, 1])
    perms = _both("find_frag_perms", R, z)
    for p in perms:
        assert p[0] == 0 and p[3] == 3
