"""The launch geometry of the df64 GEMV kernels
(``mlff_tpu_torch.ops.df64_gemv.plan``), checked without a card.

The kernels stream B through shared-memory stages of 8 rows x 768 columns;
``plan`` decides how the stages of both passes are dealt to the blocks of
a persistent grid.  For every shape here the stages must tile B exactly
once, fit the card's limits (232,448 bytes of shared memory per block on an
H100, 132 SMs), and, where bulk copies fill them, start and end on 16-byte
boundaries.  The wrappers' argument checks are exercised on the CPU, where
they launch nothing.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mlff_tpu_torch.ops import df64_gemv as g  # noqa: E402
from mlff_tpu_torch.utils import trace  # noqa: E402

SM_COUNT = 132
SHAPES = [(31482, 1536), (75006, 3840), (1001, 130), (4099, 1030), (1, 1),
          (5, 29056)]
shapes = pytest.mark.parametrize("shape", SHAPES,
                                 ids=[f"{n}x{m}" for n, m in SHAPES])


def _coverage(tiles, n, m):
    seen = np.zeros((n, m), dtype=np.int32)
    for _, row0, rows, col0, cols in tiles:
        assert rows >= 1 and cols >= 1
        seen[row0:row0 + rows, col0:col0 + cols] += 1
    return seen


@shapes
@pytest.mark.parametrize("pass_", ["b_x", "bt_v"])
def test_stages_cover_b_exactly_once(shape, pass_):
    n, m = shape
    p = g.plan(n, m, SM_COUNT)
    tiles = list(getattr(p, f"{pass_}_tiles")())
    assert np.all(_coverage(tiles, n, m) == 1)
    assert all(rows <= g.ROWS and cols <= g.COLS
               for _, _, rows, _, cols in tiles)
    grid = p.grid_b_x if pass_ == "b_x" else p.grid_bt_v
    assert {b for b, *_ in tiles} == set(range(grid))


@shapes
def test_plan_fits_the_card(shape):
    n, m = shape
    p = g.plan(n, m, SM_COUNT)
    assert p.smem_bytes <= 232448
    assert p.smem_bytes == p.stages * g.STAGE_BYTES + g.RED_BYTES + g.BAR_BYTES
    assert 1 <= p.stages <= g.MAX_STAGES
    assert p.stages >= 2 or not p.bulk       # a ring needs two stages
    assert g.THREADS <= 1024
    for grid in (p.grid_b_x, p.grid_bt_v):
        assert 1 <= grid <= 2 * SM_COUNT     # one or two blocks per SM
    assert p.n_units == p.n_slabs * p.n_groups < 2**31
    assert 1 <= p.group_chunks <= g.GROUP
    assert (p.n_groups - 1) * p.group_chunks < p.n_chunks \
        <= p.n_groups * p.group_chunks
    assert n * m < 2**63


@shapes
def test_bulk_copies_are_16_byte_aligned(shape):
    n, m = shape
    p = g.plan(n, m, SM_COUNT)
    assert p.bulk == (m % 4 == 0)
    if not p.bulk:
        return
    for tiles in (p.b_x_tiles(), p.bt_v_tiles()):
        for _, row0, rows, col0, cols in tiles:
            for r in range(row0, row0 + rows):
                assert (4 * (r * m + col0)) % 16 == 0    # source offset
            assert (4 * cols) % 16 == 0                  # size
            assert (4 * g.COLS) % 16 == 0                # stage row pitch


@shapes
def test_bt_v_slabs_keep_sums_short_and_waves_full(shape):
    """A thread adds half of a slab's rows into one accumulator, so 640 rows
    bound every sequential df64 sum by 320 terms; where B is large, the
    units fill the grid's waves to at least 95%; and the tree over the
    slabs' partials has one top node."""
    n, m = shape
    p = g.plan(n, m, SM_COUNT)
    assert 1 <= p.n_slabs <= p.n_panels
    assert -(-p.n_panels // p.n_slabs) * g.ROWS <= g.SLAB_ROWS_MAX
    if n >= 30000:
        waves = -(-p.n_units // p.grid_bt_v)
        assert p.n_units / (waves * p.grid_bt_v) >= 0.95
        assert waves <= 8
    count, nodes = p.n_slabs, 0
    while count > 1 or nodes == 0:
        count = -(-count // g.FAN)
        nodes += count
    assert p.tree_nodes == nodes


def test_main_shape_plan():
    """The main path's factor: 132 slabs, each walking both column chunks,
    one unit per SM; 3936 row panels over 132 persistent blocks."""
    p = g.plan(31482, 1536, SM_COUNT)
    assert (p.bulk, p.stages, p.n_chunks) == (True, 4, 2)
    assert (p.group_chunks, p.n_groups) == (2, 1)
    assert (p.n_slabs, p.grid_bt_v) == (132, 132)
    assert p.tree_nodes == 17 + 3 + 1
    assert (p.n_panels, p.grid_b_x) == (3936, 132)


def _pair(n=16, m=8):
    rng = np.random.default_rng(0)
    Bh = torch.as_tensor(rng.standard_normal((n, m)).astype(np.float32))
    Bl = (Bh * 2.0**-25).contiguous()
    return Bh, Bl


@pytest.mark.parametrize("bad", ["misaligned", "non_contiguous"])
@pytest.mark.parametrize("wrapper", ["df64_bt_v", "df64_b_x"])
def test_wrapper_rejects_misaligned_or_non_contiguous_b(wrapper, bad):
    """No such B is rejected: the wrapper gives the plain version's result,
    as the reference does for any B (on the card the kernel gets an
    aligned, contiguous copy)."""
    Bh, Bl = _pair()
    n, m = Bh.shape
    if bad == "misaligned":
        flat = torch.zeros(n * m + 1, dtype=torch.float32)
        flat[1:] = Bh.reshape(-1)
        Bh = flat[1:].view(n, m)
        assert Bh.is_contiguous() and Bh.data_ptr() % 16 != 0
    else:
        Bh = torch.cat([Bh, Bh], dim=1)[:, :m]
        assert not Bh.is_contiguous()
    vec = torch.as_tensor(np.random.default_rng(2).standard_normal(
        n if wrapper == "df64_bt_v" else m))
    got = getattr(g, wrapper)(Bh, Bl, vec)
    want = getattr(g, f"{wrapper}_ref")(Bh.contiguous().clone(), Bl, vec)
    assert torch.equal(got, want)


@pytest.mark.parametrize("wrapper", ["df64_bt_v", "df64_b_x"])
def test_cpu_route_launches_nothing_and_is_exact_enough(wrapper):
    Bh, Bl = _pair(40, 12)
    fn = getattr(g, wrapper)
    vec = torch.as_tensor(np.random.default_rng(1).standard_normal(
        40 if wrapper == "df64_bt_v" else 12))
    launches = g.LAUNCHES[wrapper.removeprefix("df64_")]
    before = trace.counter(launches)
    got = fn(Bh, Bl, vec)
    assert trace.counter(launches) == before
    B = Bh.double() + Bl.double()
    want = B.T @ vec if wrapper == "df64_bt_v" else B @ vec
    assert float((got - want).abs().max() / want.abs().max()) < 3e-12


@pytest.mark.parametrize("shape", [(0, 5), (5, 0)])
def test_empty_b_gives_zeros_on_cpu(shape):
    n, m = shape
    Bh = torch.zeros((n, m), dtype=torch.float32)
    u = g.df64_bt_v(Bh, Bh.clone(), torch.zeros(n, dtype=torch.float64))
    y = g.df64_b_x(Bh, Bh.clone(), torch.zeros(m, dtype=torch.float64))
    assert u.shape == (m,) and y.shape == (n,)
    assert not u.any() and not y.any()
