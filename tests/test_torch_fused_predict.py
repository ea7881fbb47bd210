"""The fused prediction contraction (``mlff_tpu_torch.ops.fused_predict``).

On the CPU the wrapper runs the kernel's plain PyTorch version, which is
held here to the JAX package's Pallas kernel (interpret mode) and to its
f64 contraction.  Against the f32 Pallas kernel the tolerances are those of
``tests/test_pallas_predict.py`` (atol 2e-5 * max|F|, rtol 2e-4): the
Pallas side is f32.  Against the f64 contraction the plain version (f64)
agrees to 1e-10 relative, the summation order of products whose terms
cancel by ~1e3; that is checked at two descriptor widths (ethanol, D = 36,
and uracil, D = 66).  The CUDA kernel itself is compared with the plain
version on the card (``tests/test_torch_cuda.py`` and ``chip_smoke.py``);
its launch geometry (``plan``) is pure Python and checked here: slabs of
whole 16-row stages that cover the training axis once, a grid and a
shared-memory size the card takes.  Descriptors wider than ``MAX_D`` = 129
take the kernel's wide route; its plain version is the same function, held
here to the JAX package's f64 contraction at D = 130, 136, 210 (aspirin),
1,000 and 3,828 (catcher), and its plan at those widths and at the
nanotube's D = 68,265.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mlff_tpu.data.synthetic import benchmark_perms, make_benchmark_dataset  # noqa: E402
from mlff_tpu.ops import descriptor as jd  # noqa: E402
from mlff_tpu.ops import kernel as jk  # noqa: E402
from mlff_tpu.ops.pallas_predict import desc_forces_pallas  # noqa: E402
from mlff_tpu_torch.ops import cuda_build  # noqa: E402
from mlff_tpu_torch.ops import fused_predict as fp  # noqa: E402
from mlff_tpu_torch.utils import trace  # noqa: E402

SIG = 10.0
ATOL_REL, RTOL_F32 = 2e-5, 2e-4   # tests/test_pallas_predict.py
RTOL_F64 = 1e-10


def _operands(molecule):
    """Held-out query descriptors of ``molecule`` against 30 permuted
    training points, random cotangents; f64 numpy."""
    ds, _ = make_benchmark_dataset(molecule, n_samples=70, seed=11,
                                   n_train=30)
    spec = jd.make_spec(ds["R"].shape[1])
    P_idx = jnp.asarray(jd.desc_perms(benchmark_perms(molecule)))
    q = jk.SQRT5 / SIG
    X, _ = jd.descriptors_from_R(spec, jnp.asarray(ds["R"][:30]))
    Xq_query, _ = jd.descriptors_from_R(spec, jnp.asarray(ds["R"][30:]))
    Xqt = jk.permuted_descriptors(q * X, P_idx)
    w = np.random.default_rng(1).normal(size=(30, spec.dim))
    wt = jk.perm_expand_w(jnp.asarray(w), P_idx)
    return np.asarray(q * Xq_query), np.asarray(Xqt), np.asarray(wt)


@pytest.fixture(scope="module")
def operands():
    """Ethanol: D = 36, M = 180."""
    return _operands("ethanol")


@pytest.fixture(scope="module")
def operands_uracil():
    """Uracil, 12 atoms: D = 66."""
    return _operands("uracil")


def _torch(*arrays):
    return tuple(torch.as_tensor(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("B", [7, 40])
def test_plain_version_matches_pallas_kernel(operands, B):
    Xq, Xqt, wt = operands
    F_p, E_p = desc_forces_pallas(jnp.asarray(Xq[:B]), jnp.asarray(Xqt),
                                  jnp.asarray(wt), sig=SIG, interpret=True)
    F_t, E_t = fp.desc_forces_fused_ref(*_torch(Xq[:B], Xqt, wt), SIG)
    assert F_t.shape == (B, Xq.shape[1]) and E_t.shape == (B,)
    np.testing.assert_allclose(F_t.numpy(), np.asarray(F_p), rtol=RTOL_F32,
                               atol=ATOL_REL * float(F_t.abs().max()))
    np.testing.assert_allclose(E_t.numpy(), np.asarray(E_p), rtol=RTOL_F32,
                               atol=ATOL_REL * float(E_t.abs().max()))


def _check_against_f64_contraction(operands, B):
    Xq, Xqt, wt = (jnp.asarray(a) for a in operands)
    dist = jk.pairwise_dist_gram(Xq[:B], Xqt)
    A_exp = (5.0 / (3.0 * SIG**2)) * jnp.exp(-dist)
    F_j, E_j = jk._desc_forces_x(Xqt, SIG, Xq[:B], A_exp, A_exp * (1 + dist),
                                 wt)
    F_t, E_t = fp.desc_forces_fused_ref(
        *_torch(operands[0][:B], operands[1], operands[2]), SIG)
    assert F_t.shape == (B, operands[0].shape[1]) and E_t.shape == (B,)
    for got, want in ((F_t, F_j), (E_t, E_j)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= RTOL_F64 * np.abs(want).max()


@pytest.mark.parametrize("B", [7, 40])
def test_plain_version_matches_f64_contraction(operands, B):
    _check_against_f64_contraction(operands, B)


@pytest.mark.parametrize("B", [1, 7, 40])
def test_plain_version_matches_f64_contraction_at_uracil_width(
        operands_uracil, B):
    assert operands_uracil[0].shape[1] == 66
    _check_against_f64_contraction(operands_uracil, B)


def test_plain_version_matches_pallas_kernel_at_uracil_width(operands_uracil):
    Xq, Xqt, wt = operands_uracil
    F_p, E_p = desc_forces_pallas(jnp.asarray(Xq[:7]), jnp.asarray(Xqt),
                                  jnp.asarray(wt), sig=SIG, interpret=True)
    F_t, E_t = fp.desc_forces_fused_ref(*_torch(Xq[:7], Xqt, wt), SIG)
    np.testing.assert_allclose(F_t.numpy(), np.asarray(F_p), rtol=RTOL_F32,
                               atol=ATOL_REL * float(F_t.abs().max()))
    np.testing.assert_allclose(E_t.numpy(), np.asarray(E_p), rtol=RTOL_F32,
                               atol=ATOL_REL * float(E_t.abs().max()))


def test_wrapper_on_cpu_runs_plain_version_without_launching(operands):
    args = _torch(operands[0][:7], operands[1], operands[2])
    before = trace.counter(fp.LAUNCHES)
    F_w, E_w = fp.desc_forces_fused(*args, SIG)
    F_r, E_r = fp.desc_forces_fused_ref(*args, SIG)
    assert trace.counter(fp.LAUNCHES) == before
    assert torch.equal(F_w, F_r) and torch.equal(E_w, E_r)


@pytest.mark.parametrize("bad", ["float32", "strided", "shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(operands, bad):
    Xq, Xqt, wt = _torch(operands[0][:7], operands[1], operands[2])
    if bad == "float32":
        Xq = Xq.float()
    elif bad == "strided":
        Xqt = torch.as_tensor(np.asfortranarray(operands[1]))
    else:
        wt = wt[:-1]
    with pytest.raises((TypeError, ValueError)):
        fp.desc_forces_fused(Xq, Xqt, wt, SIG)


def test_width_limit_is_the_kernels_and_is_named():
    """The CPU route takes every width; MAX_D is the widest of the narrow
    instantiations, and the next width takes the wide route."""
    rng = np.random.default_rng(0)
    for D in (fp.MAX_D, fp.MAX_D + 1):
        Xq, Xqt, wt = _torch(rng.normal(size=(3, D)), rng.normal(size=(8, D)),
                             rng.normal(size=(8, D)))
        F, E = fp.desc_forces_fused(Xq, Xqt, wt, SIG)
        assert F.shape == (3, D) and E.shape == (3,)
    assert fp.geometry_for(fp.MAX_D).width == 136
    assert fp.geometry_for(fp.MAX_D + 1) is fp.WIDE


WIDE_SOURCES = {130: None, 136: None, 210: "aspirin", 1000: None,
                3828: "catcher"}


def _wide_operands(D):
    """Queries against 24 permuted training points of aspirin or catcher
    (their benchmark datasets and permutation groups), or random operands of
    a width no molecule has; random cotangents."""
    if WIDE_SOURCES[D] is None:
        rng = np.random.default_rng(D)
        return (0.05 + 0.1 * rng.random((9, D)),
                0.05 + 0.1 * rng.random((37, D)), rng.normal(size=(37, D)))
    molecule = WIDE_SOURCES[D]
    ds, _ = make_benchmark_dataset(molecule, n_samples=33, seed=11,
                                   n_train=24)
    spec = jd.make_spec(ds["R"].shape[1])
    assert spec.dim == D
    P_idx = jnp.asarray(jd.desc_perms(benchmark_perms(molecule)))
    q = jk.SQRT5 / SIG
    X, _ = jd.descriptors_from_R(spec, jnp.asarray(ds["R"][:24]))
    Xq_query, _ = jd.descriptors_from_R(spec, jnp.asarray(ds["R"][24:]))
    Xqt = jk.permuted_descriptors(q * X, P_idx)
    w = np.random.default_rng(1).normal(size=(24, D))
    wt = jk.perm_expand_w(jnp.asarray(w), P_idx)
    return np.asarray(q * Xq_query), np.asarray(Xqt), np.asarray(wt)


@pytest.mark.parametrize("D", sorted(WIDE_SOURCES))
def test_plain_version_matches_f64_contraction_at_wide_widths(D):
    operands = _wide_operands(D)
    assert operands[0].shape[1] == D and fp.geometry_for(D) is fp.WIDE
    _check_against_f64_contraction(operands, operands[0].shape[0])


N_SM = 132     # an H100
PLAN_SHAPES = [(512, 6996), (7, 6959), (1, 64), (600, 65), (1, 6996)]
PLAN_WIDTHS = [3, 36, 66, 120, 129]
plan_cases = pytest.mark.parametrize(
    "shape,D", [(s, d) for s in PLAN_SHAPES for d in PLAN_WIDTHS],
    ids=[f"{b}x{m}-D{d}" for b, m in PLAN_SHAPES for d in PLAN_WIDTHS])


@plan_cases
def test_plan_covers_the_training_axis_once_in_whole_stages(shape, D):
    (B, M), p = shape, fp.plan(*shape, D, N_SM)
    assert p.rows_per_split % fp.TM == 0 and p.rows_per_split >= fp.TM
    seen = np.zeros(M, dtype=np.int32)
    for s in range(p.n_split):
        lo = s * p.rows_per_split
        assert lo < M                      # no slab is empty
        seen[lo:min(M, lo + p.rows_per_split)] += 1
    assert np.all(seen == 1)
    assert (p.n_qtiles - 1) * p.geometry.queries < B \
        <= p.n_qtiles * p.geometry.queries


@plan_cases
def test_plan_fits_the_card(shape, D):
    p = fp.plan(*shape, D, N_SM)
    geo = p.geometry
    assert D <= geo.width <= 136 and geo.width % 8 == 0
    assert geo.row_pitch % 8 == 4 and geo.row_pitch >= geo.width
    assert geo.smem_bytes <= 232448
    assert geo.blocks_per_sm * geo.smem_bytes <= 232448
    assert geo.threads % 32 == 0 and geo.threads <= 1024
    assert geo.queries in (8 * geo.threads // 32, 16 * geo.threads // 32)
    assert 1 <= p.n_split <= 65535 and 1 <= p.n_qtiles < 2**31
    # one wave: no more blocks than the card keeps resident, unless the
    # query tiles alone exceed that
    assert (p.n_qtiles * p.n_split <= geo.blocks_per_sm * N_SM
            or p.n_split == 1)


@pytest.mark.parametrize("D", [0, -1])
def test_plan_rejects_a_width_outside_the_kernel_range(D):
    with pytest.raises(ValueError, match="not positive"):
        fp.plan(512, 6996, D, N_SM)


WIDE_WIDTHS = [130, 136, 210, 1000, 3828, 68265]
WIDE_SHAPES = [(512, 6996), (7, 6959), (1, 14), (60, 14), (512, 119),
               (512, 1500), (100000, 6996), (3000000, 14)]
wide_cases = pytest.mark.parametrize(
    "shape,D", [(s, d) for s in WIDE_SHAPES for d in WIDE_WIDTHS],
    ids=[f"{b}x{m}-D{d}" for b, m in WIDE_SHAPES for d in WIDE_WIDTHS])


@wide_cases
def test_wide_plan_fits_the_card(shape, D):
    """Shared memory of the resident blocks within an SM's 233,472 bytes
    (each block's reserved kilobyte included), every grid axis the card
    takes, the slices and slabs covering the
    descriptor and training axes once in whole stages, and one wave of
    blocks wherever a pass splits an axis."""
    (B, M), p = shape, fp.plan(*shape, D, N_SM)
    geo = p.geometry
    assert geo is fp.WIDE
    assert max(geo.smem_weights, geo.smem_forces) <= 232448
    assert (geo.blocks_per_sm * (max(geo.smem_weights, geo.smem_forces)
                                 + 1024) <= 233472)
    assert geo.threads % 32 == 0 and geo.threads <= 1024
    assert geo.queries == 32 * (geo.threads // 32) // 2
    assert p.b_chunk % geo.queries == 0 and p.b_chunk >= geo.queries
    Bc = min(B, p.b_chunk)
    assert p.n_qtiles == -(-Bc // geo.queries) <= 65535
    assert p.n_mtiles == -(-M // geo.tile)
    assert p.n_qtiles * p.n_mtiles < 2**31 and 1 <= p.n_ksplit <= 65535
    assert p.cols_per_slice % geo.depth == 0
    assert (p.n_ksplit - 1) * p.cols_per_slice < D \
        <= p.n_ksplit * p.cols_per_slice
    assert p.n_dtiles == -(-D // geo.cols) < 2**31
    assert 1 <= p.n_split <= 65535 and p.rows_per_split % geo.rows == 0
    assert (p.n_split - 1) * p.rows_per_split < M <= p.n_split * p.rows_per_split
    wave = N_SM * geo.blocks_per_sm
    assert 0 <= p.n_whole <= p.n_qtiles * p.n_mtiles
    assert p.n_whole + p.n_tail * p.n_ksplit < 2**31
    if p.n_ksplit > 1:
        assert p.n_whole % wave == 0 and p.n_tail * p.n_ksplit <= wave
    else:
        assert p.n_tail == 0
    if p.n_split > 1:
        assert p.n_qtiles * p.n_dtiles * p.n_split <= wave


# (B, M, D, tiles split): catcher, the nanotube and B = 1 fill less than a
# wave and split every tile; the full row at D = 210 and 3828 runs three
# whole waves and splits the 88 tiles of its fourth; aspirin's 192 tiles
# fill 0.73 of a wave, and a split in two would overfill it
SPLIT_CASES = {"catcher": (512, 119, 3828, 16),
               "nanotube": (512, 14, 68265, 8),
               "catcher_B1": (1, 119, 3828, 2),
               "nanotube_B1": (1, 14, 68265, 1),
               "aspirin_B1": (1, 1500, 210, 24),
               "ragged_B7": (7, 298, 130, 5),
               "full_3828": (512, 6996, 3828, 88),
               "full_210": (512, 6996, 210, 88),
               "aspirin": (512, 1500, 210, 0)}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_wide_plan_splits_d_where_pass_1_leaves_sms_idle(case):
    """The tiles of pass 1's last wave, where it is not full (all of them
    where they fill less than one wave of the 132 SMs' resident blocks),
    are cut into as many slices of D as fill that wave: more than half of
    it, or a stage per slice where D is that narrow, never more than all of
    it.  The whole waves before it are not split."""
    B, M, D, n_tail = SPLIT_CASES[case]
    p = fp.plan(B, M, D, N_SM)
    wave = N_SM * p.geometry.blocks_per_sm
    tiles = p.n_qtiles * p.n_mtiles
    assert p.n_tail == n_tail and p.n_whole == tiles - n_tail
    if n_tail:
        assert p.n_whole % wave == 0
        assert p.n_ksplit > 1 and p.n_tail * p.n_ksplit <= wave
        assert (wave // 2 < p.n_tail * p.n_ksplit
                or p.cols_per_slice == p.geometry.depth)
    else:
        assert p.n_ksplit == 1 and p.cols_per_slice >= D


SLICE_WIDTHS = [130, 131, 210, 1000, 3828, 3829, 68265]
SLICE_SHAPES = [(1, 14), (7, 298), (512, 119), (512, 6996)]


@pytest.mark.parametrize("D", SLICE_WIDTHS)
@pytest.mark.parametrize("shape", SLICE_SHAPES,
                         ids=[f"{b}x{m}" for b, m in SLICE_SHAPES])
def test_wide_slices_cover_every_column_once(shape, D):
    """Ragged D: the slices cover each descriptor column exactly once, none
    is empty, each starts on a whole stage (16-byte copies stay aligned)."""
    p = fp.plan(*shape, D, N_SM)
    seen = np.zeros(D, dtype=np.int32)
    for y in range(p.n_ksplit):
        lo = y * p.cols_per_slice
        assert lo < D and lo % p.geometry.depth == 0
        seen[lo:min(D, lo + p.cols_per_slice)] += 1
    assert np.all(seen == 1)


@wide_cases
def test_wide_scratch_stays_within_its_bound(shape, D):
    """The (B, M) weights within WIDE_WEIGHT_DOUBLES (or one query tile
    where M alone passes it); the slices' S and Gram partials within one
    wave of pass-1 tiles with their row terms; the slabs' force partials
    within one wave of pass-2 tiles."""
    (B, M), p = shape, fp.plan(*shape, D, N_SM)
    geo = p.geometry
    wave = N_SM * geo.blocks_per_sm
    Bc, ldm = min(B, p.b_chunk), M + M % 2
    weights = 2 * Bc * ldm
    assert weights <= max(fp.WIDE_WEIGHT_DOUBLES, 2 * geo.queries * ldm)
    rows = 2 * (-(-p.n_mtiles * Bc // 2) * 2) + Bc + Bc % 2
    slices = p.scratch_doubles(Bc, M, D) - weights - rows
    if p.n_split > 1:
        slices -= p.n_split * Bc * D
        assert p.n_split * Bc * D <= wave * geo.queries * geo.cols
    per_slice = 2 * geo.queries * geo.tile + geo.queries + 2 * geo.tile
    assert slices == p.n_tail * p.n_ksplit * per_slice
    assert slices <= wave * per_slice


def test_wide_library_geometry_is_held_against_the_plan():
    """``_library`` accepts a library that reports WIDE with a block of each
    pass resident, and refuses one that reports other tiles or none."""
    resident = (1, 1)
    t = fp.WIDE.library_tuple()
    good = t[:10] + resident + t[10:]
    assert fp.wide_geometry_matches(good)
    assert not fp.wide_geometry_matches(good[:10] + (0, 1) + good[12:])
    for i in range(10):
        bad = list(good)
        bad[i] += 1
        assert not fp.wide_geometry_matches(tuple(bad))


def test_main_shape_plan_fills_the_card():
    """B = 512, M = 6996, D = 36 on 132 SMs: 8 query tiles x 49 slabs of 9
    stages, 392 of the 396 resident blocks; one query still gets a block
    for every SM."""
    p = fp.plan(512, 6996, 36, N_SM)
    assert (p.geometry.width, p.geometry.queries) == (40, 64)
    assert (p.n_qtiles, p.n_split, p.rows_per_split) == (8, 49, 144)
    one = fp.plan(1, 6996, 36, N_SM)
    assert one.n_qtiles == 1 and one.n_split >= N_SM


PTXAS_REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_14wide11wide_forcesEPKdS2_S2_S2_S2_S2_PdS3_iiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_14wide11wide_forcesEPKdS2_S2_S2_S2_S2_PdS3_iiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 230 registers, 456 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116contract_partialILi5ELi2ELi4ELi3EEEvPKdS2_S2_Pdiiiiidd' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116contract_partialILi5ELi2ELi4ELi3EEEvPKdS2_S2_Pdiiiiidd
    16 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 168 registers, 420 bytes cmem[0]
"""


def test_ptxas_report_gives_each_kernels_registers_and_spills():
    """What the build line reports per kernel, read from nvcc's -Xptxas -v
    output under the kernel's own (unmangled) name."""
    got = cuda_build.kernel_resources(PTXAS_REPORT)
    assert got == {
        "wide_forces": {"registers": 230, "spill_stores": 0,
                        "spill_loads": 0},
        "contract_partial": {"registers": 168, "spill_stores": 8,
                             "spill_loads": 4}}
