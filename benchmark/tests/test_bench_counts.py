"""The operation and byte counts of the yardstick against values worked by
hand for both configurations, and the frozen fused-kernel bound against
the program's own."""

from __future__ import annotations

import pytest

from benchmark import peaks

ETHANOL = dict(N=1166, M=6996, D=36, A=9, n=31482, k=1536)
ASPIRIN = dict(N=250, M=1500, D=210, A=21, n=15750, k=1653)


@pytest.mark.parametrize("s, ops, nbytes", [
    # 6 N M D; 8 (2 N M + M D + N D + 3 N D + D A + 2 n)
    (ETHANOL, 1_761_984_576, 134_381_760),
    (ASPIRIN, 472_500_000, 10_487_280),
], ids=["ethanol", "aspirin"])
def test_matvec_counts(s, ops, nbytes):
    assert peaks.matvec_ops(s["N"], s["M"], s["D"]) == ops
    assert peaks.matvec_bytes(s["N"], s["M"], s["D"], s["A"]) == nbytes
    assert peaks.matvec_seconds(s["N"], s["M"], s["D"], s["A"]) == max(
        ops / 67e12, nbytes / 3.35e12)


@pytest.mark.parametrize("s, ops, nbytes", [
    # 4 n k; 8 (n k + 2 n)
    (ETHANOL, 193_425_408, 387_354_528),
    (ASPIRIN, 104_139_000, 208_530_000),
], ids=["ethanol", "aspirin"])
def test_apply_counts(s, ops, nbytes):
    assert peaks.apply_ops(s["n"], s["k"]) == ops
    assert peaks.apply_bytes(s["n"], s["k"]) == nbytes
    assert peaks.apply_seconds(s["n"], s["k"]) == nbytes / 3.35e12


def test_cg_iteration_ops():
    s = ETHANOL
    assert peaks.cg_iteration_ops(s["N"], s["M"], s["D"], s["A"], s["k"]) \
        == 1_761_984_576 + 193_425_408 + 10 * 31482


@pytest.mark.parametrize("B, M, D, ops, nbytes", [
    # 8 B M D + 10 B M; 8 (B D + 2 M D + B D + B)
    (512, 1500, 210, 1_297_920_000, 6_764_416),
    (512, 6996, 36, 1_067_421_696, 4_328_704),
    (1, 6996, 36, 2_084_808, 4_030_280),
], ids=["aspirin", "ethanol", "ethanol-B1"])
def test_fused_counts(B, M, D, ops, nbytes):
    assert peaks.fused_predict_ops(B, M, D) == ops
    assert peaks.fused_predict_bytes(B, M, D) == nbytes


@pytest.mark.parametrize("B, M, D", [(512, 1500, 210), (512, 6996, 36),
                                     (1, 6996, 36), (7, 119, 3828)])
def test_fused_bound_is_the_programs(B, M, D):
    from mlff_tpu_torch.ops.fused_predict import bound_seconds

    want, _ = bound_seconds(B, M, D, peaks.F64_PEAK, peaks.MEM_RATE)
    assert peaks.fused_predict_seconds(B, M, D) == pytest.approx(want,
                                                                 rel=1e-15)
