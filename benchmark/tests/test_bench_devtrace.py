"""The device's busy time, idle share, top operations and idle gaps, read
from hand-made timelines."""

from __future__ import annotations

import pytest

from benchmark import devtrace


@pytest.mark.parametrize("intervals, want", [
    ([], 0.0),
    ([(0, 1)], 1.0),
    ([(0, 1), (2, 3)], 2.0),
    ([(0, 2), (1, 3)], 3.0),          # overlap counted once
    ([(0, 4), (1, 2), (3, 4)], 4.0),  # nested
    ([(2, 3), (0, 1), (1, 2)], 3.0),  # touching, unsorted
])
def test_union(intervals, want):
    assert devtrace.union_seconds(intervals) == want


def test_merged():
    assert devtrace.merged([(3, 4), (0, 1), (0.5, 2)]) == [[0, 2], [3, 4]]


def trace():
    # device busy 0-1, 1.5-2 (two overlapping kernels), 4-5; window 6 s
    device = [("gemm", 0.0, 1.0), ("copy_kernel", 1.5, 1.8),
              ("gemm", 1.6, 2.0), ("Memcpy HtoD", 4.0, 5.0)]
    host = [("outer", 0.0, 6.0), ("aten::mm", 0.9, 1.6),
            ("cudaStreamSynchronize", 2.0, 4.0)]
    return devtrace.Trace(window_s=6.0, device=device, host=host)


def test_busy_and_idle():
    t = trace()
    assert t.busy_s == pytest.approx(2.5)
    assert t.idle_share == pytest.approx(1 - 2.5 / 6.0)
    assert [n for n, _, _ in t.kernels()] == ["gemm", "copy_kernel", "gemm"]


def test_seconds_of_and_top_ops():
    t = trace()
    assert t.seconds_of(("gemm",)) == (pytest.approx(1.4), 2)
    assert t.seconds_of(("nothing",)) == (0.0, 0)
    top = t.top_device_ops()
    assert top[0][0] == "gemm" and top[0][1] == pytest.approx(1.4)
    assert [n for n, _ in top] == ["gemm", "Memcpy HtoD", "copy_kernel"]


def test_idle_gaps_named_by_the_innermost_host_op():
    gaps = trace().idle_gaps()
    # 2.0-4.0 under the synchronize, 1.0-1.5 under aten::mm
    assert gaps[0][0] == "cudaStreamSynchronize"
    assert gaps[0][1] == pytest.approx(2.0)
    assert gaps[1][0] == "aten::mm"
    assert gaps[1][1] == pytest.approx(0.5)


def test_idle_gaps_without_host_records():
    t = trace()
    t.host = []
    assert t.idle_gaps() == []
