"""K1's bytes and operations, and the bound they give."""

import pytest

from port_bench import roofline


def test_k1_counts_at_the_headline_launch():
    nbytes, ops = roofline.counts(25, 1788, 6, 4, 13.86, "michelot", 26)
    assert nbytes == (3 * 25 * 1788 * 6 + 25 * 36) * 4
    assert ops == pytest.approx(25 * 1788 * 13.86 * (2 * 36 + 25 * 6))
    peaks = roofline.PEAKS["NVIDIA H100 80GB HBM3"]
    bound, by = roofline.bound_s(nbytes, ops, peaks, "float32")
    # PERF.md's K1 row: 0.00205 ms, bound by the operations.
    assert by == "operations"
    assert bound == pytest.approx(2.05e-6, rel=0.01)


def test_one_iteration_launch_is_bound_by_bytes():
    nbytes, ops = roofline.counts(100, 732, 4, 4, 1.0, "michelot", 26)
    peaks = roofline.PEAKS["NVIDIA H100 80GB HBM3"]
    bound, by = roofline.bound_s(nbytes, ops, peaks, "float32")
    assert by == "bytes"
    assert bound == pytest.approx(1.05e-6, rel=0.01)


def test_bisection_counts_its_halvings():
    assert roofline.per_coordinate("michelot", 26) == 25
    assert roofline.per_coordinate("bisect", 26) == 21 + 3 + 3 * 26
    _, ops = roofline.counts(1, 10, 4, 8, 2.0, "bisect", 52)
    assert ops == 10 * 2.0 * (2 * 16 + (24 + 3 * 52) * 4)
