"""The frozen yardstick against hand counts at small shapes."""

import pytest

from benchmark import roofline


def test_match_counts_bound_by_operations():
    # 1000 pairs x K 2 x P 3 x 10 words = 60,000 LOP3 on 2 SMs at 1 MHz,
    # 64 a clock: 60,000 / (64 * 2 * 1e6) s
    s, by = roofline.match_counts_bound_s(1000, 2, 3, 10, 0, 2, sm_mhz=1.0)
    assert by == "operations"
    assert s == pytest.approx(60000 / (64 * 2 * 1e6))


def test_match_counts_bound_by_bytes():
    s, by = roofline.match_counts_bound_s(1, 1, 1, 1, 3.35e12, 132)
    assert by == "bytes"
    assert s == pytest.approx((3.35e12 + 4) / 3.35e12)


def test_epilogue_ops_hand_count():
    # K 1, no correction, Jaccards only: the b-bit steps, 6 float32 ops
    assert roofline.epilogue_ops(1, False, False, True) == (6, 0)
    # K 2 with both strands and the fit: 6K + 7*2 + K*24 + K*15 + 94
    f32, sfu = roofline.epilogue_ops(2, True, True, False)
    assert f32 == 12 + 14 + 48 + 30 + 94
    assert sfu == 2 * 6 + 2 + 6


def test_epilogue_bound():
    f32, sfu = roofline.epilogue_ops(6)
    s, by = roofline.epilogue_bound_s(10 ** 6, 2000, 6, 132)
    issue = 1e6 * (f32 + sfu) / (128 * 132 * 1980e6)
    special = 1e6 * sfu / (16 * 132 * 1980e6)
    moved = 1e6 * 6 * 4 + 2000 * 20 + 1e6 * 8
    assert s == pytest.approx(max(issue, special, moved / 3.35e12))
    assert by == "operations"
