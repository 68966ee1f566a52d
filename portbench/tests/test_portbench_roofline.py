"""The Gram's work, counted by hand."""

import pytest

from portbench import roofline


def test_gram_work_by_hand():
    # 3 patterns, 4 samples: 10 cells of the lower triangle
    ops, nbytes = roofline.gram_work(3, 4)
    assert ops == 2 * 3 * 10
    assert nbytes == 3 * 4 / 8 + 4 * 3 + 4 * 10


def test_gram_bound_at_the_tree_cell():
    # 580,674 patterns over 20,480 samples: bound by the int8 peak
    ops, nbytes = roofline.gram_work(580_674, 20_480)
    assert ops == pytest.approx(2.4357e14, rel=1e-4)
    assert roofline.gram_bound_s(580_674, 20_480) == \
        pytest.approx(ops / 1979e12)
    assert nbytes / 3.35e12 < ops / 1979e12
