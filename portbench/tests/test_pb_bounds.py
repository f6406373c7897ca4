"""The frozen bound functions on cases worked by hand."""

import pytest
import torch

from portbench.harness import bounds as B


def test_gather_bound_one_launch():
    # one plane 64 x 64, two 8 x 8 windows at (0, 0) and (0, 4): the
    # patches 2 * 64 words, the starts 2 * 8 bytes, the covered 8 x 12
    # elements read once
    r0, c0 = torch.tensor([0, 0]), torch.tensor([0, 4])
    t = B.gather_bound([((64, 64), "p", r0, c0, 8)])
    assert t * B.H100_BYTES_PER_S == pytest.approx(4 * 128 + 16 + 4 * 96)
    # a start of -1 wraps to H - 1 and clamps to H - P: rows 56..63
    t2 = B.gather_bound([((64, 64), "p", torch.tensor([-1]),
                          torch.tensor([0]), 8)])
    assert t2 * B.H100_BYTES_PER_S == pytest.approx(4 * 64 + 8 + 4 * 64)
    # the same plane in two items is read once; another plane is not
    t3 = B.gather_bound([((64, 64), "p", r0, c0, 8),
                         ((64, 64), "p", r0, c0, 8),
                         ((64, 64), "q", r0, c0, 8)])
    assert t3 * B.H100_BYTES_PER_S == pytest.approx(
        3 * (4 * 128 + 16) + 2 * 4 * 96)


def test_cdef_ladder_ops_known_skips():
    var = torch.zeros((2, 3), dtype=torch.int32)
    # every unit skipped: 2 operations a pixel (the unfiltered error and
    # its multiply-add)
    allskip = torch.ones((2, 3), dtype=torch.bool)
    assert B.cdef_ladder_ops(var, allskip, False, None) == 2 * 6 * 64
    assert B.cdef_ladder_ops(var, allskip, True, None) == 2 * 6 * 16
    # nothing skipped, variance 0: luma's primary strengths adjust to 0,
    # the six entries with a secondary strength (1, 1, 2, 2, 2, 4) filter:
    # 32 (secondary taps) + 4 (window) + 32 * 3 distinct secondaries
    # + 6 * 3 distinct pairs + 6 entries + 2 = 158 a pixel, and 4 + 2 * 8
    # a unit for the adjustment
    none = torch.zeros((2, 3), dtype=torch.bool)
    assert B.cdef_ladder_ops(var, none, False, None) == 6 * (158 * 64 + 20)
    # chroma keeps its primary strengths: entries 1-7 filter, with 6
    # distinct primaries (1, 2, 4, 5, 8, 12), 3 distinct secondaries
    # (1, 2, 4), 6 distinct pairs, 5 of them with both taps
    ops = B.cdef_ladder_ops(var, none, True, None)
    per = 12 + 32 + 4 + 16 * 6 + 32 * 3 + 6 * 6 + 5 + 7 + 2
    assert ops == 6 * 16 * per


def test_cdef_bound_takes_the_larger():
    var = torch.zeros((8, 8), dtype=torch.int32)
    skip = torch.ones((8, 8), dtype=torch.bool)
    shapes = [(64, 64), (32, 32), (32, 32)]
    t = B.cdef_ladder_bound(shapes, 1, var, skip, False, [4, 4, 4])
    ops = 2 * 64 * 64 + 2 * 2 * 32 * 32
    nbytes = 2 * (64 * 64 + 2 * 32 * 32) + 32 * 12
    assert t == pytest.approx(max(ops / B.H100_INT_OPS_PER_S,
                                  nbytes / B.H100_BYTES_PER_S))
