"""Each roofline's operations and bytes on a shape worked out by hand."""

import pytest
import torch

from hicbench import peaks


def test_bound_is_the_larger_of_bytes_and_operations():
    assert peaks.bound_s(3.35e12, 0, peaks.FP32_FLOPS) == pytest.approx(1.0)
    assert peaks.bound_s(0, 67e12, peaks.FP32_FLOPS) == pytest.approx(1.0)
    assert peaks.bound_s(3.35e12, 134e12, peaks.FP32_FLOPS) == \
        pytest.approx(2.0)


def test_gemm():
    # one (4, 4) square: 2 * 4^3 operations, 3 matrices of 16 f32
    assert peaks.gemm_cost(torch.zeros(4, 4), 2)[:2] == (192, 128)
    # a batch of 3 (5, 5), cubed: two products each
    assert peaks.gemm_cost(torch.zeros(3, 5, 5), 3)[:2] == (
        12 * 3 * 25 * 2, 2 * 3 * 125 * 2)


def test_mcl_column():
    e = torch.zeros(2, 3, 3)
    infl = torch.ones(2)
    # e and new: 2 matrices each of 9 f32
    assert peaks.mcl_column_cost(e, infl, 1e-4)[:2] == (4 * 9 * 4, 36)
    # with old: 6 matrices
    assert peaks.mcl_column_cost(e, infl, 1e-4, old=e)[:2] == (216, 36)
    # iteration 0's stride-0 view: e is one matrix
    view = torch.zeros(3, 3)[None].expand(2, 3, 3)
    assert peaks.mcl_column_cost(view, infl, 1e-4)[0] == 4 * 9 * 3


def test_rescore():
    """G = 2 groups, P = 3 tours of k = 4 slots, R = 5 records."""
    order = torch.zeros(2, 3, 4, dtype=torch.int32)
    pa = torch.zeros(2, 5, dtype=torch.int32)
    args = (order, order, torch.zeros(2, 4), pa, pa, pa, pa,
            torch.zeros(2, 4, 5), torch.zeros(2, 5))
    # order, ori, lengths, the records' 36 B, the scores
    base = 8 * 24 + 8 * 8 + 36 * 10 + 4 * 6
    assert peaks.rescore_cost(*args, caches=False)[:2] == (base, 19 * 30)
    # the slot tables (2k + 1 int32 a tour) and 28 B a (tour, record)
    assert peaks.rescore_cost(*args, caches=True)[:2] == (
        base + 4 * 6 * 9 + 28 * 30, 19 * 30)
