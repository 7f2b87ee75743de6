"""The benchmark's byte models against counts worked by hand."""

import pytest

from bench_small import ROOT  # noqa: F401  (puts the repo on sys.path)
from bench.costs import model


def test_lss_state_cost_by_hand():
    # 10 rows of 4 slots, d = 2, k = 3, 20 live slots, one call.
    # Bytes: x 10*12, mask 10*4, s 10*12, viol 10*4, decision 10*4 = 360;
    # out and in moments and weights of the live slots 20*2*12 = 480.
    # Operations: a row 3 + 2 + 18 = 23 (S, vec(S), f(S): 2k(d+1) = 18);
    # a live slot 12 + 4 + 36 = 52.
    assert model.lss_state_cost(10, 4, 2, 3, 20) == (840, 10 * 23 + 20 * 52)
    # Two calls: the per-row part twice, the live slots are a total.
    assert model.lss_state_cost(10, 4, 2, 3, 20, calls=2) == (
        1200, 2 * 230 + 1040)


def test_correction_cost_v_by_hand():
    # 10 rows of 4 slots, d = 2, 5 violating slots: S 10*12, v_set 10*4,
    # a and in on V 5*24, out on V 5*12.
    nbytes, ops = model.correction_cost_v(10, 4, 2, 5)
    assert nbytes == 120 + 40 + 120 + 60
    assert ops == 5 * 3 + 10 * 7 + 5 * 8


def test_deliver_and_global_by_hand():
    # 2 tenants x 5 peers = 10 rows of 4 slots, d = 2, 7 sent: pending read
    # and written 2*10*4, alive 10, mask + nbr + rev 5*4*9, moments 7*24.
    assert model.deliver_cost(10, 4, 5, 2, 7) == (80 + 10 + 180 + 168, 0)
    # 2 tenants, 5 peers, d = 2, k = 3: x and alive 2*5*13, tables
    # 4*2*(2*4 + 3 + 4 + 1), want and gx 4*2*4; 2*5*3 float64 adds.
    assert model.global_cost(2, 5, 2, 3) == (130 + 128 + 32, 30)


def test_bound_takes_the_larger():
    assert model.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert model.bound_s(0, 67e12) == pytest.approx(1.0)
    assert model.bound_s(0, 34e12, model.F64_OPS_PER_S) == pytest.approx(1.0)
