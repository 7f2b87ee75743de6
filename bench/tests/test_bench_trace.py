"""The reduction of a trace to busy time, device time by kernel and idle
gaps by the host's activity, on a hand-made trace (times in ns), and the
counting pass's counts bound by parameter name."""

import pytest
import torch

from bench_small import ROOT  # noqa: F401  (puts the repo on sys.path)
from bench.harness import trace


def test_summarize_by_hand():
    us = 1000
    device = [
        (10 * us, 30 * us, "lss_state_tiles<2, 34>", 1),
        (20 * us, 40 * us, "correction_tiles", 2),  # overlaps the first
        (50 * us, 55 * us, "Memcpy DtoH", 3),  # a checked tick's copy
        (70 * us, 80 * us, "lss_state_tiles<2, 34>", 4),
        (95 * us, 120 * us, "after the window", 5),
        (130 * us, 134 * us, "lss_state_tiles<2, 34>", 6),  # counting pass
        (135 * us, 136 * us, "reduce_kernel", 7),  # its counting reduction
    ]
    launches = {1: 5 * us, 2: 6 * us, 3: 45 * us, 4: 60 * us, 5: 90 * us,
                6: 129 * us, 7: 131 * us}
    harness = [(44 * us, 56 * us)]
    counts = [(130 * us, 132 * us)]
    ranges = [(0, 100 * us, "tick"), (41 * us, 69 * us, "do-while")]
    reads = [41 * us]
    out = trace.summarize(device, launches, (0, 100 * us),
                          (125 * us, 140 * us), harness, counts, ranges,
                          reads)
    # The window without the snapshot's 12 us.
    assert out["window_s"] == pytest.approx(88e-6)
    assert out["busy_s"] == pytest.approx(45e-6)  # 10..40, 70..80, 95..100
    assert out["by_name"]["lss_state_tiles<2, 34>"] == pytest.approx(30e-6)
    assert out["by_name"]["correction_tiles"] == pytest.approx(20e-6)
    assert "Memcpy DtoH" not in out["by_name"]
    assert out["pass_by_name"] == {
        "lss_state_tiles<2, 34>": pytest.approx(4e-6)}
    gaps = out["idle_by_label"]
    # 0..10 and 80..95 inside the tick; 40..44 and 56..70 inside the
    # do-while, right after a read.
    assert gaps["tick"] == pytest.approx(25e-6)
    assert gaps["do-while read"] == pytest.approx(18e-6)
    assert out["longest_gaps"][0] == (pytest.approx(15e-6), "tick")


def test_innermost_of_nested_ranges():
    ranges = [(0, 100, "tick"), (10, 50, "dispatch"), (20, 30, "do-while"),
              (60, 70, "observe")]
    assert trace._innermost(ranges, [5, 25, 40, 65, 80, 150]) == [
        "tick", "do-while", "dispatch", "observe", "tick", "harness"]


def test_counts_bind_by_parameter_name():
    class Ops:
        @staticmethod
        def lss_state(x_m, x_c, out_m, out_c, in_m, in_c, mask, region,
                      eps=1e-9):
            return mask

        @staticmethod
        def correction(s_m, s_c, a_m, a_c, in_m, in_c, v_set, beta=1e-3,
                       eps=1e-9):
            return v_set

        @staticmethod
        def global_decision(x_m, x_c, alive, region, eps=1e-9):
            return alive

    counts = trace.KernelCounts(Ops, torch.device("cpu"), cap=8)
    counts.install()
    mask = torch.tensor([[True, False], [True, True]])
    Ops.lss_state(*range(6), mask, None)
    Ops.lss_state(*range(6), region=None, mask=mask[:1])
    Ops.correction(*range(6), v_set=torch.ones(3, dtype=torch.bool))
    Ops.global_decision(0, 1, None, None)
    counts.uninstall()
    assert counts.totals() == (4, 3)
    assert (counts.n_live, counts.n_viol, counts.n_global) == (2, 1, 1)
    assert Ops.lss_state(*range(6), mask, None) is mask
