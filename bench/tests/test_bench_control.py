"""``correct`` comes out false for the control and for each fault a cell
can have, at a size a test run holds; the run's look for a card is
skipped and everything after it is driven as on the card.

* the control: the reference put in the program's place in bfloat16, the
  precision below the configured float32;
* a step that returns its state unchanged;
* half of the tenants left out of the step;
* an answer altered where it is produced (one tenant's region);
* a cycle left out of each tick from the window's second tick on, a
  fault that shows only after the start, caught at a tick drawn later in
  the window.

The exchange between chips does not exist in these one-card cells.
"""

import pytest
import torch

from bench_small import CELLS, run_small, verdict


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    _, run = run_small(name, n=256)
    ok, numbers, _ = verdict(run)
    assert ok, numbers
    ok, numbers, _ = verdict(run, torch.bfloat16)
    assert not ok and numbers["state_mismatch"] > 0, numbers


def _unchanged(monkeypatch):
    from repro_torch.core import lss

    def cycle_impl(state, topo, cfg, decide, gate=None, suite=None,
                   regions=None, with_stats=False):
        zeros = torch.zeros(state.t.shape, dtype=torch.int32)
        return (state, zeros, zeros) if with_stats else (state, zeros)
    monkeypatch.setattr(lss, "cycle_impl", cycle_impl)


def _half(monkeypatch):
    from repro_torch.service import service

    step = service._CoreBackend.step

    def half_step(self, states, params, tables, k, cfg, topo):
        q = params.active.shape[0]
        keep = torch.arange(q) < q // 2
        return step(self, states, params._replace(active=params.active & keep),
                    tables, k, cfg, topo)
    monkeypatch.setattr(service._CoreBackend, "step", half_step)


def _altered(monkeypatch):
    from repro_torch.service import service

    metrics = service._CoreBackend.metrics

    def altered(self, *args, **kw):
        acc, quiescent, want = metrics(self, *args, **kw)
        want = want.clone()
        want[0] = want[0] + 1
        return acc, quiescent, want
    monkeypatch.setattr(service._CoreBackend, "metrics", altered)


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_fails(monkeypatch, name, fault):
    fault(monkeypatch)
    _, run = run_small(name, n=256, seed=11)
    ok, numbers, _ = verdict(run)
    assert not ok, numbers


def _late(monkeypatch):
    from repro_torch.service import service

    step = service._CoreBackend.step
    calls = [0]

    def late_step(self, states, params, tables, k, cfg, topo):
        calls[0] += 1  # the warm tick is call 1, window tick i call i + 1
        return step(self, states, params, tables, k - (calls[0] >= 3), cfg,
                    topo)
    monkeypatch.setattr(service._CoreBackend, "step", late_step)


class _Clock:
    """A clock that moves 10 ms a reading, so that a run's ticks and the
    one it checks follow from the count of readings, not the machine's
    load."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.01
        return self.t


@pytest.mark.parametrize("name", CELLS)
def test_late_fault_fails(monkeypatch, name):
    from bench.harness import cell as cellmod

    _late(monkeypatch)
    monkeypatch.setattr(cellmod, "time", _Clock())
    # Three readings a tick: the window checks the first tick to start
    # after 0.3 of its 0.5 s, about the sixth, and runs about 17.
    _, run = run_small(name, n=256, seed=13, seconds=0.5, span=(0.3, 0.3))
    ok, numbers, checked = verdict(run)
    assert checked == 2 and max(run.checked_ticks) >= 4, run.checked_ticks
    assert len(run.records) > max(run.checked_ticks) + 4
    assert not ok and numbers["state_mismatch"] > 0, numbers
