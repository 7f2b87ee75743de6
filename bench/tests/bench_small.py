"""Small copies of the benchmark's cells for the CPU tests: the cells'
configurations and traffic with fewer peers, tenants and cycles."""

import copy
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from bench.harness import cell as cellmod  # noqa: E402
from bench.harness import check  # noqa: E402
from bench.harness.spec import BENCH_DIR, Cell, _load  # noqa: E402

# The configuration and traffic files of the benchmark's cells.
CELLS = {"chord-80k.serve-q64": ("chord-80k", "serve-q64"),
         "grid-80k.serve-q64": ("grid-80k", "serve-q64"),
         "grid-80k.churn-q16": ("grid-80k", "churn-q16")}
CPU = torch.device("cpu")


def small_cell(name, n=1024, q=4, k=4, span=(0.0, 0.0)):
    """``name`` at ``n`` peers, ``q`` tenants, ``k`` cycles a tick; the
    warm tick (2 tenants) and one window tick (every tenant) checked: the
    first that starts after ``span`` of the window (the window's first
    tick by default)."""
    config, mix = CELLS[name]
    cell = Cell(name, 1, _load(os.path.join(BENCH_DIR, "configs",
                                             config + ".json")),
                _load(os.path.join(BENCH_DIR, "traffic", mix + ".json")),
                (), ())
    cfg = copy.deepcopy(cell.config)
    cfg["topology"]["n"] = n
    traffic = copy.deepcopy(cell.traffic)
    traffic["tenants"]["q"] = q
    traffic["service"]["cycles_per_dispatch"] = k
    traffic["check"] = {"window_ticks": 1, "warm_tenants": 2,
                        "span": list(span)}
    return cell._replace(config=cfg, traffic=traffic)


def run_small(name, seed=5, seconds=0.05, trace=False, **kw):
    """One run of the small cell on the CPU: (data, run)."""
    return cellmod.run_cell(small_cell(name, **kw), seed, seconds, trace,
                            CPU, time.perf_counter(), log=lambda *a, **k: None)


def verdict(run, dtype=torch.float32):
    numbers, checked = check.judge(run, CPU, dtype)
    return check.verdict(numbers, checked, run), numbers, checked
