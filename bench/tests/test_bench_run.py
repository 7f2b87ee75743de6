"""``bench/run.py`` prints no result and exits non-zero without a card,
and a cell is found by its name in ``BENCHMARK.json``."""

import json
import os
import subprocess
import sys

import pytest
import torch

from bench_small import ROOT
from bench.harness.spec import load_cell, plugin


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "grid-80k.serve-q64",
         "--seed", str(2 ** 40 + 1), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_every_cell_resolves():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for w in bench["workloads"]:
        cell = load_cell(w["name"])
        assert cell.end_to_end and cell.per_layer
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        # Every generator the configuration and the traffic name exists.
        plugin("topologies", cell.config["topology"]["kind"])
        plugin("tenants", cell.traffic["tenants"]["gen"])
        for f in cell.traffic["feeds"]:
            plugin("feeds", f["gen"])
        for m in cell.per_layer:
            # A per-layer metric's cell reports the metric it moves.
            assert m["moves"] in {e["name"] for e in cell.end_to_end}
            assert os.path.exists(os.path.join(ROOT, "bench", "metrics",
                                               m["name"] + ".py"))
