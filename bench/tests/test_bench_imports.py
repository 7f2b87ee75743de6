"""Nothing under ``bench/`` imports JAX, Flax, the JAX package or its
benchmarks, by top-level module name compared whole; the reference and the
byte models import nothing of the program either."""

import ast
import os

from bench_small import ROOT

BENCH = os.path.join(ROOT, "bench")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _files(sub=""):
    for dirpath, _, names in os.walk(os.path.join(BENCH, sub)):
        for name in names:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def test_no_jax_anywhere():
    seen = {p: set(_imports(p)) & FORBIDDEN for p in _files()}
    assert not any(seen.values()), {p: s for p, s in seen.items() if s}


def test_reference_and_costs_stand_alone():
    for sub in ("reference", "costs"):
        for p in _files(sub):
            assert "repro_torch" not in set(_imports(p)), p


def test_forbidden_names_compare_whole():
    from bench.harness.cell import forbidden_modules
    import sys

    assert "repro_torch" not in forbidden_modules()
    assert all(m.split(".")[0] not in ("jax", "repro")
               for m in sys.modules if m.startswith("repro_torch"))
