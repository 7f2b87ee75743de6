"""The port's copy of the topology module against the JAX package's: the
same generators at fixed seeds give identical ``nbr``/``mask``/``rev``, and
the same seeded sequence of ``DynTopology`` operations leaves identical
state, versions and event journals."""

import numpy as np
import pytest

from repro.core import topology as j_top
from repro_torch.core import topology as t_top


def _same(a, b):
    assert a.n == b.n and a.max_deg == b.max_deg
    for name in ("nbr", "mask", "rev"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name


@pytest.mark.parametrize("make", [
    lambda m: m.grid(256),
    lambda m: m.grid(64, wrap=True),
    lambda m: m.grid(49, diag=True),
    lambda m: m.chord(256),
    lambda m: m.chord(100),
    lambda m: m.barabasi_albert(90, m=2, seed=1),
    lambda m: m.barabasi_albert(500, m=3, seed=7),
    lambda m: m.from_edges(6, [(0, 1), (1, 2), (2, 0), (3, 4), (4, 4),
                               (1, 0)], max_deg=4),
], ids=["grid256", "torus64", "grid49diag", "chord256", "chord100",
        "ba90", "ba500m3", "from_edges"])
def test_generators_identical(make):
    a, b = make(j_top), make(t_top)
    _same(a, b)
    b.validate()
    assert a.num_edges == b.num_edges
    assert np.array_equal(a.degrees, b.degrees)


def test_drop_peers_identical():
    dead = np.zeros(90, bool)
    dead[[0, 5, 17, 40]] = True
    a = j_top.barabasi_albert(90, m=2, seed=1).drop_peers(dead)
    b = t_top.barabasi_albert(90, m=2, seed=1).drop_peers(dead)
    _same(a, b)
    b.validate()


def _random_ops(mod, seed, steps=120):
    """A seeded op sequence on a capacity-padded grid; returns the topology
    and the outcome of every op (ids, slots or the exception type)."""
    rng = np.random.default_rng(seed)
    dyn = mod.DynTopology.from_topology(mod.grid(36), n_cap=48, deg_cap=6,
                                        strict=True)
    log = []
    for _ in range(steps):
        op = rng.integers(4)
        i, j = (int(x) for x in rng.integers(0, dyn.n_cap, size=2))
        try:
            if op == 0:
                log.append(dyn.add_peer(edges=[i] if dyn.present[i] else []))
            elif op == 1:
                log.append(dyn.remove_peer(i))
            elif op == 2:
                log.append(dyn.add_edge(i, j))
            else:
                log.append(dyn.remove_edge(i, j))
        except ValueError as err:  # CapacityError is a ValueError
            log.append(type(err).__name__)
    return dyn, log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dyntopology_random_ops_identical(seed):
    a, log_a = _random_ops(j_top, seed)
    b, log_b = _random_ops(t_top, seed)
    assert log_a == log_b
    _same(a, b)
    assert np.array_equal(a.present, b.present)
    assert a.version == b.version
    assert a.events_since(0) == b.events_since(0)
    assert np.array_equal(a.changed_rows_since(3), b.changed_rows_since(3))
    b.validate()
    _same(a.rebuild(), b.rebuild())
    ga, gb = a.grow(n_cap=60, deg_cap=8), b.grow(n_cap=60, deg_cap=8)
    _same(ga, gb)
    assert ga.version == gb.version == b.version
    b.compact(b.version)
    with pytest.raises(ValueError):
        b.events_since(0)


def test_dyntopology_capacity_error():
    dyn = t_top.DynTopology.from_topology(t_top.grid(4), n_cap=4)
    with pytest.raises(t_top.CapacityError):
        dyn.add_peer()
    with pytest.raises(ValueError):
        dyn.grow(n_cap=2)
