"""The plain reference against the program's CPU path, through a whole
run of each cell at 1,024 peers: records, regions, state and slot tables
equal."""

import numpy as np
import pytest
import torch

from bench_small import CELLS, run_small, verdict
from bench.harness.spec import plugin
from bench.reference import topo as ref_topo


def _edges(kind, n):
    return plugin("topologies", kind).edges({"kind": kind, "n": n})


@pytest.mark.parametrize("name", CELLS)
def test_reference_equals_program(name):
    n = 1024 if "grid" not in name else 32 * 32
    data, run = run_small(name, n=n)
    ok, numbers, checked = verdict(run)
    assert checked == 2, checked  # the warm tick and window tick 1
    assert numbers == {k: 0 for k in numbers}, numbers
    assert ok
    assert data.ticks >= 1 and run.missing == 0


def test_tables_from_edges_match_the_program():
    from repro_torch.core import topology

    for kind, n in (("chord", 1000), ("grid", 400)):
        n, edges = _edges(kind, n)
        mine = ref_topo.tables_from_edges(n, edges)
        theirs = topology.from_edges(n, edges)
        for a, b in zip(mine, (theirs.nbr, theirs.mask, theirs.rev)):
            np.testing.assert_array_equal(a, b)
    # The generators give the program's own graphs.
    n, edges = _edges("chord", 1000)
    ch = topology.chord(1000)
    np.testing.assert_array_equal(ref_topo.tables_from_edges(n, edges)[0],
                                  ch.nbr)
    n, edges = _edges("grid", 400)
    np.testing.assert_array_equal(ref_topo.tables_from_edges(n, edges)[0],
                                  topology.grid(400).nbr)


def test_slot_book_follows_membership():
    from repro_torch.core import topology

    n, edges = _edges("grid", 16)
    book = ref_topo.SlotBook(20, edges, 16, 6)
    dyn = topology.DynTopology.from_topology(topology.from_edges(n, edges),
                                             n_cap=20, deg_cap=6)
    events = [("join", 16), ("link", 16, 5), ("leave", 5), ("unlink", 0, 1),
              ("join", 5), ("link", 5, 16), ("link", 5, 0)]
    touched, joins, leaves = book.apply(events)
    for ev in events:
        if ev[0] == "join":
            dyn.add_peer(ev[1])
        elif ev[0] == "leave":
            dyn.remove_peer(ev[1])
        elif ev[0] == "link":
            dyn.add_edge(ev[1], ev[2])
        else:
            dyn.remove_edge(ev[1], ev[2])
    for a, b in zip((book.nbr, book.mask, book.rev),
                    (dyn.nbr, dyn.mask, dyn.rev)):
        np.testing.assert_array_equal(a, b)
    assert sorted(joins) == [5, 16] and leaves == []
    assert (5, 0) in touched


def test_seeds_change_inputs_not_sizes():
    from types import SimpleNamespace

    cfg = {"k": 3, "d": 2, "problem": {"bias": 0.2, "std": 2.0}}
    make = plugin("tenants", "heterogeneous").make
    a = make(cfg, {"q": 4}, 100, 2 ** 40 + 3)
    b = make(cfg, {"q": 4}, 100, 7)
    assert [t.kind for t in a] == [t.kind for t in b]
    assert all(x.x.shape == y.x.shape for x, y in zip(a, b))
    assert not np.array_equal(a[0].x, b[0].x)

    class Queue:
        def push_updates(self, who, vals, mode):
            self.got = (who, vals)

    feed = plugin("feeds", "set_updates").Feed
    world = SimpleNamespace(rows=100, d=2)
    s1 = feed({"fraction": 0.01}, world, 9)
    s2 = feed({"fraction": 0.01}, world, 9)
    w1, v1 = s1(Queue(), 0)
    w2, v2 = s2(Queue(), 0)
    np.testing.assert_array_equal(w1, w2)
    np.testing.assert_array_equal(v1, v2)
    assert torch.equal(torch.from_numpy(v1), torch.from_numpy(v2))
