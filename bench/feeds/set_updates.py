"""``service_throughput.py::make_stream``: before a tick, ``fraction`` of
the peer rows (at least one), drawn without replacement, get fresh
standard-normal vectors in one ``set`` update shared by every tenant.
``{"gen": "set_updates", "fraction": 0.01, "every": 1}``: on every
``every``-th tick, counting the warm tick as 0."""

import numpy as np

from bench.harness.gen import F32, rng_for
from bench.reference import lss as ref

STAGE = 1  # a boundary applies the membership events first, then updates


class Feed:
    def __init__(self, spec, world, seed):
        self.n, self.d = world.rows, world.d
        self.m = max(1, int(self.n * float(spec["fraction"])))
        self.every = int(spec.get("every", 1))
        self.rng = rng_for(seed, 20)

    def __call__(self, svc, tick):
        """Queue tick ``tick``'s update; returns it (or None)."""
        if tick % self.every:
            return None
        who = self.rng.choice(self.n, size=self.m, replace=False).astype(
            np.int32)
        vals = self.rng.normal(size=(self.m, self.d)).astype(F32)
        svc.push_updates(who, vals, mode="set")
        return who, vals

    def report(self):
        return {}

    def faults(self):
        return {}


def edit(entry, book):
    """The reference's side of one tick's entry: the state edit."""
    if entry is None:
        return lambda st: st
    who, vals = entry
    return lambda st: ref.ingest_set(st, who, vals)
