"""Canonical heterogeneous tenant workloads (demos, benchmarks, tests).

Port of ``repro/service/workload.py``, on the port's ``sim.make_problem``
(which draws from numpy's RNG as the JAX twin does, so both packages build
the same tenants): Q tenants on one n-peer graph, even slots Voronoi source
selection (fresh Sec.-VI problem per seed), odd slots a halfspace
threshold on the same data, every tenant with its own ``beta``/``ell``
knobs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import regions, sim
from .query import QuerySpec

__all__ = ["heterogeneous_tenants"]


def heterogeneous_tenants(n: int, q: int, d: int = 2):
    """Q mixed-family tenant specs over an n-peer graph (d=2 data)."""
    specs = []
    for i in range(q):
        centers, sample, _, _ = sim.make_problem(
            sim.ProblemSpec(n=n, seed=100 + i))
        rng = np.random.default_rng(1000 + i)
        x = sample(rng, n)
        if i % 2 == 0:
            region = regions.VoronoiRegions(centers)
        else:
            w = rng.normal(size=d).astype(np.float32)
            region = regions.HalfspaceRegions(
                w=torch.from_numpy(w),
                b=torch.tensor(np.float32(x.mean(0) @ w)))
        specs.append(QuerySpec(region=region, inputs=x, seed=i,
                               beta=1e-3 * (1.0 + i / (2.0 * q)),
                               ell=1 + i % 2))
    return specs
