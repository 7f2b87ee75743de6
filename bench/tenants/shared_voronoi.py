"""The churn benchmark's tenants (``membership_churn.py::_bench_serve``):
Voronoi queries over one Sec.-VI problem, each its own draw of the data,
tenant i seeded i, the configuration's ``beta`` and ``ell``.
``{"gen": "shared_voronoi", "q": <tenants>}``."""

import numpy as np

from bench.harness.gen import F32, Tenant, problem, rng_for, sample


def make(cfg, spec, n_rows, seed):
    q, k, d = int(spec["q"]), int(cfg["k"]), int(cfg["d"])
    centers, mean, sigma = problem(rng_for(seed, 10), k, d,
                                   float(cfg["problem"]["bias"]),
                                   float(cfg["problem"]["std"]))
    rng = rng_for(seed, 11)
    ones = np.ones(n_rows, F32)
    return [Tenant("voronoi", centers, None, None,
                   sample(rng, mean, sigma, n_rows, d), ones,
                   float(cfg["beta"]), int(cfg["ell"]), i) for i in range(q)]
