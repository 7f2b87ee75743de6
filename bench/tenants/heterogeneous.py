"""``service/workload.py::heterogeneous_tenants`` on the Sec.-VI problem:
even tenants a Voronoi query over their own problem's centers, odd ones a
halfspace threshold at their data's mean, each with its own ``beta`` and
``ell``.  ``{"gen": "heterogeneous", "q": <tenants>}``."""

import numpy as np

from bench.harness.gen import F32, Tenant, problem, rng_for, sample


def make(cfg, spec, n_rows, seed):
    q, k, d = int(spec["q"]), int(cfg["k"]), int(cfg["d"])
    bias, std = float(cfg["problem"]["bias"]), float(cfg["problem"]["std"])
    ones = np.ones(n_rows, F32)
    out = []
    for i in range(q):
        centers, mean, sigma = problem(rng_for(seed, 10, i), k, d, bias, std)
        rng = rng_for(seed, 11, i)
        x = sample(rng, mean, sigma, n_rows, d)
        beta, ell = 1e-3 * (1.0 + i / (2.0 * q)), 1 + i % 2
        if i % 2 == 0:
            out.append(Tenant("voronoi", centers, None, None, x, ones, beta,
                              ell, i))
        else:
            w = rng.normal(size=d).astype(F32)
            out.append(Tenant("halfspace", None, w, F32(x.mean(0) @ w), x,
                              ones, beta, ell, i))
    return out
