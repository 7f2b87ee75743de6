"""The benchmark's frozen generators' shared parts: seeded streams, the
edge-list clean-up, the tenant record and the Sec.-VI problem.

The generators themselves are files found by name, copies of the ones the
repository already had, kept here so that no later change to the program
moves the yardstick: graphs in ``bench/topologies/``, tenants in
``bench/tenants/``, and the input a tick queues (updates, membership
events) in ``bench/feeds/``.  Every draw comes from ``--seed``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

F32 = np.float32


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """An independent numpy stream for ``(seed, *stream)``; any seed
    that fits 64 bits."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *stream]))


def undirected(n: int, edges: np.ndarray) -> np.ndarray:
    """``edges`` (E, 2) without self loops and with each undirected pair
    once, in the order of its first appearance."""
    edges = edges[edges[:, 0] != edges[:, 1]]
    key = np.minimum(edges[:, 0], edges[:, 1]) * n + np.maximum(
        edges[:, 0], edges[:, 1])
    _, first = np.unique(key, return_index=True)
    return edges[np.sort(first)]


class Tenant(NamedTuple):
    kind: str  # "voronoi" | "halfspace"
    centers: Optional[np.ndarray]  # (k, d) float32, Voronoi
    w: Optional[np.ndarray]  # (d,) float32, halfspace
    b: Optional[np.float32]  # halfspace threshold
    x: np.ndarray  # (n, d) float32 local vectors
    weights: np.ndarray  # (n,) float32
    beta: float
    ell: int
    seed: int


def problem(rng, k, d, bias, std):
    """The Sec.-VI problem (``core/sim.py::make_problem``): k centers; the
    data's mean lies ``bias`` of the way from a desired center to its
    nearest contender, spread ``std`` times their distance."""
    centers = rng.normal(size=(k, d)).astype(F32)
    desired = rng.integers(k)
    dist = np.linalg.norm(centers - centers[desired], axis=1)
    dist[desired] = np.inf
    contender = int(np.argmin(dist))
    gap = float(np.linalg.norm(centers[contender] - centers[desired]))
    mean = (1 - bias) * centers[desired] + bias * centers[contender]
    return centers, mean, std * gap


def sample(rng, mean, sigma, n, d):
    return (mean + sigma * rng.standard_normal((n, d))).astype(F32)
