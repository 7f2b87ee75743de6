"""Core of the port: the paper's formulas, topologies, Alg. 1, the
Sec.-VI driver, the event-driven simulator, the covariance-weighted space
and the mesh monitor (twins of ``repro.core``)."""

from . import (async_sim, correction, lss, monitor, regions, sim,  # noqa: F401
               stopping, topology, wvs, wvs_cov)
