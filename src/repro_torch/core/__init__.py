"""Core of the port: the paper's formulas, topologies, Alg. 1 and the
Sec.-VI driver (twins of ``repro.core``)."""
