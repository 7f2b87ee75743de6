"""The benchmark's harness: cells, generators, the traced run's readings
and the comparison that decides ``correct``."""
