"""Launch-side tooling (port of ``repro.launch``).

Modules:
  cost — the roofline inputs of one call (flops, HBM bytes, collective
         bytes by op), counted while it runs: the torch stand-in for
         ``repro.launch.hlo_cost.analyze``, which reads optimized XLA HLO
  mesh — the production and host meshes (``DeviceMesh`` over the default
         process group's ranks)
"""
