"""The sharded simulation engine on one device (port of ``repro.engine``).

Modules:
  partition — BFS/greedy edge-cut partitioner + per-shard halo tables
  exchange  — boundary-message halo exchange (the gather fallback) and the
              lossless wire formats (exact / compact)
  engine    — ShardedLSS: the synchronous K-cycles-per-dispatch engine
  sweep     — batched multi-seed / multi-config scenario sweeps

Not ported yet: ``autotune`` (ROADMAP A.8), the collective transport
(A.5), the async ring and the quantized wires (A.4b).
"""

from .engine import (DeviceTopo, EngineConfig, ShardedLSS,  # noqa: F401
                     ShardedState)
from .partition import (Partition, ShardedTopo, make_partition,  # noqa: F401
                        repair_sharded_topo, shard_topology)
from .sweep import sweep_configs, sweep_static  # noqa: F401
