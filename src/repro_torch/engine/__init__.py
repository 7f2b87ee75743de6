"""The sharded simulation engine on one device (port of ``repro.engine``).

Modules:
  partition — BFS/greedy edge-cut partitioner + per-shard halo tables
  exchange  — boundary-message halo exchange (the gather fallback), the
              async mode's bounded-staleness ring and the four wire formats
              (exact / compact / int8 / bf16)
  engine    — ShardedLSS: the K-cycles-per-dispatch engine, sync or async
  sweep     — batched multi-seed / multi-config scenario sweeps

Not ported yet: ``autotune`` (ROADMAP A.8) and the collective transport
(A.5).
"""

from .engine import (AsyncShardedState, DeviceTopo,  # noqa: F401
                     EngineConfig, ShardedLSS, ShardedState)
from .partition import (Partition, ShardedTopo, make_partition,  # noqa: F401
                        repair_sharded_topo, shard_topology)
from .sweep import sweep_configs, sweep_static  # noqa: F401
