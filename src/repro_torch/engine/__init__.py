"""The sharded simulation engine (port of ``repro.engine``).

Modules:
  partition — BFS/greedy edge-cut partitioner + per-shard halo tables
  exchange  — boundary-message halo exchange (the gather fallback on one
              device, the collective ``all_to_all`` across processes), the
              async mode's bounded-staleness ring and the four wire formats
              (exact / compact / int8 / bf16)
  engine    — ShardedLSS: the K-cycles-per-dispatch engine, sync or async,
              on one device or one shard a rank (``use_mesh``)
  autotune  — plan enumeration scored by the counted dispatch cost
              (``repro_torch.launch.cost``) and timed probes
              (EngineConfig.auto_plan)
  sweep     — batched multi-seed / multi-config scenario sweeps
"""

from . import autotune  # noqa: F401
from .engine import (AsyncShardedState, DeviceTopo,  # noqa: F401
                     EngineConfig, ShardedLSS, ShardedState)
from .partition import (Partition, ShardedTopo, make_partition,  # noqa: F401
                        repair_sharded_topo, shard_topology)
from .sweep import sweep_configs, sweep_static  # noqa: F401
