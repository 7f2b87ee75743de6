"""tenant_cycles_per_s.churn: ``tenant_cycles_per_s`` of a cell whose
host-bound ticks spread too widely to share that metric's bound."""

from bench.harness.spec import plugin

read = plugin("metrics", "tenant_cycles_per_s").read
