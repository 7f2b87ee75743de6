"""tick_ms_p95.churn: ``tick_ms_p95`` of a cell whose host-bound ticks
spread too widely to share that metric's bound."""

from bench.harness.spec import plugin

read = plugin("metrics", "tick_ms_p95").read
