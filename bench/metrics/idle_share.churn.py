"""idle_share.churn: ``idle_share`` of a cell that reports
``tenant_cycles_per_s.churn``."""

from bench.harness.spec import plugin

read = plugin("metrics", "idle_share").read
