"""``device_idle_pct.rollout`` in the cells that report ``rollout_throughput.unfused``."""

from perfbench.harness.manifest import reader

read = reader("device_idle_pct.rollout")
