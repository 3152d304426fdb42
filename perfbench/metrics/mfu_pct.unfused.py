"""``mfu_pct.rollout`` in the cells that report ``rollout_throughput.unfused``."""

from perfbench.harness.manifest import reader

read = reader("mfu_pct.rollout")
