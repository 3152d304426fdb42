"""``peak_mem_gib.rollout`` in the cells that report ``rollout_throughput.unfused``."""

from perfbench.harness.manifest import reader

read = reader("peak_mem_gib.rollout")
