"""``launches_per_step.rollout`` in the cells that report ``rollout_throughput.unfused``."""

from perfbench.harness.manifest import reader

read = reader("launches_per_step.rollout")
