"""``gn_block_roofline.rollout`` in the cells that report ``rollout_throughput.unfused``."""

from perfbench.harness.manifest import reader

read = reader("gn_block_roofline.rollout")
