"""The step's model FLOPs (the benchmark's own count at the cell's live rows)
over the untraced window's wall time per step, as a share of the H100's
dense bf16 peak."""

from perfbench.harness.arithmetic import PEAK_BF16_FLOPS


def read(r):
    if not r.get("step_flops") or not r.get("wall_per_step"):
        return None
    return 100.0 * r["step_flops"] / (r["wall_per_step"] * PEAK_BF16_FLOPS)
