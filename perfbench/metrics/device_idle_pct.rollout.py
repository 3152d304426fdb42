"""Share of the profiled stretch in which nothing ran on the device: one
minus the union of its kernel, copy and memset spans over the wall time of
the same stretch run untraced just before it (the profiler slows the host
about twofold, so the traced stretch's own wall time would overstate the
idle share)."""


def read(r):
    if not r.get("busy_s") or not r.get("untraced_wall_s"):
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["untraced_wall_s"])
