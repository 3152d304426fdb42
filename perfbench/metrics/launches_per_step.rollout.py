"""CUDA kernels per rollout step in the profiled stretch (an exact count)."""


def read(r):
    if not r.get("steps") or not r.get("kernels"):
        return None
    return r["kernels"] / r["steps"]
