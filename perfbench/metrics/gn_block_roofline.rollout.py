"""The least time of the profiled GN-block applications' work (the frozen
byte and FLOP count of one application at the live rows, times the
applications) over the device time (span union) of the kernels launched
inside GN-block calls."""


def read(r):
    if not r.get("gn_kernels") or not r.get("gn_device_s"):
        return None
    return 100.0 * r["gn_bound_s"] / r["gn_device_s"]
