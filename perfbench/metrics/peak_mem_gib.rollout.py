"""The device's peak allocated memory over the measured window, in GiB."""


def read(r):
    if not r.get("peak_mem_bytes"):
        return None
    return r["peak_mem_bytes"] / 2 ** 30
