"""Reduction of a profiled stretch to the benchmark's readings: the
profiler's Chrome trace (``torch.profiler``, CPU and CUDA activity) read as
intervals.

* device activity: kernels, memory copies and memsets, as the union of
  their spans (a kernel launched by programmatic dependent launch starts
  before the one ahead of it ends, so a sum would count the overlap twice);
* attribution: a kernel belongs to a host range (``record_function``) when
  the runtime call that launched it, found by the trace's correlation id,
  lies inside the range;
* the breakdown: the device operations that took most time, and the longest
  idle stretches of the device named by the host operation that launched
  the work that ended them.
"""

from __future__ import annotations

import bisect
import json
from typing import Dict, Iterable, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def union_length(spans: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by the (start, end) spans, overlaps once."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def merged(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The spans' union as disjoint sorted spans."""
    out: List[List[float]] = []
    for start, end in sorted(spans):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def inside(t: float, spans: List[Tuple[float, float]]) -> bool:
    """Whether ``t`` lies in one of the disjoint sorted ``spans``."""
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i >= 0 and spans[i][0] <= t <= spans[i][1]


class Trace:
    """The events of one exported trace, in microseconds."""

    def __init__(self, events: List[dict]):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self.device = [e for e in xs if e.get("cat") in DEVICE_CATS]
        self.kernels = [e for e in self.device if e["cat"] == "kernel"]
        self.launch = {}
        for e in xs:
            if e.get("cat") in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    self.launch[corr] = e
        self.annotations = [e for e in xs if e.get("cat") == "user_annotation"]
        ops = sorted((e for e in xs if e.get("cat") in ("cpu_op", "user_annotation")),
                     key=lambda e: e["ts"])
        self._ops = ops
        self._op_ts = [e["ts"] for e in ops]

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls(json.load(f).get("traceEvents", []))

    @staticmethod
    def span(e) -> Tuple[float, float]:
        return (float(e["ts"]), float(e["ts"]) + float(e["dur"]))

    def busy_us(self) -> float:
        return union_length(self.span(e) for e in self.device)

    def launched_in(self, name: str) -> List[dict]:
        """The kernels whose launch lies inside a host range ``name``, and
        the count of kernels whose launch the trace does not show."""
        ranges = merged(self.span(e) for e in self.annotations
                        if e.get("name") == name)
        out = []
        for k in self.kernels:
            lau = self.launch.get(k.get("args", {}).get("correlation"))
            if lau is not None and inside(float(lau["ts"]), ranges):
                out.append(k)
        return out

    def unlaunched(self) -> int:
        return sum(1 for k in self.kernels
                   if k.get("args", {}).get("correlation") not in self.launch)

    def h2d_bytes(self) -> int:
        return int(sum(e.get("args", {}).get("bytes", 0) for e in self.device
                       if e["cat"] == "gpu_memcpy" and "HtoD" in e.get("name", "")))

    def _host_op(self, t: float) -> str:
        """The innermost host operation running at ``t``."""
        best, i = None, bisect.bisect_right(self._op_ts, t) - 1
        for e in self._ops[max(0, i - 400):i + 1][::-1]:
            if e["ts"] <= t <= e["ts"] + e["dur"] and (
                    best is None or e["dur"] < best["dur"]):
                best = e
        return best["name"] if best is not None else "(no host operation)"

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """{"device_ops": [[name, seconds]], "idle_gaps": [[name,
        seconds]]}, each the ``top`` largest."""
        per_op: Dict[str, float] = {}
        for e in self.device:
            name = e.get("name", "?")[:160]
            per_op[name] = per_op.get(name, 0.0) + float(e["dur"]) * 1e-6
        gaps: Dict[str, float] = {}
        spans = merged(self.span(e) for e in self.device)
        starts = {}
        for e in self.device:
            starts.setdefault(float(e["ts"]), e)
        for (_, end), (nxt, _) in zip(spans, spans[1:]):
            e = starts.get(nxt)
            lau = self.launch.get(e.get("args", {}).get("correlation")) if e else None
            name = self._host_op(float(lau["ts"])) if lau else "(unknown)"
            gaps[name[:160]] = gaps.get(name[:160], 0.0) + (nxt - end) * 1e-6
        def best(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": best(per_op), "idle_gaps": best(gaps)}
