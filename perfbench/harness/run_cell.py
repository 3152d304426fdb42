"""One run of one cell: set-up, the window, the traced stretch, the check
and the result, for any traffic kind (``traffic/<mix>.json``'s ``kind``
names the class that drives it)."""

from __future__ import annotations

import importlib
import math
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench.harness import manifest

KINDS = {"rollout": ("perfbench.harness.rollout", "RolloutCell")}
OUT_DIR = manifest.BENCH_DIR / "out"


def make_cell(spec: dict, seed: int, device):
    module, cls = KINDS[spec["traffic"]["kind"]]
    return getattr(importlib.import_module(module), cls)(
        spec["config"], spec["traffic"], spec["workload"]["check"], seed, device)


def judge(per_run: List[Dict[str, np.ndarray]], limits: Dict[str, float]
          ) -> Tuple[int, int, Dict[str, dict]]:
    """(attempted, failed, checks): every answer (a rollout's trajectory)
    against each limit; an answer fails
    where any of its numbers is above its limit or not finite. ``checks``
    holds each number's largest reading beside its limit."""
    attempted = failed = 0
    worst = {name: 0.0 for name in limits}
    for run in per_run:
        n = len(next(iter(run.values())))
        bad = np.zeros(n, bool)
        for name, limit in limits.items():
            v = np.asarray(run[name], np.float64)
            bad |= ~(v <= limit)
            worst[name] = max(worst[name], float(np.max(np.where(
                np.isfinite(v), v, np.inf))))
        attempted += n
        failed += int(bad.sum())
    return attempted, failed, {name: {"value": worst[name], "limit": limits[name]}
                               for name in limits}


def run(spec: dict, bench: dict, workload: str, seed: int, seconds: float,
        trace: bool, device, t_start: float, cell=None):
    """(result without the device's name, checks) of one run. ``cell``
    replaces the cell ``spec`` makes (a test's broken one)."""
    cuda = torch.device(device).type == "cuda"
    c = cell if cell is not None else make_cell(spec, seed, device)
    c.setup()
    setup_s = time.perf_counter() - t_start
    peaks = [torch.cuda.max_memory_allocated(device) if cuda else 0]
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    e2e = c.window(seconds)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    readings = {"peak_mem_bytes": window_peak, **e2e,
                "window_marks_s": getattr(c, "marks", [])}
    if trace:
        OUT_DIR.mkdir(exist_ok=True)
        readings.update(c.profile(str(OUT_DIR / f"{workload}.trace.json")))
    peaks.append(torch.cuda.max_memory_allocated(device) if cuda else 0)
    c.release()
    limits = spec["workload"]["check"]["limits"]
    attempted, failed, checks = judge(c.readings(), limits)

    e2e_here = manifest.reported(bench["end_to_end"], workload)
    metrics = {}
    if trace:
        names = {m["name"] for m in e2e_here}
        for m in manifest.reported(bench["per_layer"], workload, names):
            value = manifest.reader(m["name"])(readings)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s, **e2e}
        for m in e2e_here:
            # ``<quantity>.<part>`` is the quantity measured alike, split
            # off for cells whose runs spread differently
            quantity = m["name"].split(".")[0]
            if quantity in values:
                metrics[m["name"]] = {"value": values[quantity], "unit": m["unit"]}
    result = {"correct": attempted > 0 and failed == 0, "attempted": attempted,
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu", "count": 1,
                         "memory_peak_bytes": int(max(peaks))}}
    if trace:
        result["device"]["busy_s"] = readings["busy_s"]
        result["device"]["window_s"] = readings["wall_s"]
        result["breakdown"] = readings["breakdown"]
    result["readings"] = {k: v for k, v in readings.items() if k != "breakdown"}
    return result, checks
