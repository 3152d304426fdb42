"""Tracing and profiling utilities (counterpart of ``training/profiling.py``).

The reference has only wall-clock timers (train.py:203-213, 296-299). Here:

* :class:`StepTimer`, the reference's per-mini-epoch wall-clock timers, which
  synchronize the card before stopping the clock, so that a section's time
  is the device's work and not only its launch;
* :func:`trace`, a ``torch.profiler`` trace of the CPU and the card written
  for TensorBoard's profiler plugin (``tensorboard --logdir <logdir>``);
* :func:`annotate`, a named region in that trace
  (``torch.profiler.record_function``);
* :func:`device_memory_stats`, the card's memory in use, its peak and its
  total, in MB (the reference's GPU-memory helper, train.py:102-106).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch


def _synchronize(sync) -> None:
    """Wait for the card that holds ``sync`` (a tensor, or a tree of them in
    a dict, list or tuple); nothing for tensors on the CPU."""
    if isinstance(sync, torch.Tensor):
        if sync.device.type == "cuda":
            torch.cuda.synchronize(sync.device)
    elif isinstance(sync, dict):
        for v in sync.values():
            _synchronize(v)
    elif isinstance(sync, (list, tuple)):
        for v in sync:
            _synchronize(v)


class StepTimer:
    """Accumulating wall-clock timer that waits for the device."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str, sync: Optional[object] = None):
        """Time the block as ``name``; with ``sync`` (a tensor, or a dict,
        list or tuple of them), the card that holds it is synchronized
        before the clock stops."""
        t0 = time.time()
        yield
        if sync is not None:
            _synchronize(sync)
        self.totals[name] = self.totals.get(name, 0.0) + time.time() - t0
        self.counts[name] = self.counts.get(name, 0) + 1

    def mean(self, name: str) -> float:
        return self.totals.get(name, 0.0) / max(self.counts.get(name, 0), 1)

    def report(self) -> Dict[str, float]:
        return {name: self.mean(name) for name in self.totals}

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace of the CPU and, where there is one, the card:
    ``with trace("/tmp/trace"): run()`` writes
    ``<logdir>/<worker>.<time>.pt.trace.json`` for TensorBoard's profiler
    plugin."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def annotate(name: str):
    """A named region visible in the profiler's timeline."""
    return torch.profiler.record_function(name)


def device_memory_stats(device=None) -> Dict[str, float]:
    """The card's memory in MB: in use, the peak in use, and the limit (its
    total memory); ``{}`` for the CPU, or where there is no card."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    total = torch.cuda.get_device_properties(device).total_memory
    return {
        "bytes_in_use_mb": stats.get("allocated_bytes.all.current", 0)
        / 1024 ** 2,
        "peak_bytes_in_use_mb": stats.get("allocated_bytes.all.peak", 0)
        / 1024 ** 2,
        "bytes_limit_mb": total / 1024 ** 2,
    }
