"""Tracing and profiling utilities (counterpart of ``training/profiling.py``).

The reference has only wall-clock timers (train.py:203-213, 296-299). Here:

* the recorder, the program's spans and counters: :func:`span` marks a
  layer boundary (the rollout, its steps, the model's forward, each GN
  block, set-up's phases), :func:`count` adds to a named counter, and
  :func:`recording` turns both on for a block and yields the
  :class:`Record` they fill, kept in memory for the caller to read. Off, as
  it is by default, ``span`` returns one shared no-op context after a
  single flag test and ``count`` returns at once: no allocation of its own,
  no clock, no profiler. On, while a ``torch.profiler`` is active, each
  span is also the profiler's host range ``gfd::<name>``, so its trace
  puts every kernel and every idle gap under the span that launched it;
* :func:`trace`, a ``torch.profiler`` trace of the CPU and the card written
  for TensorBoard's profiler plugin (``tensorboard --logdir <logdir>``);
* :func:`device_memory_stats`, the card's memory in use, its peak and its
  total, in MB (the reference's GPU-memory helper, train.py:102-106).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

RANGE_PREFIX = "gfd::"
# attributes a span passes on to the spans inside it: every span of one
# rollout carries its ``rollout`` (the id of the ``rollout`` span), every
# span of one of its steps the ``step``
SCOPES = ("rollout", "step")


class Span(NamedTuple):
    """One closed span: times on ``time.perf_counter_ns``; ``parent`` the id
    of the span open around it in the same thread (None at the top)."""
    id: int
    parent: Optional[int]
    name: str
    start_ns: int
    end_ns: int
    attrs: dict

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class Record:
    """What one :func:`recording` block recorded: its spans in the order
    they closed, and its counters."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def seconds(self, name: str) -> float:
        """The summed duration of the spans ``name``."""
        return sum(s.seconds for s in self.spans if s.name == name)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_record: Optional[Record] = None       # the record being filled; None: off


class _Open:
    """A span of ``record`` being recorded."""
    __slots__ = ("record", "name", "attrs", "id", "parent", "start", "range")

    def __init__(self, record: Record, name: str, attrs: dict):
        self.record, self.name, self.attrs = record, name, attrs

    def __enter__(self) -> "_Open":
        rec = self.record
        stack = rec._stack()
        self.id = next(rec._ids)
        self.parent = None
        if stack:
            up = stack[-1]
            self.parent = up.id
            self.attrs = {**{k: up.attrs[k] for k in SCOPES if k in up.attrs},
                          **self.attrs}
        if self.name == "rollout":
            self.attrs["rollout"] = self.id
        stack.append(self)
        self.range = None
        if torch._C._autograd._profiler_enabled():
            self.range = torch.profiler.record_function(RANGE_PREFIX + self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        rec = self.record
        rec._stack().pop()
        rec.spans.append(Span(self.id, self.parent, self.name, self.start, end,
                              self.attrs))
        return False


def span(name: str, **attrs):
    """A span of the program, ``with span("model.forward"): ...``: recorded
    with its attributes inside :func:`recording`, nothing outside it."""
    if _record is None:
        return _NO_SPAN
    return _Open(_record, name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` inside :func:`recording`."""
    rec = _record
    if rec is None:
        return
    with rec._lock:
        rec.counters[name] = rec.counters.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Record the block's spans and counters, in every thread:
    ``with recording() as rec: ...``, then read ``rec.spans`` and
    ``rec.counters``. A recording inside another takes the block's record
    for itself; the outer one resumes after it."""
    global _record
    outer, rec = _record, Record()
    _record = rec
    try:
        yield rec
    finally:
        _record = outer


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
