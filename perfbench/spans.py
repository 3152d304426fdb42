"""The program's own spans and counters in one cell, read as a traced run
would read them with the program's recorder on
(``gnn_fluid_dynamics_tpu_torch/training/profiling.py::recording``):
set-up and the profiled stretch recorded, the window not. A tool run by
hand beside the benchmark; its command and its readings stay as they are.

    python3 perfbench/spans.py --workload <cell> --seed <n> [--seconds <s>] [--pairs <n>]

Prints one JSON line of readings:

* ``device_ms_by_span``: per profiled step, the span union of the kernels
  launched inside each ``gfd::`` range (inclusive of the ranges inside it);
* ``idle_ms_by_span``: per profiled step, each idle stretch of the device
  put down to the innermost ``gfd::`` range around the launch that ended it;
* ``host_ms_by_span``: each span's self time (its length less its
  children's) per profiled step;
* ``setup_s_by_span``: set-up's ``setup.*`` spans summed by name;
  ``harness_s_by_span``: the harness's own set-up steps (``harness.*``,
  :func:`harness_spans`); ``before_setup_s``, from the process's first
  line to the cell's set-up (imports); ``setup_uncovered_s``, the rest of
  set-up that no span covers;
* ``counters``: the recorder's counters in set-up and in the stretch;
* ``spans_per_step``: how many of each span a profiled step opened;
* ``metrics``: ``gn_block_device_ms``, ``engine_device_ms`` (the union over
  the engine's derive, metrics, save and feedback spans),
  ``setup_geometry_s``, ``setup_graph_s`` and ``setup_warmup_s`` (the
  first ``rollout`` span);
* ``hooks``: the harness's own readings of the same stretch
  (``gn_device_s`` from its forward hooks), for comparison.

With ``--pairs`` the window runs that many pairs of times, the recorder off
and on in turns (the order alternating), each with its throughput, and then
the profiled stretch as many pairs of times, each with its wall time: what
recording costs, in the window and under the profiler.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Iterable, List  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.harness.trace import Trace, merged, union_length  # noqa: E402

PREFIX = "gfd::"
ENGINE_SPANS = ("rollout.derive", "rollout.metrics", "rollout.save",
                "rollout.feedback")
NO_SPAN = "(no span)"


def _ranges(tr: Trace) -> List[tuple]:
    """The trace's ``gfd::`` host ranges as (start, end, name), by start,
    the outer of two that start together first."""
    return sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"][len(PREFIX):]) for e in tr.annotations
                   if e.get("name", "").startswith(PREFIX)),
                  key=lambda r: (r[0], -r[1]))


def device_ms(tr: Trace, names: Iterable[str], steps: int) -> float:
    """The span union of the kernels launched inside the ``gfd::`` ranges
    of ``names``, in ms a step."""
    return union_length(Trace.span(k) for n in names
                        for k in tr.launched_in(PREFIX + n)) * 1e-3 / steps


def device_ms_by_span(tr: Trace, steps: int) -> Dict[str, float]:
    return {n: device_ms(tr, [n], steps)
            for n in sorted({n for _, _, n in _ranges(tr)})}


def innermost(ranges: List[tuple], t: float) -> str:
    """The name of the innermost of ``ranges`` (as :func:`_ranges` orders
    them) around ``t``: the latest-starting one that has not ended (ranges
    of one thread nest)."""
    i = bisect.bisect_right(ranges, t, key=lambda r: r[0]) - 1
    while i >= 0:
        start, end, name = ranges[i]
        if start <= t <= end:
            return name
        i -= 1
    return NO_SPAN


def idle_ms_by_span(tr: Trace, steps: int) -> Dict[str, float]:
    ranges = _ranges(tr)
    spans = merged(Trace.span(e) for e in tr.device)
    starts = {}
    for e in tr.device:
        starts.setdefault(float(e["ts"]), e)
    out: Dict[str, float] = {}
    for (_, end), (nxt, _) in zip(spans, spans[1:]):
        lau = tr.launch.get(starts[nxt].get("args", {}).get("correlation"))
        name = innermost(ranges, float(lau["ts"])) if lau else NO_SPAN
        out[name] = out.get(name, 0.0) + (nxt - end) * 1e-3 / steps
    return out


def host_ms_by_span(spans: list, steps: int) -> Dict[str, float]:
    """Each span's self time, summed by name, in ms a step."""
    children: Dict[int, list] = {}
    for s in spans:
        children.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    out: Dict[str, float] = {}
    for s in spans:
        own = s.end_ns - s.start_ns - union_length(children.get(s.id, ()))
        out[s.name] = out.get(s.name, 0.0) + own * 1e-6 / steps
    return out


def setup_s_by_span(spans: list) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for s in spans:
        if s.name.startswith("setup."):
            out[s.name] = out.get(s.name, 0.0) + s.seconds
    return out


def setup_metrics(by_span: Dict[str, float], spans: list) -> Dict[str, float]:
    warmup = [s for s in spans if s.name == "rollout"]
    return {"setup_geometry_s": by_span.get("setup.connectivity", 0.0)
            + by_span.get("setup.rcm", 0.0),
            "setup_graph_s": by_span.get("setup.batch", 0.0)
            + by_span.get("setup.static_bands", 0.0),
            "setup_warmup_s": warmup[0].seconds if warmup else None}


def traced_readings(tr: Trace, spans: list, steps: int) -> dict:
    """The readings of one profiled stretch recorded with the recorder on."""
    per_step: Dict[str, float] = {}
    for s in spans:
        per_step[s.name] = per_step.get(s.name, 0.0) + 1.0 / steps
    device = device_ms_by_span(tr, steps)
    return {"device_ms_by_span": device,
            "idle_ms_by_span": idle_ms_by_span(tr, steps),
            "host_ms_by_span": host_ms_by_span(spans, steps),
            "spans_per_step": per_step,
            "gn_block_device_ms": device.get("gn_block"),
            "engine_device_ms": device_ms(tr, ENGINE_SPANS, steps)}


@contextlib.contextmanager
def harness_spans():
    """The harness's own set-up steps (its meshes, flow, weights and ground
    truth) as spans ``harness.<step>`` for the block, so that set-up's part
    outside the program's spans is split too."""
    from gnn_fluid_dynamics_tpu_torch.training import profiling
    from perfbench.harness import meshgen, rollout

    def spanned(name, fn):
        def call(*args, **kwargs):
            with profiling.span(name):
                return fn(*args, **kwargs)
        return call

    patched = [(rollout, "make_meshes", "harness.meshes"),
               (meshgen, "flow_fields", "harness.flow"),
               (rollout, "make_weights", "harness.weights"),
               (rollout.RolloutCell, "_ground_truth", "harness.ground_truth")]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patched]
    for obj, attr, name in patched:
        setattr(obj, attr, spanned(name, getattr(obj, attr)))
    try:
        yield
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)


def profiled(cell, path: str, recorded: bool):
    """``cell.profile(path)`` (its hook readings) and, with ``recorded``,
    the record of the profiled rollout alone: the same stretch run
    untraced before it is not recorded."""
    import torch
    from gnn_fluid_dynamics_tpu_torch.training import profiling

    scan, records = cell.rollout, []

    def rollout(*args, **kwargs):
        if not torch._C._autograd._profiler_enabled():
            return scan(*args, **kwargs)
        with profiling.recording() as rec:
            records.append(rec)
            return scan(*args, **kwargs)

    if recorded:
        cell.rollout = rollout
    try:
        hooks = cell.profile(path)
    finally:
        cell.rollout = scan
    return hooks, (records[0] if recorded else None)


def run(spec: dict, seed: int, seconds: float, pairs: int, device,
        t_start: float, trace_dir: Path) -> dict:
    """Set-up recorded, the window (``pairs`` pairs off and on, else once
    off), the profiled stretch recorded; the readings."""
    import torch
    from gnn_fluid_dynamics_tpu_torch.training import profiling
    from perfbench.harness import run_cell

    cell = run_cell.make_cell(spec, seed, device)
    before_setup = time.perf_counter() - t_start
    with profiling.recording() as setup_rec, harness_spans():
        cell.setup()
    setup_s = time.perf_counter() - t_start
    by_span = setup_s_by_span(setup_rec.spans)
    harness = {}
    for s in setup_rec.spans:
        if s.name.startswith("harness."):
            harness[s.name] = harness.get(s.name, 0.0) + s.seconds
    top = [(s.start_ns, s.end_ns) for s in setup_rec.spans if s.parent is None]
    out = {"setup_s": setup_s, "setup_s_by_span": by_span,
           "harness_s_by_span": harness, "before_setup_s": before_setup,
           "setup_uncovered_s": setup_s - before_setup
           - union_length(top) * 1e-9,
           "counters": {"setup": setup_rec.counters},
           "metrics": setup_metrics(by_span, setup_rec.spans)}
    trace_dir.mkdir(parents=True, exist_ok=True)
    windows, stretches = [], []
    for i in range(pairs):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            cell.results.clear()
            with (profiling.recording() if on else contextlib.nullcontext()):
                rate = cell.window(seconds)["rollout_throughput"]
            windows.append({"recording": on, "rollout_throughput": rate})
    if not pairs:
        cell.window(seconds)
    for i in range(pairs):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            hooks, _ = profiled(cell, str(trace_dir / "spans_pair.trace.json"), on)
            stretches.append({"recording": on, "wall_s": hooks["wall_s"],
                              "untraced_wall_s": hooks["untraced_wall_s"]})
    out.update(windows=windows, stretches=stretches)
    path = str(trace_dir / "spans.trace.json")
    hooks, rec = profiled(cell, path, True)
    steps = hooks["steps"]
    traced = traced_readings(Trace.load(path), rec.spans, steps)
    out["metrics"].update(gn_block_device_ms=traced.pop("gn_block_device_ms"),
                          engine_device_ms=traced.pop("engine_device_ms"))
    out.update(traced)
    out["counters"]["traced"] = rec.counters
    out["hooks"] = {k: v for k, v in hooks.items() if k != "breakdown"}
    out["breakdown"] = hooks["breakdown"]
    if torch.device(device).type == "cuda":
        out["device"] = torch.cuda.get_device_name(0)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--pairs", type=int, default=0)
    args = p.parse_args(argv)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    import torch
    from perfbench.harness import manifest
    if not torch.cuda.is_available():
        print("perfbench/spans.py: needs a CUDA device", file=sys.stderr)
        return 2
    out = run(manifest.cell(args.workload), args.seed, args.seconds,
              args.pairs, torch.device("cuda", 0), T_START,
              manifest.BENCH_DIR / "out")
    out.update(workload=args.workload, seed=args.seed)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
