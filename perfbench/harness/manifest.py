"""What the benchmark holds, found by name: one file per configuration
(``configs/<name>.json``), traffic mix (``traffic/<name>.json``), cell
(``workloads/<name>.json``) and per-layer metric (``metrics/<name>.py``),
and the metrics' entries in ``BENCHMARK.json`` at the checkout's root.
Adding one of each is adding files; nothing here names them."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def names(kind: str, bench_dir: Path = BENCH_DIR) -> list:
    """The names of every ``kind`` entry (``configs``, ``traffic``,
    ``workloads`` or ``metrics``)."""
    suffix = ".py" if kind == "metrics" else ".json"
    return sorted(p.name[:-len(suffix)] for p in (bench_dir / kind).glob("*" + suffix)
                  if not p.name.startswith("_"))


def entry(kind: str, name: str, bench_dir: Path = BENCH_DIR) -> dict:
    path = bench_dir / kind / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no {kind} entry {name!r}; there are {names(kind, bench_dir)}")
    return _load_json(path)


def cell(name: str, bench_dir: Path = BENCH_DIR) -> Dict[str, dict]:
    """The cell ``name`` with its configuration and traffic mix."""
    w = entry("workloads", name, bench_dir)
    return {"workload": w, "config": entry("configs", w["config"], bench_dir),
            "traffic": entry("traffic", w["traffic"], bench_dir)}


def reader(metric: str, bench_dir: Path = BENCH_DIR) -> Callable[[dict], Optional[float]]:
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = bench_dir / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def benchmark(root: Path) -> dict:
    return _load_json(root / "BENCHMARK.json")


def reported(metrics: list, workload: str, e2e_names=None) -> list:
    """The metrics of ``metrics`` that the cell ``workload`` reports: those
    that list it, and those without a list whose moved end-to-end metric
    (``e2e_names``) the cell reports."""
    out = []
    for m in metrics:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif e2e_names is None or m.get("moves") in e2e_names:
            out.append(m)
    return out
