"""Run one cell of the port's benchmark once, on the card this process sees.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, kernel build or load, meshes, graphs, model, warm-up), a
measured window of ``--seconds``, with ``--trace 1`` a profiled stretch
after it, then the check against the plain reference. The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; its last key,
``checks``, gives each compared number with its limit, as do the last lines
of standard error. Exits non-zero without printing a result when there is
no card, when the program is missing, or when JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gnn_fluid_dynamics_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({k.split(".")[0] for k in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    # every build and kernel cache in the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    from perfbench.harness import manifest, run_cell

    bench = manifest.benchmark(ROOT)
    spec = manifest.cell(args.workload)
    import torch
    chips = int(spec["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              "available", file=sys.stderr)
        return 2
    result, checks = run_cell.run(spec, bench, args.workload, args.seed,
                                  args.seconds, bool(args.trace),
                                  torch.device("cuda", 0), T_START)
    result["device"]["kind"] = torch.cuda.get_device_name(0)
    result["device"]["power_limit"] = power_limit()
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
