"""The readings a cell's limits are set from: for each seed, the program's
numbers against the plain reference (the lower readings) and the control's,
the reference computed one precision below the configuration's (the upper
readings).

    python3 perfbench/control.py --workload <cell> --seeds 1 2 3 [--out FILE]

Each seed takes one rollout; no measured window. Prints one JSON line a
seed and, at the end, the largest program reading and the smallest control
reading of each compared number. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def seed_readings(spec: dict, seed: int, device, control: str) -> dict:
    """One seed's program and control readings: each compared number's
    largest value."""
    import numpy as np
    from perfbench.harness.run_cell import make_cell

    t0 = time.perf_counter()
    cell = make_cell(spec, seed, device)
    cell.setup()
    cell.window(0.0)
    cell.release()
    out = {"seed": seed}
    for side, kw in (("program", {}), ("control", {"control": control})):
        per = cell.readings(**kw)[0]
        out[side] = {k: float(np.max(v)) for k, v in per.items()}
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", default="fp8")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from perfbench.harness import manifest
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    spec = manifest.cell(args.workload)
    lines = []
    for seed in args.seeds:
        r = seed_readings(spec, seed, torch.device("cuda", 0), args.control)
        lines.append(r)
        print(json.dumps(r), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(lines, f)
    for side, pick in (("program", max), ("control", min)):
        print(side, {k: pick(r[side][k] for r in lines) for k in lines[0][side]},
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
