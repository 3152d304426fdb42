"""Rollout steps/s of two checkouts of the port on one card, in turns: the
kernel route of ``chip_smoke.py``'s three rollout paths (FluxD, FvgnF,
FluxD-valid), each checkout in processes of its own.

    python3 scripts/torch_rollout_ab.py A_DIR B_DIR [--pairs N]

A_DIR and B_DIR are checkouts (e.g. ``git archive`` of two commits unpacked
under the ignored ``build/``). Each process imports ``chip_smoke.py`` and the
package of one checkout, builds its kernels, the bench mesh and the
FluxD-valid batch as ``chip_smoke.py`` does, and times WINDOWS rollouts of
STEPS steps per path after a warm-up (host clock, ending in a synchronize).
The processes run A, B, B, A, A, B, ... for ``--pairs`` pairs. Prints one
JSON line per process and a summary line of each side's median and
quartiles of its windows' steps/s per path, with the card's name and power
limit; without a card it exits non-zero.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

WINDOWS, STEPS = 3, 100

MEASURE = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from gnn_fluid_dynamics_tpu_torch.graph import to_static_bands
from gnn_fluid_dynamics_tpu_torch.rollout.engine import RolloutConfig, rollout_scan
dev = torch.device("cuda", 0)
cs.kernels.build_kernels()
graph, _ = cs.bench_mesh(dev)
_, vgraph = cs.valid_data(dev)
out = {}
for path in cs.PATHS:
    g = vgraph if path == "FluxD-valid" else graph
    kern, _, feats = cs.path_models(path, g)
    cfg = RolloutConfig(num_steps=%(steps)d, compute_error=False)
    rollout_scan(kern, g, feats, config=RolloutConfig(num_steps=5, compute_error=False))
    rates = []
    for _ in range(%(windows)d):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rollout_scan(kern, g, feats, config=cfg)
        torch.cuda.synchronize()
        rates.append(%(steps)d / (time.perf_counter() - t0))
    out[path] = rates
print(json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("a_dir")
    ap.add_argument("b_dir")
    ap.add_argument("--pairs", type=int, default=8)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_rollout_ab: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    dirs = {"A": str(Path(args.a_dir).resolve()),
            "B": str(Path(args.b_dir).resolve())}
    order = []
    for i in range(args.pairs):
        order += ["A", "B"] if i % 2 == 0 else ["B", "A"]
    rates = {"A": {}, "B": {}}
    code = MEASURE % {"steps": STEPS, "windows": WINDOWS}
    for side in order:
        res = subprocess.run([sys.executable, "-c", code, dirs[side]],
                             capture_output=True, text=True, cwd=dirs[side])
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"side": side, "dir": dirs[side], **line}), flush=True)
        for path, r in line.items():
            rates[side].setdefault(path, []).extend(r)
    summary = {side: {path: {"median": float(np.median(r)),
                             "q1": float(np.percentile(r, 25)),
                             "q3": float(np.percentile(r, 75)),
                             "windows": len(r)}
                      for path, r in by_path.items()}
               for side, by_path in rates.items()}
    print(json.dumps({"card": card, "steps_per_window": STEPS,
                      "order": "".join(order), "steps_per_s": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
