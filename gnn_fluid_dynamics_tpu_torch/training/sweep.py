"""Hyperparameter sweep tool (counterpart of ``training/sweep.py``;
reference ``src/sweep.py``): grid or explicit-combination sweeps over
dot-path config overrides, sharded across array-job workers, each
combination run as a training subprocess with a temporary config.

Sweep config JSON::

    {"base_config": "config/train.json",
     "mode": "grid",                       # or "explicit"
     "parameters": {"training.lr_max": [1e-3, 3e-4],
                    "model.hidden_width": [64, 128]},
     "combinations": [ {...}, ... ]        # for mode == "explicit"
    }

Usage::

    python -m gnn_fluid_dynamics_tpu_torch.training.sweep --config config/sweep.json \
        [--shard-index N --num-shards M] [--dry-run] [--device cpu]

``--device`` is handed to each job's ``training.train`` (the card unless
``cpu`` is given); the JAX package's sweep has no such flag, since its
train CLI picks its device itself.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import tempfile
from typing import Any, Dict, List

# the directory that holds this package
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def set_nested_value(data: Dict, dotted_key: str, value: Any):
    """Set config value by dot path (reference sweep.py:14-31)."""
    keys = dotted_key.split(".")
    node = data
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def generate_parameter_combinations(sweep_cfg: Dict) -> List[Dict[str, Any]]:
    """Grid product or explicit list (reference sweep.py:95-124)."""
    mode = sweep_cfg.get("mode", "grid")
    if mode == "explicit":
        return list(sweep_cfg["combinations"])
    params = sweep_cfg["parameters"]
    keys = list(params)
    return [dict(zip(keys, values))
            for values in itertools.product(*(params[k] for k in keys))]


def run_training_job(base_config: Dict, overrides: Dict[str, Any],
                     index: int, dry_run: bool = False,
                     device: str = "cuda") -> int:
    """Write a temporary config with the overrides and run
    ``training.train`` on it as a subprocess on ``device`` (reference
    sweep.py:34-92); returns its exit code."""
    cfg = json.loads(json.dumps(base_config))
    for key, value in overrides.items():
        set_nested_value(cfg, key, value)
    name = cfg.get("logging", {}).get("name") or "sweep"
    set_nested_value(cfg, "logging.name", f"{name}-{index}")
    print(f"[sweep {index}] overrides: {overrides}")
    if dry_run:
        return 0
    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
        json.dump(cfg, f, indent=2)
        tmp = f.name
    # the job finds this package from any working directory
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH")) if p)
    try:
        proc = subprocess.run(
            [sys.executable, "-m",
             "gnn_fluid_dynamics_tpu_torch.training.train",
             "--config", tmp, "--device", device], env=env)
        return proc.returncode
    finally:
        os.unlink(tmp)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--shard-index", type=int,
                        default=int(os.environ.get("SLURM_ARRAY_TASK_ID", 0)))
    parser.add_argument("--num-shards", type=int,
                        default=int(os.environ.get("SLURM_ARRAY_TASK_COUNT", 1)))
    parser.add_argument("--dry-run", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="each job's training device: cuda (the "
                             "default) or cpu")
    args = parser.parse_args(argv)

    with open(args.config) as f:
        sweep_cfg = json.load(f)
    base_path = sweep_cfg["base_config"]
    if not os.path.isabs(base_path) and not os.path.exists(base_path):
        # resolve relative to the sweep file (and failing that, the repo
        # root) so the CLI works from any working directory
        for root in (os.path.dirname(os.path.abspath(args.config)),
                     _PACKAGE_ROOT):
            cand = os.path.join(root, base_path)
            if os.path.exists(cand):
                base_path = cand
                break
    with open(base_path) as f:
        base_config = json.load(f)

    combos = generate_parameter_combinations(sweep_cfg)
    mine = [(i, c) for i, c in enumerate(combos)
            if i % args.num_shards == args.shard_index]
    print(f"Sweep: {len(combos)} combinations, shard {args.shard_index}/"
          f"{args.num_shards} runs {len(mine)}")
    for i, overrides in mine:
        rc = run_training_job(base_config, overrides, i, args.dry_run,
                              args.device)
        if rc != 0:
            print(f"[sweep {i}] FAILED rc={rc}; aborting "
                  "(reference sweep.py:170-172 behavior)")
            sys.exit(rc)


if __name__ == "__main__":
    main()
