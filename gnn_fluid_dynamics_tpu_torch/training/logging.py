"""Metrics logging (counterpart of ``gnn_fluid_dynamics_tpu/training/
logging.py``, the reference's ``Logger``, ``src/utils/logging.py:32-366``).

A run gets a directory ``<base_dir>/<project>/<group>/<name>(<stamp>)`` with
its config and git metadata (``config.json``), every metric as one JSON line
in ``metrics.jsonl``, and validation snapshots as ``.npz`` arrays. wandb
and TensorBoard are optional sinks, as in the JAX package: where a config
asks for one that cannot start, a message says so and the metrics go on
into ``metrics.jsonl``. A run resumed from a checkpoint continues the
wandb run that checkpoint names (``resume_wandb_id``, from its
``meta.json``). TensorBoard's scalars are written through
``torch.utils.tensorboard`` under ``<run>/tb``, each at its record's step.
The JAX package's snapshot rendering is not ported.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from datetime import datetime
from typing import Any, Dict, Optional

import numpy as np


def git_metadata() -> Dict[str, str]:
    """Commit, branch and whether the tree is dirty (reference
    ``Logger._check_git``, logging.py:65-104, without its interactive
    prompt); empty where git is absent."""
    def run(*args):
        try:
            return subprocess.run(["git", *args], capture_output=True,
                                  text=True, timeout=5).stdout.strip()
        except Exception:
            return ""
    return {
        "commit": run("rev-parse", "HEAD"),
        "branch": run("rev-parse", "--abbrev-ref", "HEAD"),
        "dirty": bool(run("status", "--porcelain")),
    }


class Logger:
    """Experiment logger: the run's directory, its JSON-lines metrics and
    the optional wandb and TensorBoard sinks."""

    def __init__(self, config, base_dir: str = "runs",
                 resume_wandb_id: Optional[str] = None):
        stamp = datetime.now().strftime("%m%d%H%M%S")
        self.name = f"{config.logging.name or 'run'}({stamp})"
        self.directory = os.path.join(
            base_dir, config.logging.project or "default",
            config.logging.group or "default", self.name)
        os.makedirs(self.directory, exist_ok=True)
        self.metrics_path = os.path.join(self.directory, "metrics.jsonl")
        self._metrics_file = open(self.metrics_path, "a")
        with open(os.path.join(self.directory, "config.json"), "w") as f:
            json.dump({"config": config.to_dict(), "git": git_metadata(),
                       "flat": config.to_flat_dict()}, f, indent=2, default=str)

        self.wandb = None
        if config.logging.use_wandb:
            try:
                import wandb
                self.wandb = wandb.init(
                    project=config.logging.project or None,
                    group=config.logging.group or None,
                    name=self.name, id=resume_wandb_id,
                    resume="must" if resume_wandb_id else None,
                    config=config.to_flat_dict())
            except Exception as e:
                print(f"wandb unavailable ({e}); falling back to JSONL only")
                self.wandb = None

        # TensorBoard (reference logging.py:147-177 leaves it a stub):
        # event files under <run>/tb, scalars only
        self.tb = None
        if config.logging.use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.tb = SummaryWriter(os.path.join(self.directory, "tb"))
            except Exception as e:
                print(f"tensorboard unavailable ({e}); JSONL only")
                self.tb = None

    def _emit(self, record: Dict[str, Any]):
        record["ts"] = time.time()
        self._metrics_file.write(json.dumps(record, default=float) + "\n")
        self._metrics_file.flush()
        # the step is read once for both sinks (the JAX package's wandb
        # branch pops it first, and its TensorBoard scalars then fall to 0)
        step = record.get("step")
        if self.wandb is not None:
            self.wandb.log({k: v for k, v in record.items()
                            if k not in ("step", "ts")}, step=step)
        if self.tb is not None:
            for k, v in record.items():
                if k in ("step", "ts") or not isinstance(v, (int, float)):
                    continue
                self.tb.add_scalar(k, v, global_step=int(step or 0))
            self.tb.flush()

    def save_loss(self, losses: Dict[str, float], step: int, prefix: str):
        """(reference logging.py:195-211)"""
        self._emit({f"{prefix}/{k}": float(v) for k, v in losses.items()}
                   | {"step": step})

    def save_scalar(self, value: float, step: int, prefix: str):
        self._emit({prefix: float(value), "step": step})

    def save_plot(self, values, step: int, prefix: str):
        """A line series (reference logging.py:213-232), stored raw."""
        self._emit({prefix: list(map(float, values)), "step": step})

    def save_plots(self, arrays: Dict[str, Dict[str, list]], step: int,
                   prefix: str):
        for name, series in arrays.items():
            for key, values in series.items():
                self.save_plot(values, step, f"{prefix}/{name}/{key}")

    def save_snapshot(self, snapshot_data: Dict, step: int, prefix: str):
        """Velocity-field snapshots (reference logging.py:234-270) as raw
        arrays, one ``.npz`` per timestep; not rendered."""
        if not snapshot_data:
            return
        snap_dir = os.path.join(self.directory, "snapshots")
        os.makedirs(snap_dir, exist_ok=True)
        for timestep, meshes in snapshot_data.items():
            out = {f"{mesh}/{key}": np.asarray(arr)
                   for mesh, payload in meshes.items()
                   for key, arr in payload.items()}
            np.savez(os.path.join(snap_dir, f"step{step}_t{timestep}.npz"),
                     **out)

    def close(self):
        self._metrics_file.close()
        if self.wandb is not None:
            self.wandb.finish()
        if self.tb is not None:
            self.tb.close()
