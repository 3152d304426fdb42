"""Checkpoint and resume (counterpart of ``gnn_fluid_dynamics_tpu/training/
checkpoint.py``; reference ``src/utils/logging.py:272-340``).

The JAX package's layout and cadence: ``<dir>/checkpoint-<mini_epoch>/``
holds the train state and ``meta.json`` (the counters, the full config, the
losses and the normalization statistics, so a checkpoint is self-contained);
``latest.json`` and ``best.json`` point at checkpoints, ``best`` promoted
when the validation error improves, and every other checkpoint is removed.

The train state is this package's own: ``state.pt``, a ``torch.save`` of the
module's state dict (BatchNorm statistics included), the optimizer's state
dict, the generator's state and the step count. A checkpoint of the JAX
package (orbax) is converted outside the package by
``scripts/torch_convert_flax_checkpoint.py`` into this layout with the
module's and the optimizer's state dicts and the step, and no generator
state: the JAX package's random key has no torch counterpart, so a resume
from it keeps the generator ``Trainer.init_state`` seeded from
``settings.random_seed``.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional, Tuple

import torch


def _floats(stats) -> Dict:
    return {k: (_floats(v) if isinstance(v, dict) else float(v))
            for k, v in stats.items()}


class Checkpointer:
    """Save and restore the train state, config and statistics with
    latest/best retention."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.best_error = float("inf")
        # the best error survives a resume, so a worse save after it cannot
        # demote the recorded best
        best_ptr = os.path.join(self.directory, "best.json")
        if os.path.exists(best_ptr):
            try:
                with open(best_ptr) as f:
                    self.best_error = float(json.load(f).get("error", "inf"))
            except (ValueError, OSError):
                pass

    # ---- save ---------------------------------------------------------------
    def save(self, state, trainer, train_losses: Optional[Dict] = None,
             valid_losses: Optional[Dict] = None):
        """Writes ``checkpoint-<mini_epoch>``, points ``latest`` at it, and
        ``best`` when the validation error improved (reference
        Logger.save_model, logging.py:272-340)."""
        tag = f"checkpoint-{trainer.mini_epoch_count}"
        meta = {
            "epoch": trainer.epoch_count,
            "mini_epoch": trainer.mini_epoch_count,
            "step": trainer.step_count,
            "sample_count": trainer.sample_count,
            "config": trainer.config.to_dict(),
            "train_losses": {k: float(v) for k, v in (train_losses or {}).items()},
            "valid_losses": {k: float(v) for k, v in (valid_losses or {}).items()},
        }
        stats = getattr(trainer.model, "stats", None)
        if stats is not None:
            meta["stats"] = _floats(stats)
        # the logger's wandb run, which a resume continues
        wandb = getattr(getattr(trainer, "logger", None), "wandb", None)
        if wandb is not None:
            meta["wandb_id"] = wandb.id
        path = os.path.join(self.directory, tag)
        self._write(path, state, meta)
        self._point(os.path.join(self.directory, "latest"), tag)
        if wandb is not None:
            # wandb artifact upload (reference logging.py:311-318)
            try:
                import wandb as _wandb
                art = _wandb.Artifact(
                    f"model-{os.path.basename(self.directory)}", type="model",
                    metadata={"mini_epoch": trainer.mini_epoch_count})
                art.add_dir(path)
                wandb.log_artifact(art)
            except Exception as e:
                print(f"wandb artifact upload failed ({e})")
        err = (valid_losses or {}).get("total_mean_error")
        if err is not None and err < self.best_error:
            self.best_error = float(err)
            self._point(os.path.join(self.directory, "best"), tag,
                        error=self.best_error)
        self._cleanup()

    def _write(self, path: str, state, meta: Dict):
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
        torch.save({"module": state.module.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "generator": state.generator.get_state(),
                    "step": state.step}, os.path.join(path, "state.pt"))
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2)

    def _point(self, link: str, tag: str, **extra):
        with open(link + ".json", "w") as f:
            json.dump({"checkpoint": tag, **extra}, f)

    def _cleanup(self):
        """Keep only the checkpoints latest and best point at (reference
        logging.py:293-327)."""
        keep = set()
        for name in ("latest", "best"):
            p = os.path.join(self.directory, name + ".json")
            if os.path.exists(p):
                with open(p) as f:
                    keep.add(json.load(f)["checkpoint"])
        for entry in os.listdir(self.directory):
            full = os.path.join(self.directory, entry)
            if (entry.startswith("checkpoint-") and os.path.isdir(full)
                    and entry not in keep):
                shutil.rmtree(full)

    # ---- load ---------------------------------------------------------------
    def resolve(self, which: str = "latest") -> Optional[str]:
        p = os.path.join(self.directory, which + ".json")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return os.path.join(self.directory, json.load(f)["checkpoint"])

    def load(self, which: str = "latest") -> Tuple[Optional[Dict], Optional[Dict]]:
        """(state tree on the CPU, meta) of ``which`` ("latest", "best" or a
        checkpoint's path), or (None, None)."""
        path = self.resolve(which) if which in ("latest", "best") else which
        if path is None or not os.path.exists(path):
            return None, None
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        tree = torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                          weights_only=True)
        return tree, meta


def restore_train_state(tree: Dict, state):
    """``state`` (a ``TrainState`` from ``Trainer.init_state``) with the
    module, optimizer, generator and step of ``tree`` put in place; returns
    it. A tree without generator state (one converted from the JAX package)
    leaves the generator as ``init_state`` seeded it, from
    ``settings.random_seed``, and says so. Raises for a tree without
    optimizer state."""
    if "optimizer" not in tree:
        raise ValueError(
            "the checkpoint holds no optimizer state (a module and a step "
            "only), so training cannot resume from it; use it for a "
            "rollout, or as a warm start through model.fpath")
    state.module.load_state_dict(tree["module"])
    state.optimizer.load_state_dict(tree["optimizer"])
    if "generator" in tree:
        state.generator.set_state(tree["generator"])
    else:
        print("The checkpoint holds no generator state (one converted from "
              "the JAX package, whose random key has no torch counterpart): "
              "the generator starts from settings.random_seed")
    state.step = int(tree["step"])
    return state
