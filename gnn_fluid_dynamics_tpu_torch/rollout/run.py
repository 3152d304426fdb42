"""Rollout CLI (counterpart of ``rollout/run.py``; reference
``src/rollout.py main()``, rollout.py:391-451): read the rollout config and
the checkpoint it names (``model.fpath``), adopt the checkpoint's training
config and its normalization statistics so that the rollout is
self-contained, run the autoregressive rollout of the validation split, and
write ``errors.json`` and, with ``--save full``, ``data0.h5`` and
``meta.json`` under ``rollouts/<project>/<output or name>/``.

    python -m gnn_fluid_dynamics_tpu_torch.rollout.run --config config/rollout.json
    python -m gnn_fluid_dynamics_tpu_torch.rollout.run --config ... --device cpu --save off

It runs on the card unless ``--device cpu`` is given, and raises when there
is none. The checkpoint is one of this package's, or one of the JAX
package's converted by ``scripts/torch_convert_flax_checkpoint.py``.

:func:`restore_model` and :func:`rollout_dataset` are the two halves around
the dataset: a caller with a dataset of its own (one the configured data
module does not make) runs the second on it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Dict, List, Optional

import torch

from gnn_fluid_dynamics_tpu_torch import resolve_device


def restore_model(ckpt_path: str, device, config=None):
    """The model of the checkpoint at ``ckpt_path`` (a checkpoint's
    directory, or ``<dir>/latest`` or ``<dir>/best``) on ``device``:
    (model, config, meta). ``config`` is the checkpoint's training config
    with the rollout config's ``settings``, ``rollout``, ``dataset.dpath``
    (where set) and logging names (where set) put in (reference
    rollout.py:404-411, 71-73); the statistics are the checkpoint's. Every
    weight of the module must come from the checkpoint with its name and
    shape: a rollout of a partly random model is a wrong answer, so any
    entry ``load_params_flexible`` skips raises ``ValueError`` naming it
    (the JAX package restores against a template and raises the same).
    The tolerant load stays the trainer's warm start."""
    from gnn_fluid_dynamics_tpu_torch.training.checkpoint import Checkpointer
    from gnn_fluid_dynamics_tpu_torch.training.config import Config
    from gnn_fluid_dynamics_tpu_torch.training.model_loading import (
        load_params_flexible)
    from gnn_fluid_dynamics_tpu_torch.training.train import build_model
    ckpt_dir = os.path.dirname(ckpt_path.rstrip("/"))
    which = os.path.basename(ckpt_path.rstrip("/"))
    tree, meta = Checkpointer(ckpt_dir).load(
        which if which in ("latest", "best") else ckpt_path)
    if meta is None:
        raise FileNotFoundError(f"no checkpoint at {ckpt_path}")
    train_config = Config.from_dict(meta["config"])
    if config is not None:
        train_config.settings = config.settings
        train_config.rollout = config.rollout
        train_config.dataset.dpath = (config.dataset.dpath
                                      or train_config.dataset.dpath)
        for field in ("project", "group", "name", "notes"):
            val = getattr(config.logging, field)
            if val:
                setattr(train_config.logging, field, val)
    model = build_model(train_config, device)
    model.set_stats(meta["stats"])
    skipped = load_params_flexible(model.module, tree["module"])
    if skipped:
        raise ValueError(f"checkpoint {ckpt_path} does not match the "
                         f"model: {', '.join(skipped)}")
    return model, train_config, meta


def rollout_dataset(model, dataset, out_dir: str,
                    timestep_range: Optional[List[int]] = None,
                    compute_error: bool = True, save_full: bool = False,
                    save_frequency: int = 1, meta: Optional[Dict] = None
                    ) -> Dict:
    """Roll ``model`` out over every trajectory of ``dataset``, batched,
    from the first step of ``timestep_range`` (the dataset's range when
    None) for ``(t1 - t0 - 1) // stride`` steps against the ground truth
    that follows it (a model bundling k steps per forward predicts the
    largest multiple of k of them, ``rollout_scan``); write
    ``errors.json`` (with ``compute_error``) and ``data0.h5`` +
    ``meta.json`` (with ``save_full``; ``meta`` goes into
    ``meta.json``) into ``out_dir``. Returns the errors, their
    ``error_summary`` scalars, the saved fields, the step count and the
    rollout's seconds."""
    from gnn_fluid_dynamics_tpu_torch.data.pipeline import rollout_batch
    from gnn_fluid_dynamics_tpu_torch.graph import to_static_bands
    from gnn_fluid_dynamics_tpu_torch.rollout.engine import (RolloutConfig,
                                                             error_summary,
                                                             rollout_scan)
    from gnn_fluid_dynamics_tpu_torch.rollout.writer import SimulationWriter
    sim_ids = dataset.sim_ids()
    t0_range = list(timestep_range or dataset.timestep_range)
    graph = to_static_bands(dataset.get_batch(rollout_batch(dataset,
                                                            t0_range[0])))
    _, feats = model.transform_rollout(graph)
    num_steps = max(1, (t0_range[1] - t0_range[0] - 1) // dataset.stride)
    gt_fields, gt_v, gt_p = {}, None, None
    if compute_error or save_full:
        # a full save also records the face fields' ground truth
        # (reference simulation_data.py:96-211)
        keys = (("cell_velocity", "cell_pressure", "face_velocity",
                 "face_pressure", "face_flux") if save_full
                else ("cell_velocity", "cell_pressure"))
        gt_fields = dataset.trajectory_fields(sim_ids, t0_range[0],
                                              num_steps, keys=keys)
        gt_v, gt_p = (torch.from_numpy(gt_fields[k]).to(model.device)
                      for k in ("cell_velocity", "cell_pressure"))

    print(f"\nRollout started... ({num_steps} steps x {len(sim_ids)} sims)")
    start = time.time()
    errors, fields = rollout_scan(model, graph, feats, gt_v, gt_p,
                                  RolloutConfig(num_steps=num_steps,
                                                compute_error=compute_error,
                                                save_fields=save_full))
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    elapsed = time.time() - start
    print(f"Rollout complete in t = {elapsed:.3f} s "
          f"({num_steps / elapsed:.1f} steps/s)")

    os.makedirs(out_dir, exist_ok=True)
    scalars = None
    if compute_error:
        scalars, evo = error_summary(errors, sim_ids)
        with open(os.path.join(out_dir, "errors.json"), "w") as f:
            json.dump({"scalar": scalars, "evolution": evo}, f, indent=2)
        for key in ("velocity_error", "pressure_error", "divergence_error"):
            if key in scalars:
                print(f"{key} mean_all: {scalars[key]['mean_all']:.4e}")
    if save_full:
        writer = SimulationWriter(os.path.join(out_dir, "data0.h5"), dataset,
                                  sim_ids)
        # the steps predicted: num_steps // k * k for a bundle of k
        timesteps = [t0_range[0] + (i + 1) * dataset.stride
                     for i in range(len(fields["cell_velocity"]))]
        writer.write_fields(
            {k: v for k, v in fields.items() if k != "final_cell_state"},
            timesteps, ground_truth=gt_fields, save_frequency=save_frequency)
        writer.close(meta={**(meta or {}), "timerange": t0_range,
                           "meshes": {"data0": sim_ids},
                           "run_time": elapsed},
                     meta_path=os.path.join(out_dir, "meta.json"))
        print(f"Saved rollout to {out_dir}/data0.h5")
    return {"errors": errors, "scalars": scalars, "fields": fields,
            "num_steps": num_steps, "seconds": elapsed}


def main(argv: Optional[List[str]] = None) -> Dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--save", type=str, default="full",
                        choices=["full", "off"])
    parser.add_argument("--error", type=str, default="on",
                        choices=["on", "off"])
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from gnn_fluid_dynamics_tpu_torch.training.config import load_config
    from gnn_fluid_dynamics_tpu_torch.training.train import build_datasets

    config = load_config(args.config)
    ckpt_path = config.model.fpath
    if not ckpt_path:
        raise ValueError("a rollout needs model.fpath, the checkpoint to run")
    model, config, _ = restore_model(ckpt_path, device, config)
    _, valid_ds = build_datasets(config, type(model), splits=("valid",),
                                 device=device)
    out_dir = os.path.join("rollouts", config.logging.project or "default",
                           args.output or config.logging.name or "rollout")
    return rollout_dataset(
        model, valid_ds, out_dir,
        timestep_range=config.rollout.data_timestep_range,
        compute_error=args.error == "on", save_full=args.save == "full",
        save_frequency=config.rollout.save_frequency,
        meta={"model": ckpt_path, "dataset": config.dataset.dpath,
              "subset": config.rollout.data_subset})


if __name__ == "__main__":
    try:
        main()
    except KeyboardInterrupt:
        print("\nRollout stopped by keyboard interrupt.")
        sys.exit(1)
    except Exception as e:
        print(f"\nRollout failed: {e}")
        traceback.print_exc()
        sys.exit(1)
