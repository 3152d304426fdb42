"""The validation rollout of training (counterpart of the rollout half of
``Trainer.validate``, ``gnn_fluid_dynamics_tpu/training/trainer.py``).

Every trajectory of the validation set starts at the range start; the batch
of all of them is one graph that stays on the table route
(``to_static_bands(..., derive_idx=False)``), so on the kernel route its GN
blocks run the dense-table kernels K6 and K7. The model rolls it forward
``num_steps`` steps against the ground truth, and the errors are summarized
as the trainer logs them. ``Trainer.validate``
(:mod:`gnn_fluid_dynamics_tpu_torch.training.trainer`) adds the logger, the
snapshots and the printed line.
"""

from __future__ import annotations

import weakref
from typing import Dict

import torch

from gnn_fluid_dynamics_tpu_torch.data.pipeline import MeshDataset, rollout_batch
from gnn_fluid_dynamics_tpu_torch.graph import to_static_bands
from gnn_fluid_dynamics_tpu_torch.rollout.engine import (RolloutConfig,
                                                         error_summary,
                                                         rollout_scan)


# per validation dataset, while it lives: num_steps -> (graph, gt_v, gt_p)
_VALID_INPUTS: "weakref.WeakKeyDictionary[MeshDataset, dict]" = (
    weakref.WeakKeyDictionary())


def _inputs(model, valid_dataset: MeshDataset, num_steps: int):
    """(graph, feats, gt_v, gt_p) of the validation rollout. The graph and
    the ground truth are assembled once per dataset and step count and kept
    on the dataset's device; the features are the model's own."""
    cache = _VALID_INPUTS.setdefault(valid_dataset, {})
    if num_steps not in cache:
        samples = rollout_batch(valid_dataset)
        graph = to_static_bands(valid_dataset.get_batch(samples),
                                derive_idx=False)
        gt_v, gt_p = valid_dataset.trajectory_targets(
            [m for m, _ in samples], samples[0][1], num_steps)
        cache[num_steps] = (graph, gt_v, gt_p)
    graph, gt_v, gt_p = cache[num_steps]
    _, feats = model.transform_rollout(graph)
    return graph, feats, gt_v, gt_p


def validation_rollout(model, valid_dataset: MeshDataset, num_steps: int,
                       save_fields: bool = False):
    """(errors, fields) of a ``num_steps``-step rollout of every validation
    trajectory: the per-step, per-trajectory errors (T, num_sims), and with
    ``save_fields`` every step's predicted fields."""
    graph, feats, gt_v, gt_p = _inputs(model, valid_dataset, num_steps)
    return rollout_scan(model, graph, feats, gt_v, gt_p,
                        RolloutConfig(num_steps=num_steps,
                                      save_fields=save_fields))


def validation_errors(model, valid_dataset: MeshDataset,
                      num_steps: int) -> Dict[str, torch.Tensor]:
    """The per-step, per-trajectory errors (T, num_sims) of a
    ``num_steps``-step rollout of every validation trajectory."""
    return validation_rollout(model, valid_dataset, num_steps)[0]


def validate(model, valid_dataset: MeshDataset,
             num_steps: int) -> Dict[str, float]:
    """The validation rollout's error summary, flat as the trainer returns
    it: ``total_mean_error`` and ``<error>/<stat>`` (``velocity_error/
    mean_all``, ...)."""
    scalars, _ = error_summary(
        validation_errors(model, valid_dataset, num_steps),
        valid_dataset.sim_ids())
    return flat_summary(scalars)


def flat_summary(scalars: Dict) -> Dict[str, float]:
    """``error_summary``'s scalars flat: ``total_mean_error`` and
    ``<error>/<stat>``."""
    flat = {"total_mean_error": scalars["total_mean_error"]}
    for name, st in scalars.items():
        if isinstance(st, dict):
            for k, v in st.items():
                flat[f"{name}/{k}"] = v
    return flat
