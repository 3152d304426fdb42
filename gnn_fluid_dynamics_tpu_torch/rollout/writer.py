"""Rollout output writer (counterpart of ``rollout/writer.py``; reference
``SimulationData``, ``src/utils/simulation_data.py:59-119``): per mesh the
geometry, and per saved step the predictions and the ``_gt`` ground truth,
in the reference's layout

    <mesh_id>/geom/{vertex_pos, cell_pos, face_area, ...}
    <mesh_id>/cell/{velocity, pressure, flux, velocity_gt, pressure_gt}
    <mesh_id>/face/{velocity, pressure, flux, velocity_gt, pressure_gt, flux_gt}
    <mesh_id>/timesteps

written in one pass after the rollout from its stacked fields. ``h5py`` is
imported when a writer is made.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch


def _split_key(key: str):
    """'face_velocity' -> ('face', 'velocity')."""
    entity, _, name = key.partition("_")
    if entity not in ("cell", "face") or not name:
        raise ValueError(f"not a cell or face field: {key!r}")
    return entity, name


def _host(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


class SimulationWriter:
    """Write rollout results and their ground truth in the reference's
    layout, for the meshes ``sim_ids`` of ``dataset`` batched in that order
    (each padded to the batch's pad, ``dataset._pad_for(sim_ids)``: a set
    of meshes within one size bucket is padded to the bucket's)."""

    def __init__(self, path: str, dataset, sim_ids: Sequence[str]):
        import h5py
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.file = h5py.File(path, "w")
        self.dataset = dataset
        self.sim_ids = list(sim_ids)
        self.start_time = time.time()
        for mesh_id in self.sim_ids:
            gg = self.file.create_group(mesh_id).create_group("geom")
            for key, value in dataset.by_id[mesh_id].geom.items():
                gg.create_dataset(key, data=np.asarray(value))

    def write_fields(self, fields: Dict, timesteps: Sequence[int],
                     ground_truth: Optional[Dict] = None,
                     save_frequency: int = 1):
        """``fields``/``ground_truth`` hold stacked rollout outputs keyed
        ``{cell,face}_{velocity,pressure,flux}``, (T, sum of padded rows,
        D), tensors or arrays. Each mesh's rows are cut out of the batch,
        every ``save_frequency``-th step is kept, and the predictions and
        ``_gt`` datasets are written under ``cell/``/``face/``
        (simulation_data.py:96-211), in f32."""
        # the pad get_batch gave this batch of meshes
        pad = self.dataset._pad_for(self.sim_ids)
        keep = list(range(0, len(timesteps), save_frequency))
        items = [(key, _host(arr), "") for key, arr in fields.items()]
        if ground_truth is not None:
            items += [(key, _host(arr), "_gt")
                      for key, arr in ground_truth.items()]
        for b, mesh_id in enumerate(self.sim_ids):
            geom = self.dataset.by_id[mesh_id].geom
            counts = {"cell": geom["cell_pos"].shape[0],
                      "face": geom["face_pos"].shape[0]}
            g = self.file[mesh_id]
            g.create_dataset("timesteps",
                             data=np.asarray([timesteps[i] for i in keep]))
            for key, arr, suffix in items:
                entity, name = _split_key(key)
                n = pad[entity]
                sl = arr[keep, b * n: b * n + counts[entity]]
                g.require_group(entity).create_dataset(name + suffix,
                                                       data=sl.astype("f4"))

    def close(self, meta: Optional[Dict] = None,
              meta_path: Optional[str] = None):
        """Close the file; with ``meta_path``, write ``meta`` there as JSON
        with the writer's ``run_time``."""
        if meta_path:
            meta = dict(meta or {})
            meta["run_time"] = time.time() - self.start_time
            with open(meta_path, "w") as f:
                json.dump(meta, f, indent=2, default=str)
        self.file.close()
