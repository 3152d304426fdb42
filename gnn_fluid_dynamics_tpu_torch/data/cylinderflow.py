"""DeepMind MeshGraphNets cylinder-flow dataset conversion (counterpart of
``data/cylinderflow.py``;
(reference ``src/datasets/CylinderFlow.py`` + the vendored tfrecord tooling in
``src/datasets/download/``). h5py and tensorflow are imported inside the
converters that read them; neither is a dependency of the package.

The upstream dataset stores vertex-based fields (velocity at mesh nodes) per
trajectory. Conversion to the cell/face layout:

* cell values by distance-weighted vertex->centroid interpolation
  (CylinderFlow.py:99-112, with the reference's distance-*proportional*
  weighting quirk preserved via ``interpolate_centroid``);
* face values as vertex-midpoint averages;
* the 8-value DeepMind NodeType remapped onto the OpenFOAM 5-class taxonomy;
* dt = 0.01 (CylinderFlow.py:38).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from gnn_fluid_dynamics_tpu_torch.data.node_types import CylinderNodeType, NodeType
from gnn_fluid_dynamics_tpu_torch.data.pipeline import Trajectory
from gnn_fluid_dynamics_tpu_torch.ops.connectivity import build_geometry
from gnn_fluid_dynamics_tpu_torch.ops.geometry import interpolate_centroid

DT = 0.01

# DeepMind 8-type -> OpenFOAM 5-type remap
CYLINDER_TO_OF = {
    int(CylinderNodeType.NORMAL): int(NodeType.NORMAL),
    int(CylinderNodeType.OBSTACLE): int(NodeType.WALL_BOUNDARY),
    int(CylinderNodeType.AIRFOIL): int(NodeType.WALL_BOUNDARY),
    int(CylinderNodeType.HANDLE): int(NodeType.WALL_BOUNDARY),
    int(CylinderNodeType.INFLOW): int(NodeType.INFLOW),
    int(CylinderNodeType.OUTFLOW): int(NodeType.OUTFLOW),
    int(CylinderNodeType.WALL_BOUNDARY): int(NodeType.WALL_BOUNDARY),
    int(CylinderNodeType.SIZE): int(NodeType.NORMAL),
}


def remap_node_types(node_type: np.ndarray) -> np.ndarray:
    lut = np.zeros(max(CYLINDER_TO_OF) + 1, np.int64)
    for k, v in CYLINDER_TO_OF.items():
        lut[k] = v
    return lut[np.asarray(node_type).reshape(-1).astype(np.int64)]


def trajectory_from_vertex_fields(mesh_id: str, vertex_pos: np.ndarray,
                                  cells: np.ndarray, node_type: np.ndarray,
                                  velocity: np.ndarray,
                                  pressure: np.ndarray,
                                  dt: float = DT) -> Trajectory:
    """Vertex-based trajectory arrays -> cell/face Trajectory.

    velocity: (T, V, 2); pressure: (T, V, 1) or (T, V).
    """
    vt = remap_node_types(node_type)
    geom = build_geometry(vertex_pos, cells, vt, NodeType)
    if pressure.ndim == 2:
        pressure = pressure[..., None]
    T = velocity.shape[0]
    centroids = geom["cell_pos"].astype(np.float64)

    # vertex -> cell (distance-proportional reference weighting)
    cv = np.stack([interpolate_centroid(velocity[t], cells,
                                        vertex_pos, centroids)
                   for t in range(T)])
    cp = np.stack([interpolate_centroid(pressure[t], cells,
                                        vertex_pos, centroids)
                   for t in range(T)])
    # vertex -> face midpoint (CylinderFlow.py:108-112)
    vei = geom["vertex_edge_index"]
    fv = 0.5 * (velocity[:, vei[0]] + velocity[:, vei[1]])
    fp = 0.5 * (pressure[:, vei[0]] + pressure[:, vei[1]])
    fields = {
        "cell_velocity": cv.astype(np.float32),
        "cell_pressure": cp.astype(np.float32),
        "face_velocity": fv.astype(np.float32),
        "face_pressure": fp.astype(np.float32),
    }
    return Trajectory(mesh_id=mesh_id, geom=geom, fields=fields, dt=dt)


def convert_deepmind_h5(in_path: str, out_path: str,
                        sim_limit: Optional[int] = None):
    """DeepMind-format h5 (one group per trajectory with node-based datasets)
    -> canonical trajectory h5."""
    import h5py
    from gnn_fluid_dynamics_tpu_torch.data.hdf5 import save_dataset
    out = []
    with h5py.File(in_path, "r") as f:
        keys = sorted(f.keys())[: sim_limit or None]
        for i, key in enumerate(keys):
            g = f[key]
            pos = np.asarray(g["mesh_pos"])
            pos = pos[0] if pos.ndim == 3 else pos
            cells = np.asarray(g["cells"])
            cells = cells[0] if cells.ndim == 3 else cells
            ntype = np.asarray(g["node_type"])
            ntype = ntype[0] if ntype.ndim == 3 else ntype
            out.append(trajectory_from_vertex_fields(
                f"mesh_{i}", pos, cells, ntype,
                np.asarray(g["velocity"]), np.asarray(g["pressure"])))
    save_dataset(out_path, out)
    return out


def convert_tfrecord(tfrecord_path: str, meta_path: str, out_path: str,
                     sim_limit: Optional[int] = None):
    """DeepMind tfrecord -> canonical h5 (the analogue of the vendored
    ``parse_tfrecord`` tooling, reference ``src/datasets/download/``). h5py and tensorflow are imported inside the
converters that read them; neither is a dependency of the package.
    Requires tensorflow (CPU parse only)."""
    import tensorflow as tf
    from gnn_fluid_dynamics_tpu_torch.data.hdf5 import save_dataset

    with open(meta_path) as f:
        meta = json.load(f)

    def parse(proto):
        feature_lists = {k: tf.io.VarLenFeature(tf.string)
                         for k in meta["field_names"]}
        features = tf.io.parse_single_example(proto, feature_lists)
        out = {}
        for key, field in meta["features"].items():
            data = tf.io.decode_raw(features[key].values, getattr(tf, field["dtype"]))
            data = tf.reshape(data, field["shape"])
            if field["type"] == "static":
                data = tf.tile(data, [meta["trajectory_length"], 1, 1])
            out[key] = data
        return out

    ds = tf.data.TFRecordDataset(tfrecord_path)
    out = []
    for i, record in enumerate(ds):
        if sim_limit and i >= sim_limit:
            break
        sample = parse(record)
        pos = sample["mesh_pos"].numpy()[0]
        cells = sample["cells"].numpy()[0].astype(np.int64)
        ntype = sample["node_type"].numpy()[0]
        out.append(trajectory_from_vertex_fields(
            f"mesh_{i}", pos, cells, ntype,
            sample["velocity"].numpy(),
            sample["pressure"].numpy()))
    save_dataset(out_path, out)
    return out
