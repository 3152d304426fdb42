"""Uniform mesh refinement tool (counterpart of ``generate/mesh_refine.py``;
reference ``generate/mesh_refine.py``).

Each triangle splits into 4 by edge midpoints (1->4 uniform refinement); field
data can be prolongated onto the refined mesh for refinement studies
(BASELINE configs[3]: "Conservative + VertPot ... on refined meshes").

Usage::

    python -m gnn_fluid_dynamics_tpu_torch.generate.mesh_refine \
        --mesh data/meshes/mesh_0 --out data/meshes_refined/mesh_0 [--levels 1]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Tuple

import numpy as np


def refine_uniform(vertex_pos: np.ndarray, cells: np.ndarray,
                   vertex_types: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """1->4 uniform refinement. Midpoint vertices inherit a boundary type only
    when both parents share it (midpoints of boundary edges stay on the
    boundary for straight segments)."""
    edges = np.concatenate([cells[:, [0, 1]], cells[:, [1, 2]],
                            cells[:, [2, 0]]], axis=0)
    key = np.sort(edges, axis=1)
    uniq, inverse = np.unique(key, axis=0, return_inverse=True)
    V = vertex_pos.shape[0]
    mid_pos = vertex_pos[uniq].mean(axis=1)
    mid_ids = V + np.arange(uniq.shape[0])

    # midpoint types follow the face-classification rules
    # (ops/connectivity.classify_edges): equal types propagate; WALL/SLIP
    # mixed with INFLOW/OUTFLOW take the flow type; anything else is NORMAL
    t0, t1 = vertex_types[uniq[:, 0]], vertex_types[uniq[:, 1]]
    from gnn_fluid_dynamics_tpu_torch.data.node_types import NodeType
    wall_like = lambda t: (t == NodeType.WALL_BOUNDARY) | (t == NodeType.SLIP)
    mid_types = np.where(t0 == t1, t0, NodeType.NORMAL)
    for flow in (NodeType.INFLOW, NodeType.OUTFLOW):
        mixed = ((wall_like(t0) & (t1 == flow)) | (wall_like(t1) & (t0 == flow)))
        mid_types = np.where(mixed, flow, mid_types)

    C = cells.shape[0]
    m01 = mid_ids[inverse[:C]]
    m12 = mid_ids[inverse[C:2 * C]]
    m20 = mid_ids[inverse[2 * C:]]
    v0, v1, v2 = cells[:, 0], cells[:, 1], cells[:, 2]
    new_cells = np.concatenate([
        np.stack([v0, m01, m20], axis=1),
        np.stack([m01, v1, m12], axis=1),
        np.stack([m20, m12, v2], axis=1),
        np.stack([m01, m12, m20], axis=1),
    ])
    new_pos = np.concatenate([vertex_pos, mid_pos])
    new_types = np.concatenate([vertex_types, mid_types])
    return new_pos, new_cells, new_types


def prolongate_vertex_field(field: np.ndarray, vertex_pos: np.ndarray,
                            cells: np.ndarray) -> np.ndarray:
    """Linear prolongation of a vertex field onto the refined vertex set
    (original vertices keep their values; midpoints average their edge)."""
    edges = np.concatenate([cells[:, [0, 1]], cells[:, [1, 2]],
                            cells[:, [2, 0]]], axis=0)
    uniq = np.unique(np.sort(edges, axis=1), axis=0)
    mids = 0.5 * (field[uniq[:, 0]] + field[uniq[:, 1]])
    return np.concatenate([field, mids])


def quality_report(vertex_pos: np.ndarray, cells: np.ndarray) -> dict:
    """Min/median area + aspect statistics (the tool's comparison output)."""
    v0, v1, v2 = (vertex_pos[cells[:, i]] for i in range(3))
    area = 0.5 * np.abs((v1[:, 0] - v0[:, 0]) * (v2[:, 1] - v0[:, 1])
                        - (v2[:, 0] - v0[:, 0]) * (v1[:, 1] - v0[:, 1]))
    e = [np.linalg.norm(b - a, axis=1) for a, b in ((v0, v1), (v1, v2), (v2, v0))]
    longest = np.maximum.reduce(e)
    aspect = longest ** 2 / np.maximum(area, 1e-30)
    return {"num_vertices": int(vertex_pos.shape[0]),
            "num_cells": int(cells.shape[0]),
            "area_min": float(area.min()), "area_median": float(np.median(area)),
            "aspect_max": float(aspect.max()),
            "aspect_median": float(np.median(aspect))}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--mesh", type=str, required=True)
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--levels", type=int, default=1)
    args = parser.parse_args(argv)

    mesh = np.load(os.path.join(args.mesh, "mesh.npz"))
    pos, cells, vt = (mesh["vertex_pos"], mesh["cells"], mesh["vertex_types"])
    print("before:", quality_report(pos, cells))
    for _ in range(args.levels):
        pos, cells, vt = refine_uniform(pos, cells, vt)
    print("after: ", quality_report(pos, cells))

    os.makedirs(args.out, exist_ok=True)
    np.savez(os.path.join(args.out, "mesh.npz"), vertex_pos=pos, cells=cells,
             vertex_types=vt)
    meta_path = os.path.join(args.mesh, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        meta["refined_levels"] = args.levels
        with open(os.path.join(args.out, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2)


if __name__ == "__main__":
    main()
