"""Finite-volume geometry of a triangular mesh, in numpy: the plain
reference's own derivation of what the program's set-up derives (faces,
their owner and neighbour cells, orientation, normals, areas, volumes and
boundary classes).

Frozen copy of the numpy path of the port's connectivity code
(``gnn_fluid_dynamics_tpu_torch/ops/connectivity.py``, itself the reference
``src/utils/geometry.py``'s numbering): faces are the unique vertex edges
packed (max vertex, min vertex) and sorted; a face's owner is the first cell
that holds it, then the pair is oriented so that the owner's centroid has
the larger x. No reordering and no padding: the reference works on each
mesh as generated.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from perfbench.harness.meshgen import INFLOW, NORMAL, OUTFLOW, SLIP, WALL


def _connectivity(cells: np.ndarray, vertex_pos: np.ndarray):
    num_cells = cells.shape[0]
    edges = np.concatenate([cells[:, 0:2], cells[:, 1:3], cells[:, [2, 0]]], 0)
    packed = np.stack([edges.max(1), edges.min(1)], 1)
    unique_edges, inverse = np.unique(packed, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    num_faces = unique_edges.shape[0]
    face_index = inverse.reshape(3, num_cells)
    flat_face = face_index.T.reshape(-1)
    flat_cell = np.repeat(np.arange(num_cells), 3)
    order = np.argsort(flat_face, kind="stable")
    sorted_face, sorted_cell = flat_face[order], flat_cell[order]
    first = np.searchsorted(sorted_face, np.arange(num_faces), side="left")
    last = np.searchsorted(sorted_face, np.arange(num_faces), side="right") - 1
    if (last - first + 1).max() > 2:
        raise ValueError("non-manifold mesh: a face shared by more than 2 cells")
    owner, neighbour = sorted_cell[first], sorted_cell[last]
    centroids = vertex_pos[cells].mean(axis=1)
    vec = centroids[owner] - centroids[neighbour]
    keep = (vec[:, 0] > 0) | ((vec[:, 0] == 0) & (vec[:, 1] > 0))
    cell_edge_index = np.where(keep[None], np.stack([owner, neighbour]),
                               np.stack([neighbour, owner]))
    return face_index, cell_edge_index, unique_edges.T.copy()


def _face_types(vertex_edge_index, vertex_types):
    v1 = vertex_types[vertex_edge_index[0]]
    v2 = vertex_types[vertex_edge_index[1]]
    out = np.full_like(v1, NORMAL)
    same = v1 == v2
    for t in (WALL, INFLOW, OUTFLOW, SLIP):
        out[same & (v1 == t)] = t
    for t in (INFLOW, OUTFLOW):
        mixed = (((v1 == WALL) | (v1 == SLIP)) & (v2 == t)) | (
            (v1 == t) & ((v2 == WALL) | (v2 == SLIP)))
        out[mixed] = t
    return out


def build_geometry(vertex_pos: np.ndarray, cells: np.ndarray,
                   vertex_types: np.ndarray) -> Dict[str, np.ndarray]:
    """The mesh's finite-volume geometry: per face ``owner``/``neighbour``
    (a boundary face is a self-loop), ``sender``/``receiver`` vertices,
    ``face_normal`` (unit, owner to neighbour), ``face_area``,
    ``face_pos``, ``face_type``; per cell ``cell_faces`` (C, 3) in the
    cell's local edge order, ``cell_sign`` (+1 where the cell owns the
    face, -1 where it is the neighbour), ``cell_normal`` (C, 3, 2,
    outward), ``cell_pos``, ``cell_volume``, ``cell_vertices`` (C, 3)."""
    vertex_pos = np.asarray(vertex_pos, np.float64)
    cells = np.asarray(cells, np.int64)
    face_index, cei, vei = _connectivity(cells, vertex_pos)
    vec = vertex_pos[vei[1]] - vertex_pos[vei[0]]
    face_area = np.linalg.norm(vec, axis=1)
    face_pos = vertex_pos[vei.T].mean(axis=1)
    cell_pos = vertex_pos[cells].mean(axis=1)
    v0, v1, v2 = (vertex_pos[cells[:, k]] for k in range(3))
    volume = 0.5 * np.abs((v1[:, 0] - v0[:, 0]) * (v2[:, 1] - v0[:, 1])
                          - (v2[:, 0] - v0[:, 0]) * (v1[:, 1] - v0[:, 1]))
    normal = np.stack([-vec[:, 1], vec[:, 0]], 1)
    normal = normal / (np.linalg.norm(normal, axis=1, keepdims=True) + 1e-8)
    flip = np.sum((face_pos - cell_pos[cei[0]]) * normal, axis=1) < 0
    normal[flip] *= -1
    gface = face_index.T
    to_centre = cell_pos[:, None, :] - face_pos[gface]
    cell_normal = np.where((np.sum(normal[gface] * to_centre, -1) > 0)[..., None],
                           -normal[gface], normal[gface])
    cid = np.arange(cells.shape[0])[:, None]
    own, nbr = cei[0][gface], cei[1][gface]
    sign = np.where(cid == own, 1.0, np.where((own != nbr) & (cid == nbr),
                                              -1.0, 0.0))
    if np.any(sign == 0):
        raise ValueError("inconsistent cell-face connectivity")
    f32 = np.float32
    return {
        "owner": cei[0], "neighbour": cei[1],
        "sender": vei[0], "receiver": vei[1],
        "face_normal": normal.astype(f32), "face_area": face_area.astype(f32),
        "face_pos": face_pos.astype(f32),
        "face_type": _face_types(vei, np.asarray(vertex_types).reshape(-1)),
        "cell_faces": gface, "cell_sign": sign.astype(f32),
        "cell_normal": cell_normal.astype(f32), "cell_pos": cell_pos.astype(f32),
        "cell_volume": volume.astype(f32), "cell_vertices": cells,
        "num_vertices": vertex_pos.shape[0],
    }
