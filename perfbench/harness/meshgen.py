"""The benchmark's inputs: unstructured channel meshes with an elliptical
obstacle, and an analytic unsteady channel flow sampled on them.

A frozen copy of the port's synthetic generators
(``gnn_fluid_dynamics_tpu_torch/data/synthetic.py``: ``cylinder_channel_mesh``
and ``channel_flow_trajectory``), kept here so that a change to the program
cannot change what the benchmark feeds it. The mesh is handed over raw
(vertex positions, triangles, vertex boundary types); the program and the
plain reference each derive their own connectivity from it. The flow is a
function of position and time, which each side samples at its own cell and
face centres.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

# the OpenFOAM boundary classes (NodeType of the port and of the reference)
NORMAL, WALL, INFLOW, OUTFLOW, SLIP = 0, 1, 2, 3, 4
NUM_FACE_TYPES = 5


def cylinder_channel_mesh(n_points: int, seed: int, lx: float = 2.0,
                          ly: float = 1.0, cx: float = 0.5, cy: float = 0.5,
                          rx: float = 0.12, ry: float = 0.12,
                          n_ring: int = 48
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(vertex_pos (V, 2) f64, cells (C, 3) int64, vertex_types (V,) int64):
    a Delaunay mesh of the channel [0, lx] x [0, ly] around an elliptical
    obstacle, from ``n_points`` quasi-random interior points thinned and
    smoothed; INFLOW at x = 0, OUTFLOW at x = lx, WALL on the channel walls
    and the obstacle."""
    from scipy.spatial import Delaunay, cKDTree

    rng = np.random.default_rng(seed)
    nb_x = max(8, int(np.sqrt(n_points) * lx / ly / 2) * 2)
    nb_y = max(6, int(np.sqrt(n_points) / 2) * 2)
    xs = np.linspace(0, lx, nb_x + 1)
    ys = np.linspace(0, ly, nb_y + 1)
    edge_pts = np.concatenate([
        np.stack([xs, np.zeros_like(xs)], 1),
        np.stack([xs, np.full_like(xs, ly)], 1),
        np.stack([np.zeros(nb_y - 1), ys[1:-1]], 1),
        np.stack([np.full(nb_y - 1, lx), ys[1:-1]], 1),
    ])
    theta = np.linspace(0, 2 * np.pi, n_ring, endpoint=False)
    ring = np.stack([cx + rx * np.cos(theta), cy + ry * np.sin(theta)], 1)

    interior = rng.uniform([0, 0], [lx, ly], size=(n_points, 2))
    margin = 1.4
    inside_obstacle = (((interior[:, 0] - cx) / (rx * margin)) ** 2
                       + ((interior[:, 1] - cy) / (ry * margin)) ** 2) < 1.0
    h = np.sqrt(lx * ly / n_points)
    near_edge = ((interior[:, 0] < 0.5 * h) | (interior[:, 0] > lx - 0.5 * h)
                 | (interior[:, 1] < 0.5 * h) | (interior[:, 1] > ly - 0.5 * h))
    interior = interior[~inside_obstacle & ~near_edge]

    # thin points that crowd the boundary, the ring or each other: slivers
    # wreck the finite-volume geometry
    fixed = np.concatenate([edge_pts, ring])
    d_fixed, _ = cKDTree(fixed).query(interior)
    interior = interior[d_fixed > 0.45 * h]
    keep = np.ones(len(interior), bool)
    for i, j in sorted(cKDTree(interior).query_pairs(0.5 * h)):
        if keep[i] and keep[j]:
            keep[j] = False
    interior = interior[keep]
    pos = np.concatenate([fixed, interior])
    pos = np.unique(np.round(pos / 1e-9) * 1e-9, axis=0)

    # a few rounds of Laplacian smoothing of the free points
    dfix, _ = cKDTree(fixed).query(pos)
    free = dfix > 1e-9
    free &= ~((((pos[:, 0] - cx) / rx) ** 2
               + ((pos[:, 1] - cy) / ry) ** 2) < 1.0)
    for _ in range(6):
        tri = Delaunay(pos)
        neigh_sum = np.zeros_like(pos)
        neigh_cnt = np.zeros(pos.shape[0])
        for a, b in ((0, 1), (1, 2), (2, 0)):
            np.add.at(neigh_sum, tri.simplices[:, a], pos[tri.simplices[:, b]])
            np.add.at(neigh_cnt, tri.simplices[:, a], 1)
            np.add.at(neigh_sum, tri.simplices[:, b], pos[tri.simplices[:, a]])
            np.add.at(neigh_cnt, tri.simplices[:, b], 1)
        target = neigh_sum / np.maximum(neigh_cnt, 1)[:, None]
        pos = np.where(free[:, None], 0.7 * pos + 0.3 * target, pos)
        r2 = (((pos[:, 0] - cx) / (rx * 1.05)) ** 2
              + ((pos[:, 1] - cy) / (ry * 1.05)) ** 2)
        bad = free & (r2 < 1.0)
        if bad.any():
            scale = np.sqrt(1.0 / np.maximum(r2[bad], 1e-12)) * 1.05
            pos[bad, 0] = cx + (pos[bad, 0] - cx) * scale
            pos[bad, 1] = cy + (pos[bad, 1] - cy) * scale

    cells = Delaunay(pos).simplices
    centroids = pos[cells].mean(axis=1)
    cells = cells[(((centroids[:, 0] - cx) / rx) ** 2
                   + ((centroids[:, 1] - cy) / ry) ** 2) > 1.0]
    used = np.unique(cells)
    remap = -np.ones(pos.shape[0], np.int64)
    remap[used] = np.arange(used.shape[0])
    pos = pos[used]
    cells = remap[cells]

    vt = np.full(pos.shape[0], NORMAL, np.int64)
    eps = 1e-9
    on_obstacle = np.abs(((pos[:, 0] - cx) / rx) ** 2
                         + ((pos[:, 1] - cy) / ry) ** 2 - 1.0) < 5e-2
    vt[on_obstacle] = WALL
    vt[np.abs(pos[:, 1]) < eps] = WALL
    vt[np.abs(pos[:, 1] - ly) < eps] = WALL
    vt[np.abs(pos[:, 0] - lx) < eps] = OUTFLOW
    vt[np.abs(pos[:, 0]) < eps] = INFLOW
    corner = (np.abs(pos[:, 1]) < eps) | (np.abs(pos[:, 1] - ly) < eps)
    vt[corner & ((np.abs(pos[:, 0]) < eps) | (np.abs(pos[:, 0] - lx) < eps))] = WALL
    return pos, cells.astype(np.int64), vt


def channel_velocity(x, y, t: float, u_in: float = 1.0, ly: float = 1.0,
                     shed_freq: float = 2.0):
    """(u, v) of the channel flow at positions (x, y) and time ``t``: a
    parabolic inflow profile plus a travelling wake perturbation. ``x``,
    ``y`` are numpy arrays or torch tensors of one dtype."""
    lib = np if isinstance(x, np.ndarray) else torch
    wake = lib.exp(-0.5 * ((y - ly / 2) / (0.2 * ly)) ** 2)
    phase = 2 * math.pi * shed_freq * t - 4 * x
    u = 4 * u_in * y * (ly - y) / ly ** 2 + 0.15 * u_in * lib.sin(phase) * wake
    v = 0.15 * u_in * lib.cos(phase) * wake
    return u, v


def channel_pressure(x, t: float, u_in: float = 1.0, shed_freq: float = 2.0):
    """Pressure of the channel flow at abscissae ``x`` and time ``t``."""
    return (0.5 * (1.0 - x) * u_in ** 2
            * (1 + 0.1 * math.sin(2 * math.pi * shed_freq * t)))


def flow_fields(cell_pos: np.ndarray, face_pos: np.ndarray,
                face_normal: np.ndarray, face_area: np.ndarray,
                times, flow: dict) -> dict:
    """The time-major f32 fields (T, N, D) at ``times`` of the flow
    ``flow`` (``channel_velocity``'s keyword arguments): cell and face
    velocity and pressure, and the owner-oriented face flux u . n A."""
    out = {k: [] for k in ("cell_velocity", "cell_pressure", "face_velocity",
                           "face_pressure", "face_flux")}
    p_kw = {k: flow[k] for k in ("u_in", "shed_freq") if k in flow}
    for t in times:
        cu, cv = channel_velocity(cell_pos[:, 0], cell_pos[:, 1], t, **flow)
        fu, fv = channel_velocity(face_pos[:, 0], face_pos[:, 1], t, **flow)
        out["cell_velocity"].append(np.stack([cu, cv], 1))
        out["cell_pressure"].append(channel_pressure(cell_pos[:, 0], t,
                                                     **p_kw)[:, None])
        out["face_velocity"].append(np.stack([fu, fv], 1))
        out["face_pressure"].append(channel_pressure(face_pos[:, 0], t,
                                                     **p_kw)[:, None])
        out["face_flux"].append(((fu * face_normal[:, 0] + fv * face_normal[:, 1])
                                 * face_area.reshape(-1))[:, None])
    return {k: np.stack(v).astype(np.float32) for k, v in out.items()}
