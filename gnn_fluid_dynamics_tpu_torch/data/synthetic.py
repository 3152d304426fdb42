"""Synthetic meshes and trajectories.

The reference generates data with gmsh + OpenFOAM (``generate/``), neither of
which ships data in-repo. This module provides self-contained numpy generators
for (a) structured/unstructured triangular meshes of a channel (optionally with
an elliptical obstacle, mirroring ``generate/mesh.py``'s ellipse-in-channel
cases) and (b) analytic Taylor–Green vortex trajectories (the reference's
``generate/openfoam/taylor_green`` case has an exact solution), giving
ground-truth incompressible fields for unit tests, end-to-end training tests,
and benchmarks without external tooling.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from gnn_fluid_dynamics_tpu_torch.data.node_types import NodeType
from gnn_fluid_dynamics_tpu_torch.ops.connectivity import build_geometry


def structured_channel_mesh(nx: int = 20, ny: int = 10,
                            lx: float = 2.0, ly: float = 1.0,
                            jitter: float = 0.0,
                            seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Triangulated rectangle [0,lx]x[0,ly].

    Returns (vertex_pos (V,2), cells (C,3), vertex_types (V,)) with INFLOW on
    x=0, OUTFLOW on x=lx, WALL on y=0 and y=ly (matching the reference's
    channel boundary taxonomy, ``src/datasets/OpenFoam.py:103-131``).
    """
    xs = np.linspace(0.0, lx, nx + 1)
    ys = np.linspace(0.0, ly, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    pos = np.stack([X.reshape(-1), Y.reshape(-1)], axis=1)
    if jitter > 0:
        rng = np.random.default_rng(seed)
        interior = ((pos[:, 0] > 0) & (pos[:, 0] < lx)
                    & (pos[:, 1] > 0) & (pos[:, 1] < ly))
        h = min(lx / nx, ly / ny)
        pos[interior] += rng.uniform(-jitter * h, jitter * h,
                                     size=(interior.sum(), 2))

    def vid(i, j):
        return i * (ny + 1) + j

    cells = []
    for i in range(nx):
        for j in range(ny):
            a, b, c, d = vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)
            # alternate diagonal for isotropy
            if (i + j) % 2 == 0:
                cells.append([a, b, c]); cells.append([a, c, d])
            else:
                cells.append([a, b, d]); cells.append([b, c, d])
    cells = np.asarray(cells, dtype=np.int64)

    vt = np.full(pos.shape[0], NodeType.NORMAL, np.int64)
    eps = 1e-9
    vt[np.abs(pos[:, 1]) < eps] = NodeType.WALL_BOUNDARY
    vt[np.abs(pos[:, 1] - ly) < eps] = NodeType.WALL_BOUNDARY
    vt[np.abs(pos[:, 0] - lx) < eps] = NodeType.OUTFLOW
    vt[np.abs(pos[:, 0]) < eps] = NodeType.INFLOW
    # corners: inflow/outflow wins on the x extremes only if not on walls
    corner = ((np.abs(pos[:, 1]) < eps) | (np.abs(pos[:, 1] - ly) < eps))
    vt[corner & (np.abs(pos[:, 0]) < eps)] = NodeType.WALL_BOUNDARY
    vt[corner & (np.abs(pos[:, 0] - lx) < eps)] = NodeType.WALL_BOUNDARY
    return pos, cells, vt


def cylinder_channel_mesh(n_points: int = 1200,
                          lx: float = 2.0, ly: float = 1.0,
                          cx: float = 0.5, cy: float = 0.5,
                          rx: float = 0.12, ry: float = 0.12,
                          n_ring: int = 48,
                          seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Unstructured channel mesh with an elliptical obstacle (Delaunay).

    The stand-in for the reference's gmsh ellipse-in-channel meshes
    (``generate/mesh.py:101-171``): quasi-random interior points (denser is up
    to the caller via ``n_points``), an explicit ring on the obstacle surface,
    and boundary points on the channel walls; triangles inside the obstacle are
    dropped.
    """
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    # boundary points along the channel edges
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

    # Halton-like quasi-random interior fill
    interior = rng.uniform([0, 0], [lx, ly], size=(n_points, 2))
    margin = 1.4
    inside_obstacle = (((interior[:, 0] - cx) / (rx * margin)) ** 2
                       + ((interior[:, 1] - cy) / (ry * margin)) ** 2) < 1.0
    h = np.sqrt(lx * ly / n_points)
    near_edge = ((interior[:, 0] < 0.5 * h) | (interior[:, 0] > lx - 0.5 * h)
                 | (interior[:, 1] < 0.5 * h) | (interior[:, 1] > ly - 0.5 * h))
    interior = interior[~inside_obstacle & ~near_edge]

    # thin interior points that crowd the boundary/ring/each other —
    # near-coincident points create sliver triangles that wreck solver
    # stability and FVM accuracy
    from scipy.spatial import cKDTree
    fixed = np.concatenate([edge_pts, ring])
    tree = cKDTree(fixed)
    d_fixed, _ = tree.query(interior)
    interior = interior[d_fixed > 0.45 * h]
    keep = np.ones(len(interior), bool)
    itree = cKDTree(interior)
    for i, j in sorted(itree.query_pairs(0.5 * h)):
        if keep[i] and keep[j]:
            keep[j] = False
    interior = interior[keep]
    pos = np.concatenate([fixed, interior])
    pos = np.unique(np.round(pos / 1e-9) * 1e-9, axis=0)

    # Laplacian/Lloyd smoothing of interior points: a few rounds of moving
    # each free vertex to the mean of its Delaunay neighbours removes sliver
    # triangles (critical for FVM solver stability on these meshes)
    n_fixed = 0  # recompute which points are fixed after dedupe
    ftree = cKDTree(fixed)
    dfix, _ = ftree.query(pos)
    free = dfix > 1e-9
    inside_hole = (((pos[:, 0] - cx) / rx) ** 2
                   + ((pos[:, 1] - cy) / ry) ** 2) < 1.0
    free &= ~inside_hole
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
        # keep smoothed points out of the obstacle
        r2 = ((pos[:, 0] - cx) / (rx * 1.05)) ** 2 \
            + ((pos[:, 1] - cy) / (ry * 1.05)) ** 2
        bad = free & (r2 < 1.0)
        if bad.any():
            scale = np.sqrt(1.0 / np.maximum(r2[bad], 1e-12)) * 1.05
            pos[bad, 0] = cx + (pos[bad, 0] - cx) * scale
            pos[bad, 1] = cy + (pos[bad, 1] - cy) * scale

    tri = Delaunay(pos)
    cells = tri.simplices
    centroids = pos[cells].mean(axis=1)
    keep = (((centroids[:, 0] - cx) / rx) ** 2
            + ((centroids[:, 1] - cy) / ry) ** 2) > 1.0
    cells = cells[keep]
    # drop unreferenced vertices
    used = np.unique(cells)
    remap = -np.ones(pos.shape[0], np.int64)
    remap[used] = np.arange(used.shape[0])
    pos = pos[used]
    cells = remap[cells]

    vt = np.full(pos.shape[0], NodeType.NORMAL, np.int64)
    eps = 1e-9
    on_obstacle = np.abs(((pos[:, 0] - cx) / rx) ** 2
                         + ((pos[:, 1] - cy) / ry) ** 2 - 1.0) < 5e-2
    vt[on_obstacle] = NodeType.WALL_BOUNDARY
    vt[np.abs(pos[:, 1]) < eps] = NodeType.WALL_BOUNDARY
    vt[np.abs(pos[:, 1] - ly) < eps] = NodeType.WALL_BOUNDARY
    vt[np.abs(pos[:, 0] - lx) < eps] = NodeType.OUTFLOW
    vt[np.abs(pos[:, 0]) < eps] = NodeType.INFLOW
    corner = ((np.abs(pos[:, 1]) < eps) | (np.abs(pos[:, 1] - ly) < eps))
    vt[corner & ((np.abs(pos[:, 0]) < eps) | (np.abs(pos[:, 0] - lx) < eps))] = \
        NodeType.WALL_BOUNDARY
    return pos, cells.astype(np.int64), vt


# -----------------------------------------------------------------------------
# Analytic Taylor–Green trajectory (exact incompressible solution)
# -----------------------------------------------------------------------------

def taylor_green_velocity(xy: np.ndarray, t: float, nu: float = 1e-3,
                          k: float = np.pi) -> np.ndarray:
    decay = np.exp(-2.0 * k * k * nu * t)
    u = -np.cos(k * xy[:, 0]) * np.sin(k * xy[:, 1]) * decay
    v = np.sin(k * xy[:, 0]) * np.cos(k * xy[:, 1]) * decay
    return np.stack([u, v], axis=1)


def taylor_green_pressure(xy: np.ndarray, t: float, nu: float = 1e-3,
                          k: float = np.pi, rho: float = 1.0) -> np.ndarray:
    decay = np.exp(-4.0 * k * k * nu * t)
    p = -rho / 4.0 * (np.cos(2 * k * xy[:, 0]) + np.cos(2 * k * xy[:, 1])) * decay
    return p[:, None]


def taylor_green_trajectory(geom: Dict[str, np.ndarray], num_timesteps: int,
                            dt: float = 0.01, nu: float = 1e-3,
                            k: float = np.pi) -> Dict[str, np.ndarray]:
    """Exact fields sampled at cell centers and face centers over time.

    Returns time-major arrays matching the reference HDF5 layout
    (``src/datasets/DataSet.py:220-260``): cell_velocity (T, C, 2),
    cell_pressure (T, C, 1), face_velocity (T, F, 2), face_pressure (T, F, 1),
    face_flux (T, F, 1) — the flux is the exact u_f . n_f A_f, owner-oriented.
    """
    cpos, fpos = geom["cell_pos"], geom["face_pos"]
    fnorm, farea = geom["face_normal"], geom["face_area"].reshape(-1)
    ts = np.arange(num_timesteps) * dt
    cv = np.stack([taylor_green_velocity(cpos, t, nu, k) for t in ts])
    cp = np.stack([taylor_green_pressure(cpos, t, nu, k) for t in ts])
    fv = np.stack([taylor_green_velocity(fpos, t, nu, k) for t in ts])
    fp = np.stack([taylor_green_pressure(fpos, t, nu, k) for t in ts])
    flux = np.einsum("tfd,fd->tf", fv, fnorm) * farea[None, :]
    return {
        "cell_velocity": cv.astype(np.float32),
        "cell_pressure": cp.astype(np.float32),
        "face_velocity": fv.astype(np.float32),
        "face_pressure": fp.astype(np.float32),
        "face_flux": flux[..., None].astype(np.float32),
    }


def channel_flow_trajectory(geom: Dict[str, np.ndarray], num_timesteps: int,
                            dt: float = 0.01, u_in: float = 1.0,
                            ly: float = 1.0,
                            shed_freq: float = 2.0) -> Dict[str, np.ndarray]:
    """A plausible (not exact) unsteady channel/cylinder-wake field: parabolic
    inflow plus a decaying oscillatory wake perturbation. Used for pipeline and
    benchmark shapes where physical exactness is irrelevant."""
    def field(xy, t):
        base_u = 4 * u_in * xy[:, 1] * (ly - xy[:, 1]) / ly ** 2
        pert = 0.15 * u_in * np.sin(2 * np.pi * shed_freq * t - 4 * xy[:, 0]) \
            * np.exp(-0.5 * ((xy[:, 1] - ly / 2) / (0.2 * ly)) ** 2)
        u = base_u + pert
        v = 0.15 * u_in * np.cos(2 * np.pi * shed_freq * t - 4 * xy[:, 0]) \
            * np.exp(-0.5 * ((xy[:, 1] - ly / 2) / (0.2 * ly)) ** 2)
        return np.stack([u, v], axis=1)

    def pressure(xy, t):
        return (0.5 * (1.0 - xy[:, 0]) * u_in ** 2
                * (1 + 0.1 * np.sin(2 * np.pi * shed_freq * t)))[:, None]

    cpos, fpos = geom["cell_pos"], geom["face_pos"]
    fnorm, farea = geom["face_normal"], geom["face_area"].reshape(-1)
    ts = np.arange(num_timesteps) * dt
    cv = np.stack([field(cpos, t) for t in ts])
    cp = np.stack([pressure(cpos, t) for t in ts])
    fv = np.stack([field(fpos, t) for t in ts])
    fp = np.stack([pressure(fpos, t) for t in ts])
    flux = np.einsum("tfd,fd->tf", fv, fnorm) * farea[None, :]
    return {
        "cell_velocity": cv.astype(np.float32),
        "cell_pressure": cp.astype(np.float32),
        "face_velocity": fv.astype(np.float32),
        "face_pressure": fp.astype(np.float32),
        "face_flux": flux[..., None].astype(np.float32),
    }


def make_geometry(kind: str = "structured", **kwargs) -> Dict[str, np.ndarray]:
    """Convenience: mesh -> canonical geometry dict."""
    if kind == "structured":
        pos, cells, vt = structured_channel_mesh(**kwargs)
    elif kind == "cylinder":
        pos, cells, vt = cylinder_channel_mesh(**kwargs)
    else:
        raise ValueError(kind)
    return build_geometry(pos, cells, vt, NodeType)
