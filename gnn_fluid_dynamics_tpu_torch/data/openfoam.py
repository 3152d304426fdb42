"""OpenFOAM dataset preprocessing (counterpart of ``data/openfoam.py``;
reference ``src/datasets/OpenFoam.py``).

Converts OpenFOAM VTK output (one VTM/VTP series per simulated mesh) into the
canonical HDF5 trajectory layout:

* slice the 1-cell z-extrusion back to the 2-D mid-plane;
* classify vertices by boundary patch via KD-tree point matching
  (OpenFoam.py:103-131);
* interpolate cell fields to faces (inverse-distance), overwrite boundary
  faces with patch data + zero-gradient BCs (OpenFoam.py:240-244);
* map the OpenFOAM face flux ``phi`` from the ``surfaceFields_*.vtp`` files
  onto mesh faces with velocity-consistent sign correction
  (OpenFoam.py:275-308).

VTK reading uses the self-contained :mod:`gnn_fluid_dynamics_tpu_torch.data.vtk_io`
XML reader (``have_pyvista`` imports pyvista inside the function, and nothing
else needs it); everything downstream is plain numpy and scipy's cKDTree.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from gnn_fluid_dynamics_tpu_torch.data.node_types import NodeType
from gnn_fluid_dynamics_tpu_torch.data.pipeline import Trajectory
from gnn_fluid_dynamics_tpu_torch.ops.connectivity import build_geometry

# boundary patch name -> NodeType (reference OpenFoam.py patch taxonomy)
PATCH_TYPES = {
    "inlet": NodeType.INFLOW,
    "outlet": NodeType.OUTFLOW,
    "walls": NodeType.WALL_BOUNDARY,
    "wall": NodeType.WALL_BOUNDARY,
    "obstacle": NodeType.WALL_BOUNDARY,
    "cylinder": NodeType.WALL_BOUNDARY,
    "frontAndBack": None,              # empty (2-D extrusion planes)
    "defaultFaces": NodeType.WALL_BOUNDARY,
}


def have_pyvista() -> bool:
    try:
        import pyvista  # noqa: F401
        return True
    except ImportError:
        return False


def classify_vertices_by_patches(
        vertex_pos: np.ndarray,
        patch_points: Dict[str, np.ndarray],
        tol: float = 1e-8) -> np.ndarray:
    """Assign a NodeType to each 2-D vertex by KD-tree matching against each
    boundary patch's point cloud (reference OpenFoam.py:103-131). Later
    patches override earlier ones in PATCH_TYPES priority order; unmatched
    vertices stay NORMAL."""
    from scipy.spatial import cKDTree
    types = np.full(vertex_pos.shape[0], NodeType.NORMAL, np.int64)
    tree = cKDTree(vertex_pos)
    # apply in a fixed priority so WALL wins over INFLOW/OUTFLOW at corners
    order = sorted(patch_points.keys(),
                   key=lambda p: {NodeType.INFLOW: 1, NodeType.OUTFLOW: 1,
                                  NodeType.WALL_BOUNDARY: 2}.get(
                                      PATCH_TYPES.get(p), 0))
    for patch in order:
        node_type = PATCH_TYPES.get(patch)
        if node_type is None:
            continue
        pts = np.asarray(patch_points[patch])[:, :2]
        dist, idx = tree.query(pts)
        types[idx[dist < tol]] = node_type
    return types


def cell_fields_to_faces(cell_values: np.ndarray, geom: Dict[str, np.ndarray],
                         boundary_values: Optional[np.ndarray] = None
                         ) -> np.ndarray:
    """Inverse-distance cell->face interpolation with boundary override
    (reference OpenFoam.py:240-244 + geometry.py:427-457): interior faces
    average the two adjacent cells; boundary faces take patch data when given,
    else the owner cell value (zero-gradient BC)."""
    cei = geom["cell_edge_index"]
    c0, c1 = cei[0], cei[1]
    fpos, cpos = geom["face_pos"], geom["cell_pos"]
    d0 = np.linalg.norm(fpos - cpos[c0], axis=1)
    d1 = np.linalg.norm(fpos - cpos[c1], axis=1)
    w0 = 1.0 / (d0 + 1e-10)
    w1 = np.where(c0 == c1, 0.0, 1.0 / (d1 + 1e-10))
    tot = w0 + w1
    vals = (w0 / tot)[:, None] * cell_values[c0] \
        + (w1 / tot)[:, None] * cell_values[c1]
    if boundary_values is not None:
        boundary = geom["face_boundary_mask"]
        vals = np.where(boundary[:, None], boundary_values, vals)
    return vals


def map_phi_surface_to_faces(phi_points: np.ndarray,
                             point_pos: np.ndarray,
                             face_pos: np.ndarray,
                             face_normal: np.ndarray,
                             face_velocity: np.ndarray,
                             tol: float = 1e-6) -> np.ndarray:
    """Map OpenFOAM ``surfaceFields_*.vtp`` phi point-data onto mesh faces
    (reference OpenFoam.py:275-308): match surface points to face centers by
    position, average the matched values per face, then force the sign of phi
    to agree with sign(u_f . n_f) — OpenFOAM's owner orientation is arbitrary
    relative to ours, and the reference resolves it against the face velocity.

    ``phi_points`` is (P,) or (P, k) point-data values at ``point_pos`` (P, 2)
    mid-plane positions. Faces with no matched point keep flux 0.
    """
    from scipy.spatial import cKDTree
    F = face_pos.shape[0]
    if point_pos.shape[0] == 0:     # e.g. every surface point z-filtered out
        return np.zeros((F, 1), np.float64)
    phi_points = np.asarray(phi_points, np.float64).reshape(
        point_pos.shape[0], -1).mean(axis=1)
    out = np.zeros((F, 1), np.float64)
    counts = np.zeros(F, np.int64)
    tree = cKDTree(face_pos)
    dist, idx = tree.query(point_pos)
    ok = dist < tol
    np.add.at(out[:, 0], idx[ok], phi_points[ok])
    np.add.at(counts, idx[ok], 1)
    out[counts > 0, 0] /= counts[counts > 0]
    vel_dot = np.sum(face_normal * face_velocity, axis=1)
    mismatch = (np.sign(out[:, 0]) != np.sign(vel_dot)) & (out[:, 0] != 0)
    out[mismatch, 0] *= -1.0
    return out


def slice_midplane(points3d: np.ndarray, tol: float = 1e-9
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Select the z==z_min plane of a 1-cell extrusion; returns (mask, 2-D
    points) (reference OpenFoam.py mid-plane slicing)."""
    z = points3d[:, 2]
    z0 = z.min()
    mask = np.abs(z - z0) < tol + 1e-12
    return mask, points3d[mask][:, :2]


def extract_midplane_triangles(grid) -> Tuple[np.ndarray, np.ndarray]:
    """1-cell z-extrusion -> 2-D triangulation, preserving cell order.

    OpenFOAM extrudes the 2-D triangle mesh into one layer of wedges
    (VTK_WEDGE); each 3-D cell's three vertices on the z==z_min plane ARE the
    original 2-D triangle, and the i-th 3-D cell corresponds to the i-th 2-D
    cell — so volume cell data (U, p) maps 1:1 onto the triangles with no
    resampling (reference OpenFoam.py mid-plane slicing)."""
    pts = np.asarray(grid.points)
    vmask, vertex_pos = slice_midplane(pts)
    remap = -np.ones(pts.shape[0], np.int64)
    remap[np.where(vmask)[0]] = np.arange(int(vmask.sum()))
    cells = []
    for i in range(grid.n_cells):
        verts = np.asarray(grid.cell_vertices(i), np.int64)
        tri = verts[vmask[verts]]
        if tri.shape[0] != 3:
            raise ValueError(
                f"cell {i} has {tri.shape[0]} mid-plane vertices; expected a "
                "1-cell triangle extrusion (wedges)")
        cells.append(remap[tri])
    return vertex_pos, np.asarray(cells, np.int64)


def preprocess_vtk_series(case_dir: str, mesh_id: str,
                          dt: float, reynolds: float = 0.0) -> Trajectory:
    """Read one simulation's VTK series -> Trajectory (self-contained
    ``vtk_io`` reader; no pyvista needed)."""
    from gnn_fluid_dynamics_tpu_torch.data import vtk_io

    vtm_files = sorted(glob.glob(os.path.join(case_dir, "VTK", "*.vtm")))
    if not vtm_files:
        raise FileNotFoundError(f"no VTK output under {case_dir}")

    def load_blocks(path):
        blocks = dict()
        for name, fpath in vtk_io.read_vtm(path):
            blocks[name] = fpath
        return blocks

    first = load_blocks(vtm_files[0])
    assert "internal" in first, f"no internal block in {vtm_files[0]}"
    internal = vtk_io.read(first["internal"])
    vertex_pos, cells = extract_midplane_triangles(internal)

    patch_points = {
        name: np.asarray(vtk_io.read(fpath).points)
        for name, fpath in first.items() if name != "internal"
    }
    vertex_types = classify_vertices_by_patches(vertex_pos, patch_points)
    geom = build_geometry(vertex_pos, cells, vertex_types, NodeType)

    surface_dir = os.path.join(case_dir, "VTK", "surfaceFields")
    cv, cp, fv, fp, flux = [], [], [], [], []
    for path in vtm_files:
        block = vtk_io.read(load_blocks(path)["internal"])
        u = np.asarray(block.cell_data["U"])[:, :2]
        p = np.asarray(block.cell_data["p"]).reshape(-1, 1)
        cv.append(u)
        cp.append(p)
        face_u = cell_fields_to_faces(u, geom)
        fv.append(face_u)
        fp.append(cell_fields_to_faces(p, geom))

        # face flux phi from the surfaceFields VTP written by
        # `foamToVTK -surfaceFields` (reference OpenFoam.py:275-308) —
        # controlDict writes (U p phi), see generate/openfoam/*/controlDict
        ts_num = os.path.basename(path).rsplit("_", 1)[-1].split(".")[0]
        surf_path = os.path.join(surface_dir, f"surfaceFields_{ts_num}.vtp")
        face_phi = np.zeros((geom["face_pos"].shape[0], 1), np.float64)
        if os.path.exists(surf_path):
            surf = vtk_io.read_vtp(surf_path)
            if "phi" in surf.point_data:
                pts = np.asarray(surf.points)
                # keep the extrusion side points (mid-plane), drop the
                # z-extremes (front/back planes) — reference slicing rule
                z = pts[:, 2]
                z_tol = max((z.max() - z.min()) * 0.01, 1e-12)
                side = ~((np.abs(z - z.min()) < z_tol)
                         | (np.abs(z - z.max()) < z_tol))
                face_phi = map_phi_surface_to_faces(
                    np.asarray(surf.point_data["phi"])[side], pts[side][:, :2],
                    geom["face_pos"], geom["face_normal"], face_u)
        flux.append(face_phi)
    fields = {
        "cell_velocity": np.stack(cv).astype(np.float32),
        "cell_pressure": np.stack(cp).astype(np.float32),
        "face_velocity": np.stack(fv).astype(np.float32),
        "face_pressure": np.stack(fp).astype(np.float32),
        "face_flux": np.stack(flux).astype(np.float32),
    }
    return Trajectory(mesh_id=mesh_id, geom=geom, fields=fields, dt=dt,
                      reynolds=reynolds)


def preprocess_dataset(vtk_root: str, out_path: str,
                       subset_ids: Sequence[int], dt: float = 0.01):
    """Convert a directory of cases into one HDF5 dataset file (the analogue
    of reference ``src/preproc.py:132-173``)."""
    from gnn_fluid_dynamics_tpu_torch.data.hdf5 import save_dataset
    trajectories = []
    for i in subset_ids:
        case = os.path.join(vtk_root, f"mesh_{i}")
        meta_path = os.path.join(case, "meta.json")
        re = 0.0
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                re = float(json.load(f).get("Re", 0.0))
        trajectories.append(preprocess_vtk_series(case, f"mesh_{i}", dt, re))
    save_dataset(out_path, trajectories)
    return trajectories
