"""Locality-preserving mesh reordering (offline, numpy).

Reverse-Cuthill-McKee on the vertex graph, with edges ordered by their lowest
endpoint rank and cells by their lowest vertex rank. After this permutation,
entities that interact are close in index space, so the gathers of the GN-block
kernels (:mod:`gnn_fluid_dynamics_tpu_torch.ops.kernels`) read nearby rows.

This is a pure relabeling: all connectivity arrays (including the derived
``cell_face_sign``/``owner_local_slot`` tables) are remapped consistently, so
the numerics are unchanged up to floating-point summation order. It is an
opt-in perf transform — reference-format datasets keep their original
``triangles_to_faces`` ordering unless this is applied.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from gnn_fluid_dynamics_tpu_torch.training import profiling


def rcm_reorder_geometry(geom: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Return a new geometry dict with vertices/edges/cells RCM-relabeled;
    the span ``setup.rcm``."""
    with profiling.span("setup.rcm"):
        return _rcm_reorder_geometry(geom)


def _rcm_reorder_geometry(geom):
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    vei = np.asarray(geom["vertex_edge_index"])
    V = geom["vertex_pos"].shape[0]
    F = vei.shape[1]
    C = geom["cell_pos"].shape[0]

    adj = csr_matrix((np.ones(F), (vei[0], vei[1])), shape=(V, V))
    perm = np.asarray(reverse_cuthill_mckee(adj + adj.T))
    vrank = np.empty(V, np.int64)
    vrank[perm] = np.arange(V)                    # old vertex id -> new id

    # edges ordered by their lowest new endpoint
    s_new, r_new = vrank[vei[0]], vrank[vei[1]]
    eorder = np.argsort(np.minimum(s_new, r_new), kind="stable")
    erank = np.empty(F, np.int64)
    erank[eorder] = np.arange(F)                  # old face id -> new id

    # cells ordered by their lowest new vertex
    vface = np.asarray(geom["vertex_face"])       # (3, C) old vertex ids
    corder = np.argsort(vrank[vface].min(axis=0), kind="stable")
    crank = np.empty(C, np.int64)
    crank[corder] = np.arange(C)

    out = dict(geom)
    # vertices
    out["vertex_pos"] = geom["vertex_pos"][perm]
    # per-face arrays: new face f was old face eorder[f]
    out["vertex_edge_index"] = vrank[vei][:, eorder]
    out["face_normal"] = geom["face_normal"][eorder]
    out["face_pos"] = geom["face_pos"][eorder]
    out["face_area"] = geom["face_area"][eorder]
    out["face_type"] = geom["face_type"][eorder]
    out["face_boundary_mask"] = geom["face_boundary_mask"][eorder]
    out["cell_edge_index"] = crank[geom["cell_edge_index"]][:, eorder]
    out["owner_local_slot"] = geom["owner_local_slot"][eorder]
    if "vertex_edge_vector" in geom:
        out["vertex_edge_vector"] = geom["vertex_edge_vector"][eorder]
    # per-cell arrays: new cell c was old cell corder[c]
    out["cell_pos"] = geom["cell_pos"][corder]
    out["cell_volume"] = geom["cell_volume"][corder]
    out["cell_normal"] = geom["cell_normal"][corder]
    out["cell_face_sign"] = geom["cell_face_sign"][corder]
    out["face_index"] = erank[geom["face_index"]][:, corder]
    out["vertex_face"] = vrank[vface][:, corder]
    return out


def perms_from_pos(geom_old, geom_new):
    """(cell_perm, face_perm) mapping new element order -> old, recovered by
    position matching so callers don't need to thread the ranks through."""
    def perm_from_pos(old_pos, new_pos):
        from scipy.spatial import cKDTree
        d, idx = cKDTree(old_pos).query(new_pos)
        assert d.max() < 1e-9
        return idx

    return (perm_from_pos(geom_old["cell_pos"], geom_new["cell_pos"]),
            perm_from_pos(geom_old["face_pos"], geom_new["face_pos"]))


def reorder_fields(fields: Dict[str, np.ndarray],
                   geom_old: Dict[str, np.ndarray],
                   geom_new: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Permute time-major field arrays to match a reordered geometry."""
    cperm, fperm = perms_from_pos(geom_old, geom_new)
    out = {}
    for key, arr in fields.items():
        if key.startswith("cell_") and "neighbour" not in key:
            out[key] = arr[:, cperm] if arr.ndim >= 2 else arr
        elif key.startswith("face_") and "neighbour" not in key:
            out[key] = arr[:, fperm] if arr.ndim >= 2 else arr
        else:
            out[key] = arr
    return out
