"""OpenFOAM case staging: mesh export, conversion, boundary patching
(counterpart of ``generate/foam.py``; the case templates under
``openfoam/`` are the JAX package's, copied).

The reference drives ``gmshToFoam`` on a gmsh-extruded mesh, rewrites the
``constant/polyMesh/boundary`` patch types, and validates with ``checkMesh``
(reference ``generate/utils.py:155-192``). Here the extruded mesh is
written directly in MSH 2.2 ASCII from the numpy mesh arrays — so the staging
pipeline runs identically whether the mesh came from gmsh or from the built-in
Delaunay mesher, and without gmsh installed. OpenFOAM itself is only needed
for the final conversion/solve; staging fails with a precise message when the
binaries are absent.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
from typing import Dict, Optional

import numpy as np

from gnn_fluid_dynamics_tpu_torch.data.node_types import NodeType

#: physical surface groups written to the .msh, in tag order (reference
#: generate/mesh.py physical-group relabeling, mesh.py:209-242)
PATCHES = ("inlet", "outlet", "walls", "obstacle", "frontAndBack")


def _boundary_edges(cells: np.ndarray) -> np.ndarray:
    """(E, 2) vertex pairs of edges that belong to exactly one triangle,
    ordered as they appear in that triangle (so the quad winding is outward)."""
    edges = np.concatenate([cells[:, [0, 1]], cells[:, [1, 2]],
                            cells[:, [2, 0]]])
    key = np.sort(edges, axis=1)
    _, inverse, counts = np.unique(key, axis=0, return_inverse=True,
                                   return_counts=True)
    return edges[counts[inverse] == 1]


def classify_boundary_edges(edges: np.ndarray, vertex_pos: np.ndarray,
                            vertex_types: np.ndarray,
                            box_tol: float = 1e-6) -> np.ndarray:
    """Patch index into PATCHES per boundary edge. INFLOW/OUTFLOW endpoints
    map to inlet/outlet; WALL edges on the domain bounding box are channel
    ``walls``, interior WALL edges are the ``obstacle``."""
    t0 = vertex_types[edges[:, 0]]
    t1 = vertex_types[edges[:, 1]]
    mid = vertex_pos[edges].mean(axis=1)
    lo, hi = vertex_pos.min(axis=0), vertex_pos.max(axis=0)
    on_box = ((np.abs(mid[:, 1] - lo[1]) < box_tol)
              | (np.abs(mid[:, 1] - hi[1]) < box_tol)
              | (np.abs(mid[:, 0] - lo[0]) < box_tol)
              | (np.abs(mid[:, 0] - hi[0]) < box_tol))
    patch = np.full(edges.shape[0], PATCHES.index("walls"), np.int64)
    is_in = (t0 == NodeType.INFLOW) | (t1 == NodeType.INFLOW)
    is_out = (t0 == NodeType.OUTFLOW) | (t1 == NodeType.OUTFLOW)
    # corners: a wall endpoint wins over inflow/outflow only off the box edge
    patch[is_in] = PATCHES.index("inlet")
    patch[is_out] = PATCHES.index("outlet")
    wall = (t0 == NodeType.WALL_BOUNDARY) & (t1 == NodeType.WALL_BOUNDARY)
    patch[wall & on_box] = PATCHES.index("walls")
    patch[wall & ~on_box] = PATCHES.index("obstacle")
    return patch


def write_msh2_extruded(vertex_pos: np.ndarray, cells: np.ndarray,
                        vertex_types: np.ndarray, path: str,
                        lz: float = 0.1) -> Dict[str, int]:
    """Write a 1-cell z-extrusion of the triangle mesh in MSH 2.2 ASCII —
    the input format ``gmshToFoam`` consumes (reference extrusion:
    generate/mesh.py:209-242). Prism volume elements carry the ``internal``
    physical group; side quads carry inlet/outlet/walls/obstacle; the two
    z-planes carry ``frontAndBack`` (patched to ``empty`` after conversion).

    Returns element counts (for tests/logging).
    """
    vertex_pos = np.asarray(vertex_pos, np.float64)
    cells = np.asarray(cells, np.int64)
    V = vertex_pos.shape[0]
    # consistent CCW orientation so prisms are positively oriented
    v0, v1, v2 = (vertex_pos[cells[:, k]] for k in range(3))
    signed = ((v1[:, 0] - v0[:, 0]) * (v2[:, 1] - v0[:, 1])
              - (v1[:, 1] - v0[:, 1]) * (v2[:, 0] - v0[:, 0]))
    cells = np.where(signed[:, None] >= 0, cells, cells[:, ::-1])

    edges = _boundary_edges(cells)
    patch = classify_boundary_edges(edges, vertex_pos, vertex_types)

    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$PhysicalNames",
             str(len(PATCHES) + 1)]
    for i, name in enumerate(PATCHES):
        lines.append(f'2 {i + 1} "{name}"')
    lines.append(f'3 {len(PATCHES) + 1} "internal"')
    lines.append("$EndPhysicalNames")

    lines.append("$Nodes")
    lines.append(str(2 * V))
    for z_off, base in ((0.0, 0), (lz, V)):
        for i in range(V):
            lines.append(f"{base + i + 1} {vertex_pos[i, 0]:.12g} "
                         f"{vertex_pos[i, 1]:.12g} {z_off:.12g}")
    lines.append("$EndNodes")

    elems = []
    eid = 0
    fb = PATCHES.index("frontAndBack") + 1
    for c in cells:
        eid += 1            # bottom triangle (reversed: outward -z normal)
        elems.append(f"{eid} 2 2 {fb} {fb} "
                     f"{c[2] + 1} {c[1] + 1} {c[0] + 1}")
    for c in cells:
        eid += 1            # top triangle
        elems.append(f"{eid} 2 2 {fb} {fb} "
                     f"{c[0] + V + 1} {c[1] + V + 1} {c[2] + V + 1}")
    for (a, b), p in zip(edges, patch):
        eid += 1            # side quad, outward winding
        elems.append(f"{eid} 3 2 {p + 1} {p + 1} "
                     f"{a + 1} {b + 1} {b + V + 1} {a + V + 1}")
    for c in cells:
        eid += 1            # prism (MSH type 6)
        elems.append(f"{eid} 6 2 {len(PATCHES) + 1} {len(PATCHES) + 1} "
                     f"{c[0] + 1} {c[1] + 1} {c[2] + 1} "
                     f"{c[0] + V + 1} {c[1] + V + 1} {c[2] + V + 1}")
    lines.append("$Elements")
    lines.append(str(eid))
    lines.extend(elems)
    lines.append("$EndElements")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return {"nodes": 2 * V, "prisms": cells.shape[0],
            "quads": edges.shape[0], "triangles": 2 * cells.shape[0]}


def patch_boundary_file(text: str) -> str:
    """Rewrite patch types in ``constant/polyMesh/boundary`` the way the
    reference does after gmshToFoam (generate/utils.py:90-148): frontAndBack
    becomes ``empty``; walls/obstacle become ``wall``."""
    lines = text.splitlines(keepends=True)
    section = None
    for i, line in enumerate(lines):
        stripped = line.strip()
        if stripped in ("frontAndBack", "walls", "obstacle") and \
                i + 1 < len(lines) and lines[i + 1].strip() == "{":
            section = stripped
            continue
        if section is not None:
            if ("type" in stripped or "physicalType" in stripped) \
                    and "patch" in stripped:
                repl = "empty" if section == "frontAndBack" else "wall"
                lines[i] = line.replace("patch", repl)
            if stripped == "}":
                section = None
    return "".join(lines)


def set_foam_entry(path: str, key: str, value) -> None:
    """Set ``key value;`` in an OpenFOAM dictionary file. Uses plain text
    substitution so staging works without ``foamDictionary`` on PATH (the
    reference shells out to foamDictionary, generate/utils.py:63-80)."""
    with open(path) as f:
        text = f.read()
    pattern = re.compile(rf"^(\s*{re.escape(key)}\s+)[^;]*;",
                         flags=re.MULTILINE)
    if pattern.search(text):
        text = pattern.sub(rf"\g<1>{value};", text)
    else:
        text = text.rstrip() + f"\n{key}    {value};\n"
    with open(path, "w") as f:
        f.write(text)


def have_openfoam() -> bool:
    return shutil.which("pimpleFoam") is not None


def stage_case(template_dir: str, case_dst: str, mesh: Dict[str, np.ndarray],
               params: Dict, num_steps: int, lz: float = 0.1) -> str:
    """Copy the case template, write + convert the extruded mesh, patch the
    boundary file, and validate with checkMesh (reference generate/
    utils.py:155-192). Everything up to the gmshToFoam call is pure Python;
    if the OpenFOAM binaries are missing, the staged case is left on disk and
    a precise error is raised.

    Returns the staged case directory.
    """
    if not os.path.isdir(template_dir):
        raise FileNotFoundError(f"case template not found: {template_dir}")
    shutil.copytree(template_dir, case_dst, dirs_exist_ok=True)

    msh_path = os.path.join(case_dst, "mesh_extruded.msh")
    write_msh2_extruded(mesh["vertex_pos"], mesh["cells"],
                        mesh["vertex_types"], msh_path, lz=lz)

    # physical dict entries (reference simulation.py:34-101)
    nu = params["u_in"] * 2 * params["rx"] / params["Re"]
    set_foam_entry(os.path.join(case_dst, "constant/transportProperties"),
                   "nu", f"nu [0 2 -1 0 0 0 0] {nu}")
    ctrl = os.path.join(case_dst, "system/controlDict")
    set_foam_entry(ctrl, "deltaT", params["dt"])
    set_foam_entry(ctrl, "endTime", params["dt"] * num_steps)
    set_foam_entry(ctrl, "writeInterval", params["dt"])

    if shutil.which("gmshToFoam") is None:
        raise RuntimeError(
            "OpenFOAM not installed (gmshToFoam not on PATH); case staged at "
            f"{case_dst} — run 'gmshToFoam mesh_extruded.msh', patch "
            "constant/polyMesh/boundary, then pimpleFoam")
    subprocess.run(["gmshToFoam", "mesh_extruded.msh"], cwd=case_dst,
                   check=True)
    boundary = os.path.join(case_dst, "constant", "polyMesh", "boundary")
    with open(boundary) as f:
        text = f.read()
    with open(boundary, "w") as f:
        f.write(patch_boundary_file(text))
    with open(os.path.join(case_dst, "checkMesh.log"), "w") as log:
        subprocess.run(["checkMesh", "-allTopology", "-allGeometry"],
                       cwd=case_dst, check=True, stdout=log,
                       stderr=subprocess.STDOUT)
    return case_dst
