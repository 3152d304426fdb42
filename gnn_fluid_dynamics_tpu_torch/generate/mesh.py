"""Mesh generation CLI (counterpart of ``generate/mesh.py``; reference
``generate/mesh.py``).

Generates randomized ellipse-in-channel meshes with graded refinement and
per-mesh ``meta.json`` (position/size/angle/Re randomized; CFL-derived dt —
reference mesh.py:276-360). Two backends:

* ``gmsh`` when importable (imported inside the functions that use it) — graded refinement fields around the obstacle and
  a tear-drop wake region (reference mesh.py:101-171);
* the built-in Delaunay generator (``data.synthetic.cylinder_channel_mesh``)
  otherwise — no external tooling needed for end-to-end runs.

Usage::

    python -m gnn_fluid_dynamics_tpu_torch.generate.mesh --num 10 --out data/meshes
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Tuple

import numpy as np


def have_gmsh() -> bool:
    try:
        import gmsh  # noqa: F401
        return True
    except ImportError:
        return False


def random_case_params(rng: np.random.Generator,
                       lx: float = 2.0, ly: float = 1.0,
                       regime: str = "viscosity") -> Dict:
    """Randomized obstacle position/size/angle and Reynolds number
    (reference mesh.py:276-334).

    Two Re regimes:

    * ``viscosity`` (legacy rounds 2-4): ``u_in = 1`` fixed, Re drawn in
      [100, 1000] and realised through the viscosity ``nu = u_in*D/Re``.
      Since nu is NOT an input feature of any model family, the per-sim
      pressure drop is unidentifiable from the model's inputs — two sims
      with the same geometry and inflow but different nu are
      indistinguishable one-step, yet have different pressure levels.
    * ``inflow`` — faithful to the reference generator (mesh.py:280-331:
      ``nu = 0.001`` fixed, ``Re = U(50, 200)``, ``u = Re*nu/D``): Re is
      realised through the inlet speed, which IS observable from the
      velocity features, so the pressure drop becomes learnable.
    """
    rx = rng.uniform(0.06, 0.15)
    ry = rx * rng.uniform(0.5, 1.0)
    params = {
        "lx": lx, "ly": ly,
        "cx": rng.uniform(0.35, 0.6) * lx / 2.0,
        "cy": rng.uniform(0.35, 0.65) * ly,
        "rx": rx, "ry": ry,
        "angle": rng.uniform(0, np.pi),
        "regime": regime,
    }
    if regime == "inflow":
        nu = 0.001
        re = float(rng.uniform(50, 200))
        params["Re"] = re
        params["u_in"] = re * nu / (2.0 * rx)   # solver recovers nu = 0.001
    else:
        params["Re"] = float(rng.uniform(100, 1000))
        params["u_in"] = 1.0
    return params


def cfl_dt(params: Dict, h: float, cfl: float = 0.5) -> float:
    """CFL-derived timestep (reference mesh.py:321-334)."""
    return cfl * h / max(params["u_in"], 1e-6)


def generate_mesh_gmsh(params: Dict, h: float = 0.03):
    """Graded gmsh mesh: fine near obstacle/walls, tear-drop wake refinement
    (reference mesh.py:101-171)."""
    import gmsh
    gmsh.initialize()
    try:
        gmsh.model.add("channel")
        lx, ly = params["lx"], params["ly"]
        cx, cy, rx, ry = params["cx"], params["cy"], params["rx"], params["ry"]
        rect = gmsh.model.occ.addRectangle(0, 0, 0, lx, ly)
        hole = gmsh.model.occ.addDisk(cx, cy, 0, rx, ry)
        gmsh.model.occ.rotate([(2, hole)], cx, cy, 0, 0, 0, 1, params["angle"])
        surf, _ = gmsh.model.occ.cut([(2, rect)], [(2, hole)])
        gmsh.model.occ.synchronize()

        # distance-based refinement around the obstacle + wake MathEval field
        fid = gmsh.model.mesh.field.add("Distance")
        curves = [c[1] for c in gmsh.model.getBoundary(surf, oriented=False)]
        gmsh.model.mesh.field.setNumbers(fid, "CurvesList", curves)
        thr = gmsh.model.mesh.field.add("Threshold")
        gmsh.model.mesh.field.setNumber(thr, "InField", fid)
        gmsh.model.mesh.field.setNumber(thr, "SizeMin", h / 3)
        gmsh.model.mesh.field.setNumber(thr, "SizeMax", h)
        gmsh.model.mesh.field.setNumber(thr, "DistMin", rx)
        gmsh.model.mesh.field.setNumber(thr, "DistMax", 4 * rx)
        wake = gmsh.model.mesh.field.add("MathEval")
        gmsh.model.mesh.field.setString(
            wake, "F",
            f"{h} - {h * 0.5}*exp(-((y-{cy})/{2 * ry})^2)"
            f"*exp(-max(0,{cx}-x)/{rx})")
        mn = gmsh.model.mesh.field.add("Min")
        gmsh.model.mesh.field.setNumbers(mn, "FieldsList", [thr, wake])
        gmsh.model.mesh.field.setAsBackgroundMesh(mn)
        gmsh.model.mesh.generate(2)

        node_tags, coords, _ = gmsh.model.mesh.getNodes()
        pos = np.asarray(coords).reshape(-1, 3)[:, :2]
        remap = {t: i for i, t in enumerate(node_tags)}
        etypes, _, enodes = gmsh.model.mesh.getElements(dim=2)
        tris = np.asarray(enodes[0]).reshape(-1, 3)
        cells = np.vectorize(remap.get)(tris)
        return pos, cells
    finally:
        gmsh.finalize()


def generate_mesh(params: Dict, h: float = 0.03):
    """Mesh by the best available backend; returns (pos, cells, vertex_types)."""
    from gnn_fluid_dynamics_tpu_torch.data.node_types import NodeType
    from gnn_fluid_dynamics_tpu_torch.data.synthetic import cylinder_channel_mesh
    if have_gmsh():
        pos, cells = generate_mesh_gmsh(params, h)
        eps = 1e-9
        vt = np.full(pos.shape[0], NodeType.NORMAL, np.int64)
        on_hole = (((pos[:, 0] - params["cx"]) / params["rx"]) ** 2
                   + ((pos[:, 1] - params["cy"]) / params["ry"]) ** 2) < 1.2
        interiorish = ((pos[:, 0] > eps) & (pos[:, 0] < params["lx"] - eps)
                       & (pos[:, 1] > eps) & (pos[:, 1] < params["ly"] - eps))
        vt[on_hole & interiorish] = NodeType.WALL_BOUNDARY
        vt[np.abs(pos[:, 1]) < eps] = NodeType.WALL_BOUNDARY
        vt[np.abs(pos[:, 1] - params["ly"]) < eps] = NodeType.WALL_BOUNDARY
        vt[np.abs(pos[:, 0] - params["lx"]) < eps] = NodeType.OUTFLOW
        vt[np.abs(pos[:, 0]) < eps] = NodeType.INFLOW
        return pos, cells, vt
    n_points = int(params["lx"] * params["ly"] / h ** 2)
    return cylinder_channel_mesh(
        n_points=n_points, lx=params["lx"], ly=params["ly"],
        cx=params["cx"], cy=params["cy"], rx=params["rx"], ry=params["ry"])


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num", type=int, default=10)
    parser.add_argument("--out", type=str, default="data/meshes")
    parser.add_argument("--h", type=float, default=0.03)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--regime", choices=("viscosity", "inflow"),
                        default="viscosity",
                        help="how Re is realised (see random_case_params)")
    parser.add_argument("--dt", type=float, default=None,
                        help="fixed saved dt for every mesh (the reference "
                             "uses one global dt = h_min/(2 v_max), "
                             "mesh.py:302; per-sim dt would be a hidden, "
                             "unobservable variable for the models). "
                             "Default: per-sim CFL dt (legacy).")
    args = parser.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    os.makedirs(args.out, exist_ok=True)
    for i in range(args.num):
        params = random_case_params(rng, regime=args.regime)
        pos, cells, vt = generate_mesh(params, args.h)
        params["dt"] = args.dt if args.dt else cfl_dt(params, args.h)
        params["num_vertices"] = int(pos.shape[0])
        params["num_cells"] = int(cells.shape[0])
        case = os.path.join(args.out, f"mesh_{i}")
        os.makedirs(case, exist_ok=True)
        np.savez(os.path.join(case, "mesh.npz"), vertex_pos=pos, cells=cells,
                 vertex_types=vt)
        with open(os.path.join(case, "meta.json"), "w") as f:
            json.dump(params, f, indent=2)
        print(f"mesh_{i}: {pos.shape[0]} vertices, {cells.shape[0]} cells")


if __name__ == "__main__":
    main()
