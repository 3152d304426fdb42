"""CFD simulation CLI (counterpart of ``generate/simulation.py``;
reference ``generate/simulation.py``).

Two backends for producing ground-truth trajectories from generated meshes:

* **OpenFOAM** (``pimpleFoam``) when the binaries exist: copy a case template,
  convert the mesh, patch boundary files, set inlet velocity / nu / dt /
  endTime via ``foamDictionary`` and run — the reference's path
  (simulation.py:34-258). Sharded over workers (``--shard-index/--num-shards``, defaulting to a
  SLURM array's task id and count).
* **Built-in solver**: a semi-implicit fractional-step (Chorin projection)
  incompressible FVM solver on the same unstructured mesh — pure
  numpy/scipy, no external tooling — so the full data pipeline runs
  end-to-end anywhere. Not reference code: an independent textbook
  discretization (owner/neighbour face fluxes, pressure Poisson solve).

Usage::

    python -m gnn_fluid_dynamics_tpu_torch.generate.simulation \
        --meshes data/meshes --out data/raw --steps 400 [--shard-index i --num-shards n]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import time
from typing import Dict

import numpy as np


def have_openfoam() -> bool:
    return shutil.which("pimpleFoam") is not None


# ---------------------------------------------------------------------------
# Built-in incompressible solver (projection method on the polygonal mesh)
# ---------------------------------------------------------------------------

def simulate_projection(geom: Dict[str, np.ndarray], params: Dict,
                        num_steps: int, save_every: int = 1,
                        spinup_saves: int = 0):
    """Chorin projection on the triangular mesh.

    Cell-centered u, p; carried divergence-free face flux with incremental
    flux prediction; explicit upwind advection + diffusion; implicit pressure
    Poisson via a sparse owner/neighbour two-point Laplacian. Inlet: ramped
    parabolic u; walls: no-slip; outlet: p = 0. Returns time-major field dict
    in the canonical layout.

    Stable on structured channel meshes (bounded energy, flux divergence
    ~1e-12) AND on the quick Delaunay obstacle meshes from ``data.synthetic``
    (adaptive CFL substepping + the momentum-consistent face-normal LSQ
    pressure gradient close the sliver-cell pressure/velocity feedback loop
    that previously blew them up).
    """
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    from gnn_fluid_dynamics_tpu_torch.data.node_types import NodeType

    cei = geom["cell_edge_index"]
    own, nei = cei[0], cei[1]
    interior = own != nei
    C = geom["cell_pos"].shape[0]
    F = geom["face_pos"].shape[0]
    area = geom["face_area"].reshape(-1).astype(np.float64)
    vol = geom["cell_volume"].reshape(-1).astype(np.float64)
    nrm = geom["face_normal"].astype(np.float64)
    fpos = geom["face_pos"].astype(np.float64)
    cpos = geom["cell_pos"].astype(np.float64)
    ftype = geom["face_type"].reshape(-1)
    sign = geom["cell_face_sign"]            # (C, 3)
    gface = geom["face_index"].T             # (C, 3)

    nu = params["u_in"] * 2 * params["rx"] / params["Re"]
    ly = params["ly"]

    # face interpolation weights
    d0 = np.linalg.norm(fpos - cpos[own], axis=1)
    d1 = np.linalg.norm(fpos - cpos[nei], axis=1)
    w0 = 1.0 / (d0 + 1e-10)
    w1 = np.where(interior, 1.0 / (d1 + 1e-10), 0.0)
    wt = w0 + w1
    w0, w1 = w0 / wt, w1 / wt
    dist_on = np.linalg.norm(cpos[nei] - cpos[own], axis=1)
    dist_on = np.where(interior, dist_on, 2 * d0)

    # explicit-stability substepping with PER-CELL bounds — unstructured
    # meshes contain sliver cells whose volume, not edge length, limits dt:
    #   advective: dt < V_c / (u_scale * sum_f A_f)
    #   diffusive: dt < V_c / (2 nu * sum_f A_f/d_f)
    gface_ = geom["face_index"].T
    sum_area = area[gface_].sum(axis=1)
    sum_coef = (area / dist_on)[gface_].sum(axis=1)
    dt_diff = float((vol / (2.0 * nu * sum_coef + 1e-12)).min())
    dt_save_total = params["dt"] * save_every

    def stable_dt(u_now):
        # ADAPTIVE advective bound from the actual velocity field: flow
        # around the obstacle accelerates past any fixed multiple of u_in,
        # and a fixed bound turns into a local CFL runaway at the worst
        # sliver cell (grows slowly, then blows up)
        u_scale = max(2.5 * params["u_in"], 1.5 * float(np.abs(u_now).max()))
        dt_adv = float((vol / (u_scale * sum_area)).min())
        return 0.4 * min(dt_adv, dt_diff)

    n_sub0 = max(1, int(np.ceil(dt_save_total / stable_dt(
        np.full((1, 2), params["u_in"])))))

    inflow = ftype == NodeType.INFLOW
    outflow = ftype == NodeType.OUTFLOW
    wall = (ftype == NodeType.WALL_BOUNDARY) & (own == nei)

    def inlet_profile(y):
        return 4.0 * params["u_in"] * y * (ly - y) / ly ** 2

    u_bc_full = np.zeros((F, 2))
    u_bc_full[inflow, 0] = inlet_profile(fpos[inflow, 1])


    # pressure Poisson operator: sum_f area/dist * (p_n - p_o) = div(u*)/dt
    rows, cols, vals = [], [], []
    coef = area / dist_on
    for f in range(F):
        o, n = own[f], nei[f]
        if interior[f]:
            rows += [o, o, n, n]
            cols += [o, n, n, o]
            vals += [-coef[f], coef[f], -coef[f], coef[f]]
        elif outflow[f]:
            rows += [o]; cols += [o]; vals += [-coef[f]]   # p = 0 at outlet
    A = sp.csr_matrix((vals, (rows, cols)), shape=(C, C))
    # all-Neumann guard: pin one cell if no outlet faces
    if not outflow.any():
        A = A.tolil(); A[0] = 0.0; A[0, 0] = 1.0; A = A.tocsr()
    solve_p = spla.factorized(A.tocsc())

    def face_values(uc, bc_override=True):
        uf = w0[:, None] * uc[own] + w1[:, None] * uc[nei]
        if bc_override:
            uf[inflow] = u_bc[inflow]
            uf[wall] = 0.0
        return uf

    def flux_divergence(phi):
        return np.sum(phi[gface] * sign, axis=1)

    uc = np.zeros((C, 2))
    pc = np.zeros(C)
    u_bc = np.zeros((F, 2))
    phi = np.zeros(F)                                     # carried face flux
    bc_fixed = inflow | wall                              # flux fixed by BCs
    t_ramp = dt_save_total * max(n_sub0 // 2, 20) / max(n_sub0, 1)

    # momentum-consistent LSQ pressure gradient for the cell velocity: fit
    # the gradient to the SAME face-normal pressure differences that correct
    # the carried flux, with walls/inflow contributing dp/dn = 0 (the
    # physical boundary condition). Smooth-field gradients (cell-centred MLS
    # or Green-Gauss) feed a local pressure<->velocity amplification loop at
    # the worst sliver cells next to the obstacle (velocity spike -> flux
    # increment -> pressure spike -> larger gradient) that slowly blows up;
    # the face-normal-consistent fit closes that loop.
    unv_gg = geom["cell_normal"].astype(np.float64)        # (C,3,2) outward
    other_cell = np.where(sign == 1.0, nei[gface], own[gface])   # (C,3)
    fdist = dist_on[gface]                                 # (C,3)
    fw = area[gface]                                       # (C,3) LSQ weights
    M = np.einsum("cf,cfi,cfj->cij", fw, unv_gg, unv_gg)
    M += 1e-12 * np.eye(2)[None]
    Minv = np.linalg.inv(M)
    face_outflow = outflow[gface]
    face_bnd = (own == nei)[gface]

    def pressure_gradient(pc):
        dd = np.where(face_bnd,
                      np.where(face_outflow, 0.0 - pc[:, None], 0.0),
                      pc[other_cell] - pc[:, None]) / fdist
        b = np.einsum("cf,cfi,cf->ci", fw, unv_gg, dd)
        return np.einsum("cij,cj->ci", Minv, b)

    debug = bool(int(os.environ.get("GFD_SOLVER_DEBUG", "0")))
    cvs, cps, fvs, fps, fluxes = [], [], [], [], []
    t = 0.0
    for save_step in range(num_steps + spinup_saves):
        # re-plan the substep count for this save interval from the current
        # velocity field (the loop body sees a constant dt per interval)
        n_sub = max(1, int(np.ceil(dt_save_total / stable_dt(uc))))
        dt = dt_save_total / n_sub
        for sub in range(n_sub):
            if debug and save_step < 3:
                print(f"  t={t:.4f}: maxvel={np.abs(uc).max():.3f} "
                      f"maxdiv={np.abs(flux_divergence(phi)).max():.2e} "
                      f"maxp={np.abs(pc).max():.2f} dt={dt:.2e} "
                      f"n_sub={n_sub}")
            t += dt
            ramp = min(1.0, t / t_ramp)
            u_bc = ramp * u_bc_full
            # advective: sum_f phi * u_f (upwinded by the carried flux sign)
            upw = np.where((phi > 0)[:, None], uc[own], uc[nei])
            upw[inflow] = u_bc[inflow]
            upw[wall] = 0.0
            adv = np.add.reduce(
                (phi[gface] * sign)[..., None] * upw[gface], axis=1)
            # diffusive: sum_f nu * area/dist * (u_n - u_o) with BC values
            du = np.where(interior[:, None], uc[nei] - uc[own],
                          2 * (np.where(wall[:, None], 0.0,
                                        np.where(inflow[:, None], u_bc, uc[own]))
                               - uc[own]))
            dif_f = nu * coef[:, None] * du
            own_sign_pos = sign == 1.0
            dif = np.add.reduce(np.where(own_sign_pos[..., None],
                                         dif_f[gface], -dif_f[gface]), axis=1)
            u_star = uc + dt / vol[:, None] * (-adv + dif)

            # incremental flux predictor: carry the divergence-free flux and add
            # only the velocity *increment*'s interpolated flux — otherwise the
            # interpolation error re-enters div(phi*) every step and the pressure
            # scales as O(1/dt) (the classic collocated-grid failure mode)
            duf = face_values(u_star, bc_override=False) \
                - face_values(uc, bc_override=False)
            phi_star = phi + np.sum(duf * nrm, axis=1) * area
            bc_flux = np.sum(u_bc * nrm, axis=1) * area
            phi_star = np.where(bc_fixed, np.where(wall, 0.0, bc_flux), phi_star)
            rhs = flux_divergence(phi_star) / dt
            pc = solve_p(rhs)
            dp = np.where(interior, pc[nei] - pc[own],
                          np.where(outflow, 0.0 - pc[own], 0.0))
            phi = np.where(bc_fixed, phi_star, phi_star - dt * coef * dp)
            # cell velocity: momentum-consistent pressure correction (the
            # carried face flux stays the divergence-defining quantity)
            uc = u_star - dt * pressure_gradient(pc)

        if save_step < spinup_saves:
            # spin-up: the impulsive start produces a large pressure
            # transient (O(100x) the developed field) that would skew the
            # dataset statistics and the learned pressure scale
            continue
        uf_out = face_values(uc)
        pf_out = w0 * pc[own] + w1 * pc[nei]
        pf_out[outflow] = 0.0
        cvs.append(uc.copy())
        cps.append(pc[:, None].copy())
        fvs.append(uf_out)
        fps.append(pf_out[:, None].copy())
        fluxes.append(phi[:, None].copy())
    return {
        "cell_velocity": np.stack(cvs).astype(np.float32),
        "cell_pressure": np.stack(cps).astype(np.float32),
        "face_velocity": np.stack(fvs).astype(np.float32),
        "face_pressure": np.stack(fps).astype(np.float32),
        "face_flux": np.stack(fluxes).astype(np.float32),
    }


# ---------------------------------------------------------------------------
# OpenFOAM backend
# ---------------------------------------------------------------------------

def run_openfoam_case(case_src: str, case_dst: str, mesh: Dict, params: Dict,
                      num_steps: int):
    """Stage the case (template copy + mesh export + gmshToFoam + boundary
    patch + checkMesh, generate/foam.py), then solve with pimpleFoam and
    export VTK with surface fields (reference simulation.py:34-258;
    controlDict writes (U p phi) so foamToVTK carries the face flux)."""
    from gnn_fluid_dynamics_tpu_torch.generate.foam import stage_case
    stage_case(case_src, case_dst, mesh, params, num_steps)
    subprocess.run(["pimpleFoam"], cwd=case_dst, check=True)
    subprocess.run(["foamToVTK", "-surfaceFields"], cwd=case_dst, check=True)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--meshes", type=str, default="data/meshes")
    parser.add_argument("--out", type=str, default="data/raw")
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--save-every", type=int, default=2,
                        help="solver substeps per saved frame (reference "
                        "conversion.py keeps every 2nd step and doubles dt)")
    parser.add_argument("--shard-index", type=int,
                        default=int(os.environ.get("SLURM_ARRAY_TASK_ID", 0)))
    parser.add_argument("--num-shards", type=int,
                        default=int(os.environ.get("SLURM_ARRAY_TASK_COUNT", 1)))
    parser.add_argument("--backend", type=str, default="auto",
                        choices=["auto", "openfoam", "builtin"])
    parser.add_argument("--spinup", type=int, default=10,
                        help="saved intervals to simulate and discard before "
                             "recording (flushes the impulsive-start "
                             "pressure transient)")
    parser.add_argument("--spinup-crossings", type=float, default=0.0,
                        help="if > 0, raise the spinup to cover this many "
                             "domain crossings (lx/u_in of physical time) so "
                             "slow-inflow sims record developed flow; the "
                             "adaptive substep makes a crossing cost roughly "
                             "the same wall time at any u_in")
    parser.add_argument("--case-template", type=str, default="laminar_ellipse",
                        choices=["laminar_ellipse", "taylor_green",
                                 "turbulent", "manufactured"],
                        help="OpenFOAM case template under generate/openfoam/")
    args = parser.parse_args(argv)

    from gnn_fluid_dynamics_tpu_torch.data.node_types import NodeType
    from gnn_fluid_dynamics_tpu_torch.ops.connectivity import build_geometry

    backend = args.backend
    if backend == "auto":
        backend = "openfoam" if have_openfoam() else "builtin"
    print(f"simulation backend: {backend}")

    cases = sorted(d for d in os.listdir(args.meshes) if d.startswith("mesh_"))
    mine = [c for i, c in enumerate(cases)
            if i % args.num_shards == args.shard_index]
    os.makedirs(args.out, exist_ok=True)
    for case in mine:
        t0 = time.time()
        # time.log is written last for both backends, after every case
        # output is complete — a crash mid-case leaves no marker, so resume
        # redoes the case instead of skipping a partial one
        done_marker = os.path.join(args.out, case, "time.log")
        if os.path.exists(done_marker):
            print(f"{case}: already done, skipping")
            continue
        case_dir = os.path.join(args.meshes, case)
        with open(os.path.join(case_dir, "meta.json")) as f:
            params = json.load(f)
        mesh = np.load(os.path.join(case_dir, "mesh.npz"))
        geom = build_geometry(mesh["vertex_pos"], mesh["cells"],
                              mesh["vertex_types"], NodeType)
        if backend == "openfoam":
            template = os.path.join(os.path.dirname(__file__), "openfoam",
                                    args.case_template)
            run_openfoam_case(template, os.path.join(args.out, case),
                              mesh, params, args.steps)
        else:
            spinup = args.spinup
            if args.spinup_crossings > 0:
                dt_saved = params["dt"] * args.save_every
                crossing = params["lx"] / max(params["u_in"], 1e-9)
                spinup = max(spinup, int(np.ceil(
                    args.spinup_crossings * crossing / dt_saved)))
            fields = simulate_projection(geom, params, args.steps,
                                         save_every=args.save_every,
                                         spinup_saves=spinup)
            out_case = os.path.join(args.out, case)
            os.makedirs(out_case, exist_ok=True)
            # np.savez_compressed is not atomic: write to a temp name and
            # rename so a concurrent/converted reader never sees a partial
            # zip (a BadZipFile race)
            tmp = os.path.join(out_case, "fields.tmp.npz")
            np.savez_compressed(tmp, **fields)
            os.replace(tmp, os.path.join(out_case, "fields.npz"))
            params["dt_saved"] = params["dt"] * args.save_every
            with open(os.path.join(out_case, "meta.json"), "w") as f:
                json.dump(params, f, indent=2)
        with open(os.path.join(args.out, case, "time.log"), "w") as f:
            f.write(f"{time.time() - t0:.2f}\n")
        print(f"{case}: done in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
