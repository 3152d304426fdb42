"""The plain reference of a rollout cell: meshes -> geometry -> initial
features -> statistics, then any step of the rollout from a given state,
and the rollout's error metrics (relative squared error of the cell
velocity and of the cell pressure against the analytic flow, mean squared
divergence) from given fields.

A random-weight rollout is chaotic: two sound evaluations, one in bf16 and
one in f32, part after some tens of steps, as would two f32 ones summed in
another order. So the check follows the program step by step: the first
step from the reference's own initial state, every later sampled step from
the program's state before it, through the reference's own feedback (the
next step's features from that state).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from perfbench.harness import meshgen
from perfbench.reference import geometry, model as ref


def segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=x.dtype, device=x.device).index_add_(0, seg, x)


def flow_at(m: ref.Mesh, t: float, flow: dict):
    """(cell velocity (C, 2), cell pressure (C, 1)) of the flow at time t."""
    u, v = meshgen.channel_velocity(m.cell_pos[:, 0], m.cell_pos[:, 1], t, **flow)
    p_kw = {k: flow[k] for k in ("u_in", "shed_freq") if k in flow}
    return (torch.stack([u, v], 1),
            meshgen.channel_pressure(m.cell_pos[:, 0], t, **p_kw)[:, None])


def setup(meshes: Sequence, traffic: dict, cfg: dict, device):
    """(mesh, initial features, statistics) of the reference from the raw
    meshes ((vertex_pos, cells, vertex_types) each)."""
    m = ref.Mesh([geometry.build_geometry(*mesh) for mesh in meshes], device)
    dt = traffic["dt"]
    times = [traffic["t0_step"] * dt, (traffic["t0_step"] + 1) * dt]
    fields = {k: torch.from_numpy(v).to(device) for k, v in meshgen.flow_fields(
        m.cell_pos.cpu().numpy(), m.face_pos.cpu().numpy(),
        m.face_normal.cpu().numpy(), m.face_area.cpu().numpy(), times,
        traffic["flow"]).items()}
    feats = ref.initial_features(m, fields, cfg["model"])
    return m, feats, ref.statistics(feats, cfg["model"])


@torch.no_grad()
def step_from(m: ref.Mesh, feats0, weights, stats, traffic: dict, cfg: dict,
              state=None, precision: str = "f32") -> Dict[str, torch.Tensor]:
    """One step: from the initial features where ``state`` is None, else
    from the cell velocity ``state`` (C, 2) through the feedback."""
    feats = feats0 if state is None else ref.feedback(
        {"cell_velocity": state}, feats0, m)
    return ref.step(m, feats, weights, stats, cfg, traffic["dt"], precision)


@torch.no_grad()
def errors(m: ref.Mesh, feats0, traffic: dict, t: int, velocity, pressure,
           divergence, dtype=torch.float32) -> Dict[str, np.ndarray]:
    """The rollout's errors at step ``t`` (its target the state at t0 + 1 +
    t) per mesh, from the given cell velocity, cell pressure and per-cell
    divergence, computed in ``dtype`` (the control's: bf16)."""
    gt_v, gt_p = flow_at(m, (traffic["t0_step"] + 1 + t) * traffic["dt"],
                         traffic["flow"])
    ng, seg = m.num_graphs, m.cell_graph
    out = {}
    for key, pred, gt in (("velocity_error", velocity, gt_v),
                          ("pressure_error", pressure, gt_p)):
        pred, gt = pred.to(dtype), gt.to(dtype)
        out[key] = (segment_sum(((pred - gt) ** 2).sum(1), seg, ng)
                    / segment_sum((gt ** 2).sum(1), seg, ng))
    out["divergence_error"] = (
        segment_sum(divergence.reshape(-1).to(dtype) ** 2, seg, ng)
        / segment_sum(torch.ones_like(m.cell_volume, dtype=dtype), seg, ng))
    return {k: v.double().cpu().numpy() for k, v in out.items()}


def divergence_of(m: ref.Mesh, feats0, cell_flux=None, face_velocity=None):
    """The divergence metric's per-cell value from the program's output:
    the sum of a cell's signed fluxes, or the face velocity's flux balance
    with the INFLOW faces held at the targets' face velocity."""
    if cell_flux is not None:
        return cell_flux.sum(1, keepdim=True)
    uf = torch.where(m.inflow[:, None], feats0["face_y"][:, 0:2], face_velocity)
    return torch.sum(uf[m.cell_faces] * m.cell_normal
                     * m.face_area[m.cell_faces][..., None], dim=(1, 2))[:, None]


def match_rows(ref_pos: np.ndarray, ref_graph: np.ndarray, pos: np.ndarray,
               graph: np.ndarray) -> np.ndarray:
    """For each (position, graph) row of the program's, the reference row of
    the same graph at the same position (a mesh's cell centres, and its
    face centres, are distinct); raises where a row has no partner within
    1e-6."""
    from scipy.spatial import cKDTree
    out = np.empty(pos.shape[0], np.int64)
    for g in np.unique(ref_graph):
        ridx = np.nonzero(ref_graph == g)[0]
        pidx = np.nonzero(graph == g)[0]
        d, j = cKDTree(ref_pos[ridx]).query(pos[pidx])
        if pidx.size != ridx.size or d.max(initial=0.0) > 1e-6:
            raise ValueError(f"mesh {g}: the program's rows do not match the "
                             f"reference's ({pidx.size} against {ridx.size} "
                             f"rows, farthest {d.max(initial=0.0):.3g})")
        out[pidx] = ridx[j]
    return out


def face_graph(m: ref.Mesh) -> torch.Tensor:
    """The mesh each face belongs to (the graph of its owner cell)."""
    return m.cell_graph[m.owner]
