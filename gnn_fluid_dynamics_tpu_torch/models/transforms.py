"""Feature transforms (counterpart of ``models/transforms.py``): the face
features of the rollout, and training's noise and random edge flip. The
random draws come from an explicit ``torch.Generator`` on the tensors'
device, where the JAX package takes a PRNG key; on a space-sharded graph
they are drawn at the global row count and cut to the rank's rows
(:func:`~gnn_fluid_dynamics_tpu_torch.parallel.halo.draw`)."""

from __future__ import annotations

from typing import Tuple

import torch

from gnn_fluid_dynamics_tpu_torch.data.node_types import NodeType
from gnn_fluid_dynamics_tpu_torch.parallel import halo


def add_noise(generator: torch.Generator, x: torch.Tensor, std) -> torch.Tensor:
    """Gaussian training noise (reference ``transforms.py:19-22``)."""
    return x + std * halo.draw(torch.randn, x.shape, generator, x.device,
                               x.dtype)


def random_edge_flip(generator: torch.Generator, graph):
    """Random per-face orientation flip: each live face flipped with
    probability 1/2 (the JAX package's ``bernoulli(key, 0.5) & face_mask``),
    applied by :func:`flip_edges`. Returns (new_graph, safe_flip_mask)."""
    flip = (halo.draw(torch.rand, (graph.num_faces,), generator, graph.device)
            < 0.5) & halo.live_faces(graph)
    return flip_edges(graph, flip)


def flip_edges(graph, flip: torch.Tensor):
    """The faces ``flip`` (F,) bool turned around (reference
    ``transforms.py:3-7`` swaps the ``cell_edge_index`` columns; the models
    then flip ``face_normal`` and ``face_flux`` of the non-boundary flipped
    faces, ``Fvgn.py:111-114``, ``Flux.py:70-74``). The precomputed
    ``cell_face_sign`` table (ownership) flips with them, and
    ``owner_local_slot`` becomes the face's slot in its new owner. Returns
    (new_graph, safe_flip_mask): the flipped faces that are not boundary
    self-loops."""
    cei = graph.cell_edge_index
    # the graph's own record, which a space-sharded graph keeps for a ghost
    # face whose cells it does not hold
    safe = flip & ~graph.face_boundary_mask
    cei = torch.where(flip[None, :], cei.flip(0), cei)
    sgn = torch.where(safe, -1.0, 1.0).to(graph.face_normal.dtype)
    updates = dict(
        cell_edge_index=cei,
        face_normal=graph.face_normal * sgn[:, None],
        cell_face_sign=graph.cell_face_sign * sgn[graph.face_index.T],
    )
    if graph.face_flux is not None:
        updates["face_flux"] = graph.face_flux * sgn[:, None, None]
    # the new owner's slot holding the face: the first slot that matches
    owner_faces = graph.face_index[:, cei[0]]                 # (3, F)
    face_ids = torch.arange(graph.num_faces, device=graph.device)[None, :]
    updates["owner_local_slot"] = torch.argmax(
        (owner_faces == face_ids).to(torch.int32), dim=0).to(torch.int32)
    return graph.replace(**updates), safe


def calc_face_velocity_change(cell_velocity: torch.Tensor,
                              cell_edge_index: torch.Tensor) -> torch.Tensor:
    """v[owner] - v[neighbour] per face (reference ``transforms.py:9-11``)."""
    return cell_velocity[cell_edge_index[0]] - cell_velocity[cell_edge_index[1]]


def calc_cell_edge_vector(cell_pos: torch.Tensor,
                          cell_edge_index: torch.Tensor) -> torch.Tensor:
    """pos[owner] - pos[neighbour] per face (reference ``transforms.py:13-14``)."""
    return cell_pos[cell_edge_index[0]] - cell_pos[cell_edge_index[1]]


def calc_face_type_one_hot(face_type: torch.Tensor,
                           num_classes: int) -> torch.Tensor:
    """One-hot face types, f32 (F, num_classes)."""
    return torch.nn.functional.one_hot(face_type.reshape(-1).long(),
                                       num_classes).to(torch.float32)


def interior_face_mask(face_type: torch.Tensor) -> torch.Tensor:
    """Interior = NORMAL|OUTFLOW|SLIP|WALL, so the bc mask marks INFLOW faces
    only (reference ``Fvgn.py:117-119``)."""
    ft = face_type.reshape(-1)
    return ((ft == NodeType.NORMAL) | (ft == NodeType.OUTFLOW)
            | (ft == NodeType.SLIP) | (ft == NodeType.WALL_BOUNDARY))


def rollout_bc_mask(face_type: torch.Tensor) -> torch.Tensor:
    """Faces clamped to ground-truth BCs during rollout: INFLOW | WALL
    (reference ``Fvgn.py:142-144``)."""
    ft = face_type.reshape(-1)
    return (ft == NodeType.INFLOW) | (ft == NodeType.WALL_BOUNDARY)


def standard_face_features(graph, cell_velocity: torch.Tensor, num_types: int,
                           bc_velocity: torch.Tensor = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[Δv_f (2) | Δpos (2) | area (1) | one-hot type (num_types)], with
    INFLOW faces' Δv overwritten by ``bc_velocity`` when given
    (reference ``Fvgn.py:121-125``). Returns (face_x, bc_mask)."""
    dv = calc_face_velocity_change(cell_velocity, graph.cell_edge_index)
    bc_mask = ~interior_face_mask(graph.face_type)
    if bc_velocity is not None:
        dv = torch.where(bc_mask[:, None], bc_velocity, dv)
    ev = calc_cell_edge_vector(graph.cell_pos, graph.cell_edge_index)
    onehot = calc_face_type_one_hot(graph.face_type, num_types).to(dv.dtype)
    face_x = torch.cat([dv, ev, graph.face_area, onehot], dim=1)
    return face_x, bc_mask
