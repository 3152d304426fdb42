"""Feature transforms used by the rollout (counterpart of
``models/transforms.py``)."""

from __future__ import annotations

from typing import Tuple

import torch

from gnn_fluid_dynamics_tpu_torch.data.node_types import NodeType


def calc_face_velocity_change(cell_velocity: torch.Tensor,
                              cell_edge_index: torch.Tensor) -> torch.Tensor:
    """v[owner] - v[neighbour] per face (reference ``transforms.py:9-11``)."""
    return cell_velocity[cell_edge_index[0]] - cell_velocity[cell_edge_index[1]]


def calc_cell_edge_vector(cell_pos: torch.Tensor,
                          cell_edge_index: torch.Tensor) -> torch.Tensor:
    """pos[owner] - pos[neighbour] per face (reference ``transforms.py:13-14``)."""
    return cell_pos[cell_edge_index[0]] - cell_pos[cell_edge_index[1]]


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
    onehot = torch.nn.functional.one_hot(
        graph.face_type.reshape(-1).long(), num_types).to(dv.dtype)
    face_x = torch.cat([dv, ev, graph.face_area, onehot], dim=1)
    return face_x, bc_mask
