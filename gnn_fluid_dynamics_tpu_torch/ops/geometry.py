"""Mesh-geometry ops on tensors (counterpart of ``ops/geometry.py``)."""

from __future__ import annotations

import torch


def cell_to_face(cell_values: torch.Tensor, cell_edge_index: torch.Tensor,
                 face_pos: torch.Tensor, cell_pos: torch.Tensor) -> torch.Tensor:
    """Inverse-distance-weighted cell->face interpolation (reference
    ``geometry.py:460-491``). Boundary faces (owner == neighbour) take the
    owner cell value only."""
    c0 = cell_edge_index[0]
    c1 = cell_edge_index[1]
    d0 = torch.linalg.norm(face_pos - cell_pos[c0], dim=1)
    d1 = torch.linalg.norm(face_pos - cell_pos[c1], dim=1)
    w0 = 1.0 / (d0 + 1e-10)
    w1 = torch.where(c0 == c1, torch.zeros_like(d1), 1.0 / (d1 + 1e-10))
    total = w0 + w1
    w0, w1 = w0 / total, w1 / total
    return w0[:, None] * cell_values[c0] + w1[:, None] * cell_values[c1]
