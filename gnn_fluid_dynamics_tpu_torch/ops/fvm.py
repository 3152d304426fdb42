"""Finite-volume numerics used by the rollouts (counterpart of
``ops/fvm.py``). The owner/neighbour sign bookkeeping is the precomputed
``cell_face_sign`` table, so each conversion is a plain gather."""

from __future__ import annotations

import torch


def divergence_from_cell_flux(cell_flux: torch.Tensor) -> torch.Tensor:
    """Sum of per-cell signed local fluxes (reference ``fvm.py:13-19``).
    cell_flux: (C, 3) -> (C, 1)."""
    return torch.sum(cell_flux, dim=1, keepdim=True)


def divergence_from_uf(face_velocity: torch.Tensor, cell_normal: torch.Tensor,
                       face_area: torch.Tensor, face_index: torch.Tensor
                       ) -> torch.Tensor:
    """Divergence of a face-velocity field: sum_k (u_{f_k} . n_k) A_{f_k}
    over each cell's 3 faces with outward cell normals (reference
    ``fvm.py:26-37``). face_velocity: (F, 2), cell_normal: (C, 3, 2),
    face_area: (F, 1) or (F,), face_index: (3, C) -> (C, 1)."""
    area = face_area.reshape(-1)
    uf = face_velocity[face_index.T]                # (C, 3, 2)
    af = area[face_index.T][..., None]              # (C, 3, 1)
    return torch.sum(uf * cell_normal * af, dim=(1, 2))[:, None]


def face_flux_to_cell_flux(face_flux: torch.Tensor, face_index: torch.Tensor,
                           cell_face_sign: torch.Tensor) -> torch.Tensor:
    """Owner-oriented face flux -> signed per-cell local flux.
    face_flux: (F, 1) or (F,) -> (C, 3, 1)."""
    ff = face_flux.reshape(-1)
    return (ff[face_index.T] * cell_face_sign)[..., None]


def face_flux_to_cell_flux_g(face_flux: torch.Tensor, graph) -> torch.Tensor:
    """Graph-aware :func:`face_flux_to_cell_flux` (the JAX package's banded
    selector variant is a TPU device; on the card it is the row gather)."""
    return face_flux_to_cell_flux(face_flux, graph.face_index,
                                  graph.cell_face_sign)


def divergence_from_uc(cell_velocity: torch.Tensor, weights: torch.Tensor,
                       neighbours: torch.Tensor, cell_volume: torch.Tensor
                       ) -> torch.Tensor:
    """MLS divergence of a cell-velocity field, scaled by the cell volume
    (reference ``fvm.py:40-52``). cell_velocity: (C, 2), weights: (C, K, 2)
    (:func:`~gnn_fluid_dynamics_tpu_torch.ops.mls.compute_mls_weights`),
    neighbours: (C, K) -> (C, 1)."""
    ux, uy = cell_velocity[:, 0], cell_velocity[:, 1]
    nb = neighbours.long()
    grad_x = torch.sum(weights[:, :, 0] * (ux[nb] - ux[:, None]), dim=1)
    grad_y = torch.sum(weights[:, :, 1] * (uy[nb] - uy[:, None]), dim=1)
    return (grad_x + grad_y)[:, None] * cell_volume.reshape(-1, 1)
