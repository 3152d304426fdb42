"""Finite-volume numerics used by the models (counterpart of
``ops/fvm.py``). The owner/neighbour sign bookkeeping is the precomputed
``cell_face_sign`` table, so each conversion is a plain gather."""

from __future__ import annotations

import torch

from gnn_fluid_dynamics_tpu_torch.parallel import halo


def divergence_from_face_flux(face_flux: torch.Tensor,
                              face_index: torch.Tensor) -> torch.Tensor:
    """Sum of the (owner-oriented, unsigned) flux over each cell's 3 faces
    (reference ``fvm.py:4-10``). face_flux: (F, 1) -> (C, 1)."""
    return (face_flux[face_index[0]] + face_flux[face_index[1]]
            + face_flux[face_index[2]])


def divergence_from_cell_flux(cell_flux: torch.Tensor) -> torch.Tensor:
    """Sum of per-cell signed local fluxes (reference ``fvm.py:13-19``).
    cell_flux: (C, 3) -> (C, 1)."""
    return torch.sum(cell_flux, dim=1, keepdim=True)


def calc_flux_from_uf(face_velocity: torch.Tensor, face_normal: torch.Tensor,
                      face_area: torch.Tensor) -> torch.Tensor:
    """phi_f = (u_f . n_f) A_f (reference ``fvm.py:22-23``). -> (F, 1)."""
    return (torch.sum(face_velocity * face_normal, dim=-1, keepdim=True)
            * face_area.reshape(-1, 1))


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


def cell_flux_to_face_flux(cell_flux: torch.Tensor,
                           cell_edge_index: torch.Tensor,
                           owner_local_slot: torch.Tensor) -> torch.Tensor:
    """Per-cell local flux -> owner-oriented face flux: each face takes its
    owner cell's value at the face's slot (reference ``fvm.py:55-94``, the
    slot search precomputed as ``owner_local_slot``).
    cell_flux: (C, 3) or (C, 3, 1) -> (F, 1)."""
    cf = cell_flux.reshape(cell_flux.shape[0], 3)
    return cf[cell_edge_index[0].long(), owner_local_slot.long()][:, None]


def cell_flux_to_face_flux_lastwrite(cell_flux: torch.Tensor,
                                     cell_edge_index: torch.Tensor,
                                     face_index: torch.Tensor) -> torch.Tensor:
    """The reference's ``geometry.cell_flux_to_face_flux``
    (geometry.py:539-570) with its index pairing kept as it is: write ``k``
    of 3C goes to face ``face_index[k // C, k % C]`` (the slot-major
    flatten) and carries ``cell_flux[k // 3, k % 3]`` (cell-major), negated
    unless cell ``k // 3`` owns that face. Where several writes reach one
    face the last one in ``k`` wins, as torch's scatter assignment leaves
    it on the CPU; here the winner is the largest ``k`` by a deterministic
    ``scatter_reduce("amax")``, never an indexed assignment, whose
    duplicates land in no defined order on the card. A face no write
    reaches takes write 0's value (the JAX package's clip).
    cell_flux: (C, 3) or (C, 3, 1) -> (F, 1)."""
    cf = cell_flux.reshape(cell_flux.shape[0], 3)
    C = cf.shape[0]
    F = cell_edge_index.shape[1]
    k = torch.arange(3 * C, device=cf.device)
    dest = face_index[k // C, k % C].long()
    owner = cell_edge_index[0].long()[dest] == k // 3
    vals = cf.reshape(-1)
    corrected = torch.where(owner, vals, -vals)
    kwin = torch.full((F,), -1, dtype=k.dtype, device=cf.device)
    kwin = kwin.scatter_reduce(0, dest, k, "amax")
    return corrected[kwin.clamp(0, 3 * C - 1)][:, None]


def cell_flux_to_face_flux_lastwrite_g(cell_flux: torch.Tensor,
                                       graph) -> torch.Tensor:
    """Graph-aware :func:`cell_flux_to_face_flux_lastwrite`. On a space
    rank's local graph (``parallel/spmd.py``) the writes are the whole
    graph's: write ``k`` of 3C (C the global padded cell count) goes to the
    face ``face_index[k // C, k % C]`` and carries the flux of global cell
    ``k // 3``, which is in general no row of the rank's. The rank decides
    each owned face's last write itself: the writes that reach a face come
    from the cells on either side of it, k = slot * C + global cell, and
    both are local rows of an owned face. The values come from every
    rank's owned cells at once (``halo.all_rows``; a pad cell's from space
    rank 0's pad row, which it computes from the same inputs, as a pad
    cell's three vertices are the one pad vertex); the owner test compares
    the face's owner's global id with ``k // 3``. The ghost faces are then
    refreshed from their owners. Equal to the single process's conversion
    on the owned rows (``tests/test_torch_spmd_families.py``)."""
    h = graph.halo
    if h is None:
        return cell_flux_to_face_flux_lastwrite(cell_flux, graph.cell_edge_index,
                                                graph.face_index)
    cf = halo.all_rows(cell_flux.reshape(cell_flux.shape[0], 3), graph,
                       "cell").reshape(-1)
    C = h.global_rows["cell"]
    F = graph.num_faces
    cell_gid = h.gid["cell"]
    # every (slot, local cell) pair makes its write; a write that leaves
    # the local rows (a ghost cell's face, a pad cell's) lands on the pad
    # face, which no rank owns
    slot = torch.arange(3, device=cf.device)[:, None]
    k = (slot * C + cell_gid[None, :]).reshape(-1)
    dest = graph.face_index.long().reshape(-1)
    kwin = torch.full((F,), -1, dtype=k.dtype, device=cf.device)
    kwin = kwin.scatter_reduce(0, dest, k, "amax")
    kwin = kwin.clamp(0, 3 * C - 1)
    owner = cell_gid[graph.cell_edge_index[0].long()] == kwin // 3
    vals = cf[kwin]
    out = torch.where(owner, vals, -vals)[:, None]
    return halo.refresh(out, graph, "face")


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


def calc_gradient_tensor(value: torch.Tensor, weights: torch.Tensor,
                         neighbours: torch.Tensor) -> torch.Tensor:
    """MLS velocity-gradient tensor at faces (reference
    ``src/utils/geometry.py:520-537``). value: (F, 2), weights: (F, K, 2),
    neighbours: (F, K) -> (F, 4) as [g_xx, g_xy, g_yx, g_yy], with the
    reference's pairing kept as it is: g_xy = sum w_y * dv_y,
    g_yx = sum w_x * dv_y, g_yy = sum w_y * dv_x."""
    vx, vy = value[:, 0], value[:, 1]
    nb = neighbours.long()
    dx = vx[nb] - vx[:, None]
    dy = vy[nb] - vy[:, None]
    g_xx = torch.sum(weights[:, :, 0] * dx, dim=1)
    g_xy = torch.sum(weights[:, :, 1] * dy, dim=1)
    g_yx = torch.sum(weights[:, :, 0] * dy, dim=1)
    g_yy = torch.sum(weights[:, :, 1] * dx, dim=1)
    return torch.stack([g_xx, g_xy, g_yx, g_yy], dim=1)
