"""The core mesh-graph data structure, as torch tensors.

Counterpart of ``gnn_fluid_dynamics_tpu/graph.py``, with the same padding and
index conventions:

* ``F`` faces == vertex edges (a triangular 2-D mesh's faces are its edges).
* ``cell_edge_index`` has shape ``(2, F)`` = ``[owner, neighbour]`` per face;
  boundary faces are self-loops ``[c, c]``.
* ``face_index`` has shape ``(3, C)``: the 3 global face ids of each cell.
* ``vertex_face`` has shape ``(3, C)``: the 3 vertex ids of each cell.
* ``cell_normal`` ``(C, 3, 2)``, ``cell_face_sign`` ``(C, 3)`` and
  ``owner_local_slot`` ``(F,)`` are the precomputed flux tables.

Padded elements point at the *last* (padded) slot of their target axis and are
zeroed by the masks, so gathers stay in-bounds and sums accumulate into a
discarded slot.

The JAX package's banded one-hot tables exist only to avoid row gathers on the
TPU; the port does not build them. It builds instead, once on the host, the
index vectors the GN-block kernels read: the owner/neighbour rows of
``cell_edge_index``, the vertex rows of ``vertex_face``, and a per-vertex CSR
of edge half-rows (``vertex_inc_ptr``/``vertex_inc_row``) for the edge->vertex
sum.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from gnn_fluid_dynamics_tpu_torch import resolve_device


@dataclasses.dataclass
class MeshGraph:
    """A single (possibly padded) triangular mesh graph sample."""

    # --- geometry: cells ---
    cell_pos: torch.Tensor          # (C, 2)
    cell_volume: torch.Tensor       # (C, 1)
    cell_normal: torch.Tensor       # (C, 3, 2) outward unit normals of local faces
    cell_edge_index: torch.Tensor   # (2, F) int32 [owner, neighbour]
    cell_face_sign: torch.Tensor    # (C, 3) float  +1 owner / -1 neighbour / 0 pad
    # --- geometry: faces (== vertex edges) ---
    face_pos: torch.Tensor          # (F, 2)
    face_area: torch.Tensor         # (F, 1)
    face_normal: torch.Tensor       # (F, 2) unit, oriented owner -> neighbour
    face_type: torch.Tensor         # (F, 1) int32 NodeType codes
    face_index: torch.Tensor        # (3, C) int32 global face ids per cell
    owner_local_slot: torch.Tensor  # (F,) int32 local slot of face in owner cell
    # --- geometry: vertices ---
    vertex_pos: torch.Tensor        # (V, 2)
    vertex_edge_index: torch.Tensor  # (2, F) int32 [sender, receiver]
    vertex_face: torch.Tensor       # (3, C) int32 vertex ids per cell
    # --- masks (padding validity) ---
    cell_mask: torch.Tensor         # (C,) bool
    face_mask: torch.Tensor         # (F,) bool
    vertex_mask: torch.Tensor       # (V,) bool
    face_boundary_mask: torch.Tensor  # (F,) bool  owner == neighbour
    # --- batching ---
    cell_batch: torch.Tensor        # (C,) int32 graph id per cell
    face_batch: torch.Tensor        # (F,) int32 graph id per face
    # --- edge->vertex CSR: vertex v sums the half-rows
    # vertex_inc_row[vertex_inc_ptr[v]:vertex_inc_ptr[v+1]] of the (2F, H/2)
    # view of the edge latents; half-row 2f is the forward half of face f
    # (summed at its sender), 2f+1 the reverse half (summed at its receiver)
    vertex_inc_ptr: torch.Tensor    # (V+1,) int32
    vertex_inc_row: torch.Tensor    # (2F,) int32
    num_graphs: int = 1
    # --- meta ---
    dt: torch.Tensor = None         # () timestep
    reynolds: torch.Tensor = None   # ()
    # --- time-windowed fields (W = data window) ---
    cell_velocity: torch.Tensor = None   # (C, W, 2)
    cell_pressure: torch.Tensor = None   # (C, W, 1)
    face_velocity: torch.Tensor = None   # (F, W, 2)
    face_pressure: torch.Tensor = None   # (F, W, 1)
    face_flux: torch.Tensor = None       # (F, W, 1)

    @property
    def num_cells(self) -> int:
        return self.cell_pos.shape[0]

    @property
    def num_faces(self) -> int:
        return self.face_pos.shape[0]

    @property
    def num_vertices(self) -> int:
        return self.vertex_pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.cell_pos.device


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def vertex_incidence_csr(vertex_edge_index: np.ndarray, num_vertices: int):
    """(ptr (V+1,), half_row (2F,)) int32: each vertex's edge half-rows,
    senders' forward halves first, then receivers' reverse halves, each in
    face order — the order of ``ops/segment.py::build_vertex_incidence``."""
    senders, receivers = np.asarray(vertex_edge_index, np.int64)
    F = senders.shape[0]
    vertex = np.concatenate([senders, receivers])
    half_row = np.concatenate([2 * np.arange(F), 2 * np.arange(F) + 1])
    order = np.argsort(vertex, kind="stable")
    counts = np.bincount(vertex, minlength=num_vertices)
    ptr = np.concatenate([[0], np.cumsum(counts)])
    return ptr.astype(np.int32), half_row[order].astype(np.int32)


def from_geometry(
    geom: Dict[str, np.ndarray],
    fields: Optional[Dict[str, np.ndarray]] = None,
    dt: float = 0.01,
    reynolds: float = 0.0,
    pad_multiple: int = 0,
    device="cuda",
) -> MeshGraph:
    """Build a single-graph MeshGraph from a numpy geometry dict.

    ``geom`` holds the keys written by ``ops.connectivity.build_geometry``.
    ``fields`` may hold time-major arrays keyed ``cell_velocity`` (W, C, 2)
    etc.; they are transposed to element-major ``(C, W, ...)``.

    Padding: if ``pad_multiple > 0``, each element axis is padded up to the
    next multiple. Float arrays are f32. The tensors are placed on
    ``device`` (raises without a card unless ``device="cpu"``).
    """
    dev = resolve_device(device)
    fields = fields or {}
    C = int(geom["cell_pos"].shape[0])
    F = int(geom["face_pos"].shape[0])
    V = int(geom["vertex_pos"].shape[0])

    if pad_multiple:
        Cp, Fp, Vp = (_round_up(C, pad_multiple), _round_up(F, pad_multiple),
                      _round_up(V, pad_multiple))
    else:
        Cp, Fp, Vp = C, F, V

    def padf(x, n, axis=0, value=0.0):
        x = np.asarray(x)
        if x.shape[axis] == n:
            return x
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, n - x.shape[axis])
        return np.pad(x, widths, constant_values=value)

    # padded index arrays point at the last (padded) slot
    pad_cell = Cp - 1 if Cp > C else 0
    pad_face = Fp - 1 if Fp > F else 0
    pad_vertex = Vp - 1 if Vp > V else 0

    cell_edge_index = padf(geom["cell_edge_index"], Fp, axis=1,
                           value=pad_cell).astype(np.int32)
    vertex_edge_index = padf(geom["vertex_edge_index"], Fp, axis=1,
                             value=pad_vertex).astype(np.int32)
    face_index = padf(geom["face_index"], Cp, axis=1,
                      value=pad_face).astype(np.int32)
    vertex_face = padf(geom["vertex_face"], Cp, axis=1,
                       value=pad_vertex).astype(np.int32)
    owner_local_slot = padf(geom["owner_local_slot"], Fp,
                            value=0).astype(np.int32)
    # the kernels gather rows by these indices without bounds checks
    for name, idx, n in (("cell_edge_index", cell_edge_index, Cp),
                         ("vertex_edge_index", vertex_edge_index, Vp),
                         ("face_index", face_index, Fp),
                         ("vertex_face", vertex_face, Vp)):
        if idx.size and (idx.min() < 0 or idx.max() >= n):
            raise ValueError(f"{name} holds ids outside [0, {n})")

    cell_mask = np.zeros(Cp, bool)
    cell_mask[:C] = True
    face_mask = np.zeros(Fp, bool)
    face_mask[:F] = True
    vertex_mask = np.zeros(Vp, bool)
    vertex_mask[:V] = True

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def f32(x):
        return t(np.asarray(x, np.float32))

    def field_arr(key, n_elem, n_pad):
        if key not in fields:
            return None
        x = np.asarray(fields[key], dtype=np.float32)
        if x.ndim == 2:
            x = x[..., None]
        x = np.transpose(x, (1, 0, 2))       # time-major -> element-major
        if x.shape[0] != n_elem:
            raise ValueError(f"{key}: {x.shape} does not match {n_elem} elements")
        return f32(padf(x, n_pad))

    inc_ptr, inc_row = vertex_incidence_csr(vertex_edge_index, Vp)
    ft = np.asarray(geom["face_type"]).reshape(-1, 1)
    return MeshGraph(
        cell_pos=f32(padf(geom["cell_pos"], Cp)),
        cell_volume=f32(padf(np.asarray(geom["cell_volume"]).reshape(-1, 1), Cp)),
        cell_normal=f32(padf(geom["cell_normal"], Cp)),
        cell_edge_index=t(cell_edge_index),
        cell_face_sign=f32(padf(geom["cell_face_sign"], Cp)),
        face_pos=f32(padf(geom["face_pos"], Fp)),
        face_area=f32(padf(np.asarray(geom["face_area"]).reshape(-1, 1), Fp)),
        face_normal=f32(padf(geom["face_normal"], Fp)),
        face_type=t(padf(ft, Fp).astype(np.int32)),
        face_index=t(face_index),
        owner_local_slot=t(owner_local_slot),
        vertex_pos=f32(padf(geom["vertex_pos"], Vp)),
        vertex_edge_index=t(vertex_edge_index),
        vertex_face=t(vertex_face),
        cell_mask=t(cell_mask),
        face_mask=t(face_mask),
        vertex_mask=t(vertex_mask),
        face_boundary_mask=t(padf(np.asarray(
            geom["face_boundary_mask"]).reshape(-1).astype(bool), Fp)),
        cell_batch=torch.zeros(Cp, dtype=torch.int32, device=dev),
        face_batch=torch.zeros(Fp, dtype=torch.int32, device=dev),
        vertex_inc_ptr=t(inc_ptr),
        vertex_inc_row=t(inc_row),
        num_graphs=1,
        dt=torch.tensor(dt, dtype=torch.float32, device=dev),
        reynolds=torch.tensor(reynolds, dtype=torch.float32, device=dev),
        cell_velocity=field_arr("cell_velocity", C, Cp),
        cell_pressure=field_arr("cell_pressure", C, Cp),
        face_velocity=field_arr("face_velocity", F, Fp),
        face_pressure=field_arr("face_pressure", F, Fp),
        face_flux=field_arr("face_flux", F, Fp),
    )
