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

Every graph carries, built once on the host, the index vectors the
index-route kernels (K1-K5) read: the owner/neighbour rows of
``cell_edge_index``, the vertex rows of ``vertex_face``, and a per-vertex CSR
of edge half-rows (``vertex_inc_ptr``/``vertex_inc_row``) for the edge->vertex
sum.

With ``with_banded`` a graph also carries the banded one-hot tables of
:mod:`gnn_fluid_dynamics_tpu_torch.ops.banded` that the dense-table kernels
K6/K7 read (``es``/``er``, ``vc``, ``cf`` row/col). The JAX package tells a
graph whose GN blocks read those tables by the absence of its index vectors;
the port's graphs always have them, so the choice is the explicit marker
``table_route``: :func:`from_geometry` with ``with_banded`` sets it,
:func:`to_static_bands` with ``derive_idx`` clears it, and a graph without
tables never has it. The JAX package's ``hv`` and ``fc3`` tables feed only
its XLA banded backend; the port gathers in f32 by index there and does not
build them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from gnn_fluid_dynamics_tpu_torch import resolve_device
from gnn_fluid_dynamics_tpu_torch.ops.banded import (build_banded_tables,
                                                     pad_band_width)

BANDED_DTYPES = {"int8": torch.int8, "bfloat16": torch.bfloat16,
                 "float32": torch.float32}


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
    # --- optional MLS gradient weights (ops/mls.py): K stencil neighbours
    # per cell (face); a padded row's neighbours are the last padded row ---
    cell_grad_weights: torch.Tensor = None     # (C, K, 2)
    cell_grad_neighbours: torch.Tensor = None  # (C, K) int32
    face_grad_weights: torch.Tensor = None     # (F, K, 2)
    face_grad_neighbours: torch.Tensor = None  # (F, K) int32
    # --- banded one-hot tables (ops/banded.py), read by K6/K7: per tile t
    # of 128 target rows, columns [0, B) are the source rows
    # [*_off[t], *_off[t] + B) of the tile's own graph ---
    es_onehot: torch.Tensor = None       # (Tv, 128, Bes) edge -> vertex, send
    er_onehot: torch.Tensor = None       # (Tv, 128, Bes) edge -> vertex, recv
    vc_onehot: torch.Tensor = None       # (Tc, 128, Bvc) vertex -> cell
    cf_row_onehot: torch.Tensor = None   # (Tf, 128, Bcf) cell -> face, owner
    cf_col_onehot: torch.Tensor = None   # (Tf, 128, Bcf) cell -> face, neighbour
    # per tile, the first source row of its band: a row of the graph's own
    # source, and in a batch a row of the batched source (batch_graphs adds
    # each graph's first row once), so one kernel launch applies a table to
    # the whole batch
    es_off: torch.Tensor = None          # (Tv,) int32
    vc_off: torch.Tensor = None          # (Tc,)
    cf_off: torch.Tensor = None          # (Tf,)
    # the GN blocks read the tables (K6/K7) instead of the index vectors
    table_route: bool = False

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

    def replace(self, **updates) -> "MeshGraph":
        """A copy with the given fields replaced (``flax.struct``'s
        ``replace``)."""
        return dataclasses.replace(self, **updates)


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
    pad_to: Optional[Dict[str, int]] = None,
    with_banded: bool = False,
    banded_dtype="float32",
    band_pad: Optional[Dict[str, int]] = None,
    banded_tables=None,
    device="cuda",
) -> MeshGraph:
    """Build a single-graph MeshGraph from a numpy geometry dict.

    ``geom`` holds the keys written by ``ops.connectivity.build_geometry``.
    ``fields`` may hold time-major arrays keyed ``cell_velocity`` (W, C, 2)
    etc.; they are transposed to element-major ``(C, W, ...)``. It may also
    hold MLS weights (``cell_grad_weights`` (C, K, 2) with
    ``cell_grad_neighbours`` (C, K), likewise ``face_*``), padded as the JAX
    package pads them.

    Padding: if ``pad_multiple > 0``, each element axis is padded up to the
    next multiple; ``pad_to`` gives exact sizes ``{"cell": C', "face": F',
    "vertex": V'}`` instead. Float arrays are f32. The tensors are placed on
    ``device`` (raises without a card unless ``device="cpu"``).

    ``with_banded`` adds the banded tables (``banded_tables``, or built from
    ``geom``) in ``banded_dtype`` (``"int8"``, ``"bfloat16"`` or
    ``"float32"``), each band width widened to ``band_pad[group]`` where
    given, and puts the graph on the table route.
    """
    dev = resolve_device(device)
    fields = fields or {}
    C = int(geom["cell_pos"].shape[0])
    F = int(geom["face_pos"].shape[0])
    V = int(geom["vertex_pos"].shape[0])

    if pad_to is not None:
        Cp, Fp, Vp = pad_to["cell"], pad_to["face"], pad_to["vertex"]
    elif pad_multiple:
        Cp, Fp, Vp = (_round_up(C, pad_multiple), _round_up(F, pad_multiple),
                      _round_up(V, pad_multiple))
    else:
        Cp, Fp, Vp = C, F, V
    if Cp < C or Fp < F or Vp < V:
        raise ValueError(f"pad_to {(Cp, Fp, Vp)} is below the mesh's "
                         f"{(C, F, V)}")

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

    grad = {}
    for loc, n, npad in (("cell", C, Cp), ("face", F, Fp)):
        wkey, nkey = f"{loc}_grad_weights", f"{loc}_grad_neighbours"
        if wkey in fields:
            grad[wkey] = f32(padf(fields[wkey], npad))
            grad[nkey] = t(padf(fields[nkey], npad,
                                value=npad - 1 if npad > n else 0
                                ).astype(np.int32))
    inc_ptr, inc_row = vertex_incidence_csr(vertex_edge_index, Vp)
    ft = np.asarray(geom["face_type"]).reshape(-1, 1)
    tables = {}
    if with_banded:
        tables = _banded_fields(geom, (Cp, Fp, Vp), banded_dtype, band_pad,
                                banded_tables, dev)
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
        **grad,
        **tables,
    )


# table group -> (one-hot fields, which padded count is its source count)
_GROUPS = (("es", ("es_onehot", "er_onehot"), "face"),
           ("vc", ("vc_onehot",), "vertex"),
           ("cf", ("cf_row_onehot", "cf_col_onehot"), "cell"))


def _check_bands(group: str, off: np.ndarray, B: int, S: int) -> None:
    """Every band lies inside its graph's S source rows: the kernels read
    source rows by band offset without bounds checks."""
    if len(off) and (int(np.min(off)) < 0 or int(np.max(off)) + B > S):
        raise ValueError(f"{group} bands run past the {S} source rows "
                         f"(largest offset {int(np.max(off))}, width {B})")


def _banded_fields(geom, pads, banded_dtype, band_pad, banded_tables,
                   dev) -> dict:
    Cp, Fp, Vp = pads
    if Cp % 128 or Fp % 128 or Vp % 128:
        raise ValueError("banded tables need 128-divisible padding")
    dtype = BANDED_DTYPES.get(banded_dtype, banded_dtype)
    if dtype not in BANDED_DTYPES.values():
        raise ValueError(f"banded_dtype {banded_dtype!r} is not one of "
                         f"{tuple(BANDED_DTYPES)}")
    tables = banded_tables or banded_tables_for(
        geom, {"cell": Cp, "face": Fp, "vertex": Vp})
    sources = {"cell": Cp, "face": Fp, "vertex": Vp}
    bp = band_pad or {}
    out = {}
    for group, keys, src in _GROUPS:
        off = tuple(getattr(tables, f"{group}_offsets"))
        B = bp.get(group, getattr(tables, keys[0]).shape[2])
        _check_bands(group, np.asarray(off), B, sources[src])
        for key in keys:
            oh = pad_band_width(getattr(tables, key), B)
            out[key] = torch.from_numpy(np.ascontiguousarray(oh)).to(dtype).to(dev)
        out[f"{group}_off"] = torch.tensor(off, dtype=torch.int32, device=dev)
    out["table_route"] = True
    return out


def banded_tables_for(geom: Dict[str, np.ndarray], pad_to: Dict[str, int]):
    """Banded tables for ``geom`` padded to ``pad_to`` sizes, with the padding
    convention of :func:`from_geometry` (padded entries point at the last
    slot), so the band widths match what the padded graph needs."""
    C = geom["cell_pos"].shape[0]
    F = geom["face_pos"].shape[0]
    V = geom["vertex_pos"].shape[0]
    Cp, Fp, Vp = pad_to["cell"], pad_to["face"], pad_to["vertex"]

    def padi(x, n, value):
        x = np.asarray(x)
        if x.shape[1] == n:
            return x
        return np.pad(x, ((0, 0), (0, n - x.shape[1])),
                      constant_values=value)

    padded_geom = {
        "vertex_pos": np.zeros((Vp, 2)),
        "cell_pos": np.zeros((Cp, 2)),
        "vertex_edge_index": padi(geom["vertex_edge_index"], Fp,
                                  Vp - 1 if Vp > V else 0),
        "vertex_face": padi(geom["vertex_face"], Cp,
                            Vp - 1 if Vp > V else 0),
        "cell_edge_index": padi(geom["cell_edge_index"], Fp,
                                Cp - 1 if Cp > C else 0),
    }
    return build_banded_tables(padded_geom)


def to_static_bands(graph: MeshGraph, derive_idx: bool = True) -> MeshGraph:
    """Choose the route of a graph with tables: with ``derive_idx`` it goes
    on the index route (the JAX package derives its index vectors here; the
    port's graphs always have them), without it it stays where it is (the
    trainer's validation graph stays on the table route). The JAX package
    also bakes the band offsets into static specs here for its compiler;
    the port's kernels read them from ``*_off``. A graph without tables is
    returned as it is."""
    if derive_idx and graph.table_route:
        return dataclasses.replace(graph, table_route=False)
    return graph


FIELD_KEYS = ("cell_velocity", "cell_pressure", "face_velocity",
              "face_pressure", "face_flux")


def batch_graphs(graphs: Sequence[MeshGraph]) -> MeshGraph:
    """Concatenate same-shape MeshGraphs into one batched graph.

    Element arrays concatenate, index arrays are offset by the element counts
    before them (the MLS stencils' neighbours too), ``cell_batch``/
    ``face_batch`` record graph membership, and ``dt``/``reynolds`` become
    (n,) vectors. Banded tables are widened to the
    batch's widest band (:func:`widen_band`) and their tiles concatenated;
    ``*_off`` gains each graph's first source row.
    """
    if not graphs:
        raise ValueError("no graphs to batch")
    if len(graphs) == 1:
        return graphs[0]
    g0 = graphs[0]
    C, F, V = g0.num_cells, g0.num_faces, g0.num_vertices
    for g in graphs:
        if (g.num_cells, g.num_faces, g.num_vertices) != (C, F, V):
            raise ValueError("batch_graphs needs graphs of one padded shape")
        if g.table_route != g0.table_route:
            raise ValueError("batch_graphs needs graphs on one route")
    n = len(graphs)
    dev = g0.device

    def cat(key, per=None, axis=0):
        vals = [getattr(g, key) for g in graphs]
        if per is not None:
            vals = [v + i * per for i, v in enumerate(vals)]
        return torch.cat(vals, dim=axis)

    kwargs = dict(
        cell_pos=cat("cell_pos"),
        cell_volume=cat("cell_volume"),
        cell_normal=cat("cell_normal"),
        cell_edge_index=cat("cell_edge_index", C, axis=1),
        cell_face_sign=cat("cell_face_sign"),
        face_pos=cat("face_pos"),
        face_area=cat("face_area"),
        face_normal=cat("face_normal"),
        face_type=cat("face_type"),
        face_index=cat("face_index", F, axis=1),
        owner_local_slot=cat("owner_local_slot"),
        vertex_pos=cat("vertex_pos"),
        vertex_edge_index=cat("vertex_edge_index", V, axis=1),
        vertex_face=cat("vertex_face", V, axis=1),
        cell_mask=cat("cell_mask"),
        face_mask=cat("face_mask"),
        vertex_mask=cat("vertex_mask"),
        face_boundary_mask=cat("face_boundary_mask"),
        cell_batch=torch.repeat_interleave(
            torch.arange(n, dtype=torch.int32, device=dev), C),
        face_batch=torch.repeat_interleave(
            torch.arange(n, dtype=torch.int32, device=dev), F),
        # each graph's CSR holds all of its 2F half-rows, in its own vertex
        # order: the batched CSR chains them
        vertex_inc_ptr=torch.cat([g0.vertex_inc_ptr] + [
            g.vertex_inc_ptr[1:] + i * 2 * F for i, g in enumerate(graphs)
            if i > 0]),
        vertex_inc_row=cat("vertex_inc_row", 2 * F),
        num_graphs=n,
        dt=torch.stack([g.dt.reshape(()) for g in graphs]),
        reynolds=torch.stack([g.reynolds.reshape(()) for g in graphs]),
        table_route=g0.table_route,
    )
    for key in FIELD_KEYS + ("cell_grad_weights", "face_grad_weights"):
        kwargs[key] = None if getattr(g0, key) is None else cat(key)
    for key, per in (("cell_grad_neighbours", C), ("face_grad_neighbours", F)):
        kwargs[key] = None if getattr(g0, key) is None else cat(key, per)
    sources = {"cell": C, "face": F, "vertex": V}
    for group, keys, src in (_GROUPS if g0.es_onehot is not None else ()):
        S = sources[src]
        B = max(getattr(g, keys[0]).shape[2] for g in graphs)
        offs, tables = [], {key: [] for key in keys}
        for i, g in enumerate(graphs):
            off = getattr(g, f"{group}_off")
            for key in keys:
                oh, new_off = widen_band(getattr(g, key), off, B, S)
                tables[key].append(oh)
            _check_bands(group, new_off.cpu().numpy(), B, S)
            offs.append(new_off + i * S)
        for key in keys:
            kwargs[key] = torch.cat(tables[key])
        kwargs[f"{group}_off"] = torch.cat(offs)
    return MeshGraph(**kwargs)


def widen_band(oh: torch.Tensor, off: torch.Tensor, B: int, S: int):
    """A table widened to band width ``B``, and its offsets: a tile whose
    wider band would run past the S source rows starts lower, its columns
    shifted right by as much, so that each tile still reads the same rows."""
    T, tile, Bg = oh.shape
    if Bg == B:
        return oh, off
    new_off = torch.clamp(off, max=S - B)
    cols = (off - new_off).long()[:, None, None] + torch.arange(
        Bg, device=oh.device)
    return oh.new_zeros(T, tile, B).scatter_(2, cols.expand(T, tile, Bg),
                                             oh), new_off
