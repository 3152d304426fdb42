"""Mesh-geometry ops (counterpart of ``ops/geometry.py``): the cell->face
interpolation on tensors, and the host-side k-nearest-neighbour search of
the MLS stencils in numpy."""

from __future__ import annotations

import numpy as np
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


# rows of the distance matrix knn holds at a time
KNN_ROWS_PER_CHUNK = 1024


def knn(pos: np.ndarray, k: int, mask: np.ndarray = None):
    """k nearest neighbours excluding self (numpy, host preprocessing;
    reference ``geometry.py:500-518``), the JAX package's ``knn`` computed
    KNN_ROWS_PER_CHUNK rows at a time: each row's distances are the same
    values, so the result is identical and the memory is O(chunk x N).

    Returns (neighbours (N, k) int64, distances (N, k) float64). Rows that
    ``mask`` leaves out are never selected as neighbours."""
    pos = np.asarray(pos, dtype=np.float64)
    n = pos.shape[0]
    idx = np.empty((n, k), np.int64)
    dist = np.empty((n, k), np.float64)
    keep = None if mask is None else np.asarray(mask, bool)
    for lo in range(0, n, KNN_ROWS_PER_CHUNK):
        hi = min(n, lo + KNN_ROWS_PER_CHUNK)
        d = np.linalg.norm(pos[lo:hi, None, :] - pos[None, :, :], axis=-1)
        d[np.arange(hi - lo), np.arange(lo, hi)] = np.inf
        if keep is not None:
            d[:, ~keep] = np.inf
        part = np.argpartition(d, kth=k - 1, axis=1)[:, :k]
        pd = np.take_along_axis(d, part, axis=1)
        order = np.argsort(pd, axis=1, kind="stable")
        idx[lo:hi] = np.take_along_axis(part, order, axis=1)
        dist[lo:hi] = np.take_along_axis(pd, order, axis=1)
    return idx, dist
