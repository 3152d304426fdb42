"""Banded one-hot aggregation tables (numpy), as the dense-table kernels read
them.

Counterpart of the table building in ``gnn_fluid_dynamics_tpu/ops/banded.py``.
After an RCM reordering every tile of 128 consecutive target rows touches only
a narrow contiguous *band* of source rows, so an aggregation is, per tile t,

    out[tile t] = onehot[t] @ src[offsets[t] : offsets[t] + B]

with ``onehot`` a dense (T, 128, B) table of incidence weights and one band
width B (a multiple of 128) for every tile. The port's kernels K6 and K7
(:mod:`gnn_fluid_dynamics_tpu_torch.ops.kernels`) read these tables.

Of the JAX module's five table groups this copy builds the three the kernels
read: ``es``/``er`` (edge -> vertex, send/receive), ``vc`` (vertex -> cell)
and ``cf`` (cell -> face, owner/neighbour). The half-edge table ``hv`` and the
face -> (cell, slot) selector ``fc3`` feed only the JAX package's XLA banded
backend, whose place the port's f32 index gathers take; so do ``_bands``,
``_bands_dynamic`` and ``banded_matmul``. The table fill runs through the
C++ builder (:mod:`gnn_fluid_dynamics_tpu_torch.native`) where its library
builds, else through ``np.add.at``: the same tables.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

TILE = 128


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _build_table(tgt: np.ndarray, src: np.ndarray, w: np.ndarray,
                 num_targets: int, num_sources: int, tile: int = TILE):
    """Generic banded table with static per-tile offsets, from flat
    (target, source, weight) triples (any order, duplicates accumulate).

    Returns (offsets (T,) python ints, onehot (T, tile, B) f32): tile t covers
    source rows [offsets[t], offsets[t] + B), with offsets[t] + B <=
    num_sources.
    """
    tgt = np.asarray(tgt, np.int64).ravel()
    src = np.asarray(src, np.int64).ravel()
    w = np.asarray(w, np.float32).ravel()
    Tn = _round_up(max(num_targets, 1), tile) // tile
    lo = np.full(Tn, num_sources, np.int64)
    hi = np.zeros(Tn, np.int64)
    tiles = tgt // tile
    np.minimum.at(lo, tiles, src)
    np.maximum.at(hi, tiles, src)
    lo = np.minimum(lo, np.maximum(hi, 0))

    # the width is measured from the 8-row-aligned starts; offsets are
    # clamped so that a band never runs past the last source row
    aligned = (lo // 8) * 8
    width = int(np.max(hi - aligned + 1)) if len(tgt) else 1
    B = min(_round_up(max(width, 1), 128), _round_up(max(num_sources, 1), 128))
    offsets = np.minimum(aligned, max(num_sources - B, 0))
    if len(tgt):
        col = src - offsets[tiles]
        if col.min() < 0 or col.max() >= B:
            raise AssertionError(
                f"banded table invariant violated: column range "
                f"[{col.min()}, {col.max()}] outside band width {B}")
    onehot = _onehot_fill(tgt, src, w, Tn, tile, B, offsets, tiles)
    return tuple(int(o) for o in offsets), onehot


def _onehot_fill(tgt, src, w, Tn, tile, B, offsets, tiles):
    """Dense (Tn, tile, B) scatter-add of the weights: the native fill
    (``native.banded_fill``) where the library builds, else ``np.add.at``,
    the same table. An entry outside its tile's band is an error on both
    paths: a dropped entry would lose a mesh edge."""
    if len(tgt):
        col = np.asarray(src) - np.asarray(offsets)[tiles]
        bad = (col < 0) | (col >= B)
        if bad.any():
            k = int(np.argmax(bad))
            raise ValueError(
                f"{int(bad.sum())} banded entries outside band width {B} "
                f"(first: target {int(tgt[k])}, source {int(src[k])}, "
                f"band start {int(offsets[tiles[k]])})")
    from gnn_fluid_dynamics_tpu_torch import native
    out = native.banded_fill(tgt, src, w, Tn * tile, tile, B,
                             np.asarray(offsets).astype(np.int32))
    if out is not None:
        return out
    onehot = np.zeros((Tn, tile, B), np.float32)
    np.add.at(onehot.reshape(-1), tgt * B + (src - offsets[tiles]), w)
    return onehot


@dataclasses.dataclass
class BandedTables:
    """The banded tables of one mesh (numpy). ``*_offsets`` are the per-tile
    band start rows."""
    vc_offsets: tuple         # vertex -> cell (weight 1; callers scale 1/3)
    vc_onehot: np.ndarray     # (Tc, 128, Bvc)
    cf_offsets: tuple         # cell -> face (shared row/col band)
    cf_row_onehot: np.ndarray  # (Tf, 128, Bcf)
    cf_col_onehot: np.ndarray
    es_offsets: tuple         # edge -> vertex, send/recv (shared band)
    es_onehot: np.ndarray     # (Tv, 128, Bes)
    er_onehot: np.ndarray
    sources: dict = None      # table -> source count (offset clamp bound)


def build_banded_tables(geom: Dict[str, np.ndarray], tile: int = TILE,
                        cf_valid=None) -> BandedTables:
    """The tables of ``geom``'s index arrays. ``cf_valid`` (2, F) bool, where
    given, marks the owner (row 0) and neighbour (row 1) entries of the cf
    tables to keep: a space rank's local graph leaves out a ghost face's
    cell that it does not hold (its index points at the pad row, which
    would stretch the tile's band to the last row; the face's row is
    refreshed from its owner before an owned row reads it)."""
    vei = np.asarray(geom["vertex_edge_index"], np.int64)
    V = geom["vertex_pos"].shape[0]
    F = vei.shape[1]
    C = geom["cell_pos"].shape[0]
    eF = np.arange(F, dtype=np.int64)
    ones2F = np.ones(2 * F, np.float32)

    # vertex -> cell: the table stores weight 1 per vertex (3 where a padded
    # cell's three vertices are one pad vertex); the 1/3 is a scalar
    vface = np.asarray(geom["vertex_face"], np.int64)
    vc_off, vc_onehot = _build_table(
        np.repeat(np.arange(C, dtype=np.int64), 3), vface.T.ravel(),
        np.ones(3 * C, np.float32), C, V, tile=tile)

    # cell -> face: owner (row) and neighbour (col) selectors sharing one band
    cei = np.asarray(geom["cell_edge_index"], np.int64)
    keep = (np.ones((2, F), bool) if cf_valid is None
            else np.asarray(cf_valid, bool))
    both = keep.T.ravel()
    cf_off, cf_probe = _build_table(
        np.repeat(eF, 2)[both], cei.T.ravel()[both], ones2F[both], F, C,
        tile=tile)
    Tf, B = cf_probe.shape[0], cf_probe.shape[2]
    off32 = np.asarray(cf_off, np.int64)
    cf_row, cf_col = (
        _onehot_fill(eF[k], cei[side][k], np.ones(int(k.sum()), np.float32),
                     Tf, tile, B, off32, eF[k] // tile)
        for side, k in enumerate(keep))
    onesF = np.ones(F, np.float32)

    # edge-space send/recv selectors sharing one band, applied to the
    # full-width edge latents
    es_off, es_probe = _build_table(
        np.concatenate([vei[0], vei[1]]), np.concatenate([eF, eF]),
        ones2F, V, F, tile=tile)
    Tv, Be = es_probe.shape[0], es_probe.shape[2]
    eoff = np.asarray(es_off, np.int64)
    es = _onehot_fill(vei[0], eF, onesF, Tv, tile, Be, eoff, vei[0] // tile)
    er = _onehot_fill(vei[1], eF, onesF, Tv, tile, Be, eoff, vei[1] // tile)
    return BandedTables(vc_off, vc_onehot, cf_off, cf_row, cf_col,
                        es_off, es, er, sources={"vc": V, "cf": C, "es": F})


def pad_band_width(onehot: np.ndarray, B: int) -> np.ndarray:
    """Zero-pad a table's band axis to a common width (for batching graphs
    whose tables were built with different B)."""
    if onehot.shape[2] == B:
        return onehot
    pad = [(0, 0), (0, 0), (0, B - onehot.shape[2])]
    return np.pad(onehot, pad)


TABLE_GROUPS = (("vc", "vc_offsets", ("vc_onehot",)),
                ("cf", "cf_offsets", ("cf_row_onehot", "cf_col_onehot")),
                ("es", "es_offsets", ("es_onehot", "er_onehot")))


def table_meta(t: BandedTables):
    """Per table group: (per-tile offsets, band width, source count)."""
    return {name: (np.asarray(getattr(t, off_key), np.int64),
                   int(getattr(t, oh_keys[0]).shape[2]),
                   int(t.sources[name]))
            for name, off_key, oh_keys in TABLE_GROUPS}


def canonical_spec(metas):
    """Canonical per-tile offsets + band width per table group, covering
    every mesh in ``metas`` (see :func:`canonicalize_tables`)."""
    spec = {}
    for name, _, _ in TABLE_GROUPS:
        offs = np.stack([m[name][0] for m in metas])             # (M, T)
        Bs = np.array([m[name][1] for m in metas])
        S = max(m[name][2] for m in metas)
        canon = offs.min(axis=0)
        # clamping canon down (off + B <= S) can widen the needed band,
        # which tightens the clamp again: iterate until stable (B is capped
        # at round_up(S, 128), so this terminates)
        while True:
            B = int(np.max(offs + Bs[:, None] - canon[None, :]))
            B = min(_round_up(B, 128), _round_up(max(S, 1), 128))
            clamped = np.minimum(canon, max(S - B, 0))
            if np.array_equal(clamped, canon):
                break
            canon = clamped
        assert int(np.max(offs + Bs[:, None] - canon[None, :])) <= B
        spec[name] = (canon, B)
    return spec


def rebase_tables(t: BandedTables, spec) -> BandedTables:
    """Shift one mesh's tables onto the canonical offsets of ``spec``."""
    out = dataclasses.replace(t)
    for name, off_key, oh_keys in TABLE_GROUPS:
        canon, B = spec[name]
        offs = np.asarray(getattr(t, off_key), np.int64)
        shifts = offs - canon
        assert shifts.min() >= 0, (name, shifts.min())
        setattr(out, off_key, tuple(int(o) for o in canon))
        for key in oh_keys:
            old = getattr(t, key)
            assert int(np.max(shifts)) + old.shape[2] <= B, (name, B)
            new = np.zeros((old.shape[0], old.shape[1], B), old.dtype)
            for ti in range(old.shape[0]):
                sh = int(shifts[ti])
                new[ti, :, sh: sh + old.shape[2]] = old[ti]
            setattr(out, key, new)
    return out


def canonicalize_tables(tables):
    """Give every mesh's tables identical per-tile band offsets.

    Meshes padded to one shape get per-tile offsets = the minimum across the
    meshes and a band width covering every mesh (the one-hot columns shifted
    to match), so that two meshes of one pad share their offsets whichever
    batch they land in. The JAX package needs this for its compiled
    programs; the port's dataset does not call it, since its kernels read
    each tile's offset from ``MeshGraph.*_off`` and
    :func:`~gnn_fluid_dynamics_tpu_torch.graph.batch_graphs` widens each
    mesh's own tables (a canonical band can be wider than every mesh's)."""
    tables = list(tables)
    if len(tables) == 1:
        return tables
    spec = canonical_spec([table_meta(t) for t in tables])
    return [rebase_tables(t, spec) for t in tables]
