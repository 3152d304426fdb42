"""What the redesigned K1 and K2 (fused face and cell blocks) and K6 and K7
(dense-table dual and single apply) rest on, checked on the CPU: the kernel
build's hash sees every header; K6's and K7's plain versions agree with the
JAX package's dense Pallas kernels (interpret mode) at other band widths and
on NaN sources; the packed weight layout (K0 = 384 and 192) and the weights
K1 and K2 are given; the wrappers' refusals (unpacked weights, bands that
are no multiple of 128 or lie outside their source; a band of any width
is taken, ``tests/test_torch_wide_bands.py``); and the yardsticks of
``chip_smoke.py`` (bytes and operations of each kernel's work), so that a
redesign cannot move its own bound.

Tolerances: K7 against the Pallas kernel within one bf16 step (2**-7
relative plus 2**-7 absolute: f32 sums in another order, one rounding);
NaN positions, layouts and counts exactly.
"""

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_fluid_dynamics_tpu.data.synthetic import make_geometry
from gnn_fluid_dynamics_tpu.ops import pallas_agg
from gnn_fluid_dynamics_tpu.ops.reorder import rcm_reorder_geometry

import chip_smoke
from gnn_fluid_dynamics_tpu_torch.data.pipeline import (MeshDataset, Trajectory,
                                                        rollout_batch)
from gnn_fluid_dynamics_tpu_torch.graph import from_geometry, to_static_bands
from gnn_fluid_dynamics_tpu_torch.models.arch import MLP, ArchConfig, CellBlock
from gnn_fluid_dynamics_tpu_torch.ops import kernels

H = 128
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)


# ---- the build's hash -------------------------------------------------------

def test_headers_name_every_header_in_csrc():
    on_disk = {p.name for p in kernels.CSRC.glob("*.cuh")}
    assert set(kernels.HEADERS) == on_disk


@pytest.mark.parametrize("header", kernels.HEADERS)
def test_changing_a_header_changes_every_library_path(tmp_path, monkeypatch,
                                                      header):
    for p in kernels.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    before = {n: kernels._library_path(n) for n in kernels.SOURCES}
    with open(tmp_path / header, "a") as f:
        f.write("\n// changed\n")
    after = {n: kernels._library_path(n) for n in kernels.SOURCES}
    assert all(before[n] != after[n] for n in kernels.SOURCES)


# ---- K7's plain version against the dense Pallas kernel ----------------------

def _vc_like_table(rng, T, B):
    """A (T, 128, B) int8 table shaped like vc: each row 3 vertex columns of
    weight 1 inside the band, and the last row of each tile a padded cell,
    weight 3 on one column."""
    oh = np.zeros((T, 128, B), np.int8)
    for t in range(T):
        for i in range(127):
            oh[t, i, rng.choice(B, size=3, replace=False)] = 1
        oh[t, 127, B - 1] = 3
    return oh


@pytest.mark.parametrize("band", [128, 384])
def test_table_single_plain_matches_pallas_at_band(band):
    rng = np.random.default_rng(20)
    T = 3
    oh = _vc_like_table(rng, T, band)
    S = 128 * T + band
    off = np.array([0, 128, 256], np.int32)
    src = rng.normal(size=(S, H)).astype(np.float32)
    sj = jnp.asarray(src, jnp.bfloat16)
    st = torch.from_numpy(np.array(sj.astype(jnp.float32))).to(torch.bfloat16)
    want = pallas_agg.banded_single_pallas(jnp.asarray(oh), jnp.asarray(off), sj)
    want = np.asarray(want.astype(jnp.float32))[:, :H // 2] / 3.0
    got = kernels.table_single(torch.from_numpy(oh), torch.from_numpy(off),
                               st[:, :H // 2].contiguous())
    assert got.dtype == torch.float32 and got.shape == (T * 128, H // 2)
    np.testing.assert_allclose(got.numpy(), want, **BF16_TOL)
    # the padded row: 3 x its one source row, then the mean's / 3
    pad = st[off + band - 1, :H // 2].float()
    torch.testing.assert_close(got[127::128], (3 * pad).to(torch.bfloat16)
                               .float() / 3.0, rtol=0, atol=0)


def test_table_single_plain_propagates_nan_through_a_zero_weight():
    """A dense product gives 0 x NaN = NaN, as the TPU kernel's one-hot
    product does: a NaN source row in a tile's band poisons every row of
    that tile, also those whose weight on it is 0, and no other tile."""
    rng = np.random.default_rng(21)
    T, B = 2, 256
    oh = _vc_like_table(rng, T, B)
    off = np.array([0, 256], np.int32)
    src = rng.normal(size=(512, H)).astype(np.float32)
    nan_row = 7
    oh[0, :, nan_row] = 0                  # no cell of tile 0 uses it
    src[nan_row] = np.nan
    sj = jnp.asarray(src, jnp.bfloat16)
    want = pallas_agg.banded_single_pallas(jnp.asarray(oh), jnp.asarray(off), sj)
    want = np.asarray(want.astype(jnp.float32))[:, :H // 2]
    got = kernels.table_single(
        torch.from_numpy(oh), torch.from_numpy(off),
        torch.from_numpy(src[:, :H // 2]).to(torch.bfloat16)).numpy()
    assert np.isnan(want[:128]).all() and np.isnan(got[:128]).all()
    assert np.isfinite(want[128:]).all() and np.isfinite(got[128:]).all()


@pytest.mark.parametrize("roll", [False, True])
def test_table_dual_plain_propagates_nan_through_a_zero_weight(roll):
    """K6's plain version, as the TPU kernel's one-hot products: a NaN source
    row in a tile's band that neither table of that tile weighs gives NaN in
    every row of that tile (in both outputs, or in the rolled sum), and in no
    other tile."""
    rng = np.random.default_rng(22)
    T, B = 2, 256
    oh_a = _vc_like_table(rng, T, B)
    oh_b = _vc_like_table(rng, T, B)
    off = np.array([0, 256], np.int32)
    src = rng.normal(size=(512, H)).astype(np.float32)
    nan_row = 9
    oh_a[0, :, nan_row] = 0
    oh_b[0, :, nan_row] = 0
    src[nan_row] = np.nan
    sj = jnp.asarray(src, jnp.bfloat16)
    st = torch.from_numpy(src).to(torch.bfloat16)
    want = pallas_agg.banded_dual_pallas(
        jnp.asarray(oh_a), jnp.asarray(oh_b), jnp.asarray(off), sj,
        combine_roll=H // 2 if roll else 0)
    got = kernels.table_dual(torch.from_numpy(oh_a), torch.from_numpy(oh_b),
                             torch.from_numpy(off), st, combine_roll=roll)
    if roll:
        want, got = (np.asarray(want.astype(jnp.float32))[:, :H // 2],), (got,)
    else:
        want = tuple(np.asarray(w.astype(jnp.float32)) for w in want)
    for w, g in zip(want, got):
        g = g.float().numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        assert np.isnan(g[:128]).all() and np.isfinite(g[128:]).all()


# ---- K1's packed weights and the wrappers' refusals -------------------------

def test_pack_weights_puts_each_entry_in_its_core_matrix():
    """Element (k, n) of a (K, N) matrix lands at ((k // 8) * (N // 8) +
    n // 8) * 64 + (n % 8) * 8 + k % 8 of its part, the parts W0, W1, W2 one
    after the other (the layout ``csrc/gn_wgmma.cuh`` describes)."""
    _assert_packed(3 * H, seed=3)


def _assert_packed(k0, seed):
    g = torch.Generator().manual_seed(seed)
    ws = [torch.randn(k, H, generator=g) for k in (k0, H, H)]
    packed = kernels.pack_weights(*ws)
    assert packed.shape == ((k0 + 2 * H) * H,) and packed.is_contiguous()
    base = 0
    for w in ws:
        K, N = w.shape
        k, n = torch.meshgrid(torch.arange(K), torch.arange(N), indexing="ij")
        pos = ((k // 8) * (N // 8) + n // 8) * 64 + (n % 8) * 8 + k % 8
        torch.testing.assert_close(packed[base + pos], w, rtol=0, atol=0)
        base += K * N


def test_pack_weights_at_the_cell_blocks_width():
    """The same layout at K2's input width, K0 = 192 (128 cell channels and
    the 64-channel vertex mean): element (k, n) of each matrix lands in its
    8 x 8 core matrix, W0 (192 x 128), W1 and W2 one after the other."""
    _assert_packed(H + H // 2, seed=4)


def test_kernel_weights_pack_once_in_bf16():
    """The fused kernels' weights are packed when asked for by name, once
    per set of weights; the plain MLP weights carry no packed copy."""
    mlp = MLP(3 * H, H, H, generator=torch.Generator().manual_seed(0))
    w = mlp.kernel_weights(packed=True)
    assert isinstance(w, kernels.PackedWeights)
    assert w.packed.dtype == w.mlp.w0.dtype == torch.bfloat16
    torch.testing.assert_close(
        w.packed, kernels.pack_weights(w.mlp.w0, w.mlp.w1, w.mlp.w2),
        rtol=0, atol=0)
    assert mlp.kernel_weights(packed=True) is w            # cached
    assert type(mlp.kernel_weights()) is kernels.BlockWeights


def test_face_block_plain_version_reads_the_packed_weights_source(small_graph):
    """On the CPU K1 with its PackedWeights gives what it gives with the MLP
    weights they were packed from."""
    g = small_graph
    mlp = MLP(3 * H, H, H, generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    cells = torch.randn(g.num_cells, H, generator=gen).to(torch.bfloat16)
    edges = torch.randn(g.num_faces, H, generator=gen).to(torch.bfloat16)
    got = kernels.fused_face_block(cells, edges, g,
                                   mlp.kernel_weights(packed=True), True)
    want = kernels.fused_face_block(cells, edges, g, mlp.kernel_weights(), True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.fixture(scope="module")
def small_graph():
    geom = rcm_reorder_geometry(make_geometry("cylinder", n_points=300, seed=0))
    return from_geometry(geom, pad_multiple=128, device="cpu")


def test_face_block_refuses_weights_without_their_packing(small_graph):
    """Off the CPU K1 takes only PackedWeights, and checks what it passes to
    the kernel: the packed matrices and the five vectors."""
    meta = torch.device("meta")
    g = small_graph
    mlp = MLP(3 * H, H, H, generator=torch.Generator().manual_seed(0))
    fw = mlp.kernel_weights(packed=True)
    w = kernels.PackedWeights(kernels.BlockWeights(*(t.to(meta) for t in fw.mlp)),
                            fw.packed.to(meta))
    cells = torch.empty((g.num_cells, H), dtype=torch.bfloat16, device=meta)
    edges = torch.empty((g.num_faces, H), dtype=torch.bfloat16, device=meta)
    gm = dataclasses.replace(g, cell_edge_index=g.cell_edge_index.to(meta))
    before = kernels.fused_face_block.launches
    with pytest.raises(ValueError, match="packed"):
        kernels.fused_face_block(cells, edges, gm, w.mlp)
    with pytest.raises(ValueError, match="packed"):
        kernels.fused_face_block(cells, edges, gm,
                                 w._replace(packed=w.packed[:-8]))
    with pytest.raises(ValueError, match="ln_b"):
        kernels.fused_face_block(cells, edges, gm, w._replace(
            mlp=w.mlp._replace(ln_b=w.mlp.ln_b.float())))
    assert kernels.fused_face_block.launches == before


def test_cell_block_passes_packed_bf16_weights_once(small_graph, monkeypatch):
    """The fused cell block hands K2 its MLP's PackedWeights, bf16, packed
    once and then taken from the cache."""
    g = small_graph
    block = CellBlock(ArchConfig(), generator=torch.Generator().manual_seed(5))
    seen = []

    def spy(cell_attr, vtx, graph, w, dual_out=False):
        seen.append(w)
        return kernels.fused_cell_block_ref(cell_attr, vtx, graph, w, dual_out)

    monkeypatch.setattr(kernels, "fused_cell_block", spy)
    gen = torch.Generator().manual_seed(6)
    cells = torch.randn(g.num_cells, H, generator=gen)
    edges = torch.randn(g.num_faces, H, generator=gen)
    for _ in range(2):
        block(cells, edges, g, route="fused", dual_out=True)
    w = seen[0]
    assert isinstance(w, kernels.PackedWeights) and seen[1] is w
    assert w.packed.dtype == torch.bfloat16
    assert all(t.dtype == torch.bfloat16 for t in w.mlp)
    torch.testing.assert_close(
        w.packed, kernels.pack_weights(w.mlp.w0, w.mlp.w1, w.mlp.w2),
        rtol=0, atol=0)


def test_cell_block_plain_version_reads_the_packed_weights_source(small_graph):
    """On the CPU K2 with its PackedWeights gives what it gives with the MLP
    weights they were packed from."""
    g = small_graph
    mlp = MLP(H + H // 2, H, H, generator=torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(8)
    cells = torch.randn(g.num_cells, H, generator=gen).to(torch.bfloat16)
    vtx = torch.randn(g.num_vertices, H // 2, generator=gen).to(torch.bfloat16)
    got = kernels.fused_cell_block(cells, vtx, g,
                                   mlp.kernel_weights(packed=True), True)
    want = kernels.fused_cell_block(cells, vtx, g, mlp.kernel_weights(), True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cell_block_refuses_weights_without_their_packing(small_graph):
    """Off the CPU K2 takes only PackedWeights for K0 = 192, and checks what
    it passes to the kernel: the packed matrices and the five vectors."""
    meta = torch.device("meta")
    g = small_graph
    mlp = MLP(H + H // 2, H, H, generator=torch.Generator().manual_seed(0))
    pw = mlp.kernel_weights(packed=True)
    w = kernels.PackedWeights(kernels.BlockWeights(*(t.to(meta) for t in pw.mlp)),
                              pw.packed.to(meta))
    cells = torch.empty((g.num_cells, H), dtype=torch.bfloat16, device=meta)
    vtx = torch.empty((g.num_vertices, H // 2), dtype=torch.bfloat16,
                      device=meta)
    gm = dataclasses.replace(g, vertex_face=g.vertex_face.to(meta))
    face_packed = MLP(3 * H, H, H).kernel_weights(packed=True).packed.to(meta)
    before = kernels.fused_cell_block.launches
    with pytest.raises(ValueError, match="packed"):
        kernels.fused_cell_block(cells, vtx, gm, w.mlp)
    with pytest.raises(ValueError, match="packed"):
        kernels.fused_cell_block(cells, vtx, gm, w._replace(packed=face_packed))
    with pytest.raises(ValueError, match="b1"):
        kernels.fused_cell_block(cells, vtx, gm, w._replace(
            mlp=w.mlp._replace(b1=w.mlp.b1.float())))
    assert kernels.fused_cell_block.launches == before


@pytest.mark.parametrize("band", [0, 200])
def test_table_single_refuses_a_band_the_kernel_does_not_take(band):
    meta = torch.device("meta")
    oh = torch.empty((2, 128, band), dtype=torch.int8, device=meta)
    off = torch.zeros(2, dtype=torch.int32, device=meta)
    src = torch.empty((512, H // 2), dtype=torch.bfloat16, device=meta)
    before = kernels.table_single.launches
    with pytest.raises(ValueError, match="multiple of 128"):
        kernels.table_single(oh, off, src)
    assert kernels.table_single.launches == before


@pytest.mark.parametrize("off, rows", [([0, 200], 300), ([-1, 100], 512)])
def test_table_bands_outside_the_source_are_refused(off, rows):
    """K6 and K7 read source rows without bounds checks: their wrappers
    refuse offsets whose band of 128 rows leaves the source."""
    with pytest.raises(ValueError, match="inside"):
        kernels._check_bands(torch.tensor(off, dtype=torch.int32), 128, rows)


def test_table_bands_are_read_back_again_after_an_in_place_change():
    off = torch.tensor([0, 172], dtype=torch.int32)
    kernels._check_bands(off, 128, 300)
    kernels._check_bands(off, 128, 300)                    # remembered
    off[1] = 173
    with pytest.raises(ValueError, match="inside"):
        kernels._check_bands(off, 128, 300)
    with pytest.raises(ValueError, match="inside"):
        kernels._check_bands(off[:1].clone() + 200, 128, 300)


# ---- the yardsticks of chip_smoke.py ----------------------------------------

def test_kernel_bounds_count_each_input_and_output_once(small_graph):
    g = small_graph
    F, C, V = g.num_faces, g.num_cells, g.num_vertices
    b = chip_smoke.bounds(g)
    weights_k1 = (384 * 128 + 2 * 128 * 128) * 2 + 5 * 128 * 2
    weights_k2 = (192 * 128 + 2 * 128 * 128) * 2 + 5 * 128 * 2
    want = {
        # edge row + 2 cell rows' worth of cells read once, 2 indices, out
        "K1_fused_face_block": (256 * F + 256 * C + 8 * F + weights_k1
                                + 256 * F, 2 * F * 128 * 640),
        "K2_fused_cell_block": (256 * C + 128 * V + 12 * C + weights_k2
                                + 512 * C, 2 * C * 128 * 448),
        "K3_edges_to_vertices": (256 * F + 4 * (V + 1) + 8 * F + 128 * V,
                                 128 * F),
        # f32 latents read once (the FvgnF path's form), 2 indices, 2 bf16 rows
        "K4_gather_face_cells": (512 * C + 8 * F + 512 * F, 0),
        "K5_vertices_to_cells": (128 * V + 12 * C + 256 * C, 192 * C),
    }
    for name, (nbytes, flops) in want.items():
        assert b[name][2:] == (nbytes, flops), name
        assert b[name][0] == pytest.approx(max(nbytes / 3.35e12, flops / (
            989e12 if name in ("K1_fused_face_block", "K2_fused_cell_block")
            else 67e12)) * 1e3)


def test_table_form_bound_counts_this_datas_nonzeros():
    geoms = [rcm_reorder_geometry(make_geometry("cylinder", n_points=n,
                                                seed=s))
             for n, s in ((300, 0), (320, 1))]
    ds = MeshDataset([Trajectory(mesh_id=f"m{i}", geom=gm, fields={
        "cell_velocity": np.zeros((2, gm["cell_pos"].shape[0], 2))})
        for i, gm in enumerate(geoms)], with_banded=True, banded_dtype="int8",
        device="cpu")
    vg = to_static_bands(ds.get_batch(rollout_batch(ds)), derive_idx=False)
    vc = vg.vc_onehot
    T, _, B = vc.shape
    rows = T * 128
    nnz = int((vc != 0).sum())
    nbytes, flops = chip_smoke.table_form_bound(
        vg, ("K7_table_single", "vc"), (vc,))
    assert nbytes == T * 128 * B + vg.num_vertices * 64 * 2 + 4 * T + rows * 256
    assert flops == 2 * nnz * 64 + rows * 64
    es, er = vg.es_onehot, vg.er_onehot
    nnz = int((es != 0).sum() + (er != 0).sum())
    nbytes, flops = chip_smoke.table_form_bound(
        vg, ("K6_table_dual", "es_roll"), (es, er))
    assert nbytes == (2 * es.numel() + vg.num_faces * 256
                      + 4 * es.shape[0] + es.shape[0] * 128 * 128)
    assert flops == 2 * nnz * 64 + es.shape[0] * 128 * 64
