"""K4, the owner/neighbour gather, as the whole of what the JAX package's
``gather_face_cells_pallas`` computes up to its widening to f32: the cell
latents rounded to bf16 (to nearest, ties to even), then each face's owner
and neighbour rows, in bf16. Checked on the CPU, where the wrapper takes its
plain version:

* (a) the plain version on f32 latents that are not bf16-exact (over many
  binades, with ties) against ``pallas_agg.gather_face_cells_pallas`` in
  interpret mode, on live faces: exact;
* (b) its rounding against ``torch.Tensor.to(torch.bfloat16)`` and against a
  round-to-nearest-even of the bits in numpy, on ties, overflow,
  subnormals, +-Inf and NaN: every bit where the value is not NaN, NaN at
  the same places (payloads may differ);
* (c) one unfused FvgnF face block on the kernel route, index and table
  route, against the same block's MLP fed the concatenation it was fed
  before K4 rounded its own input (``torch.cat([edge, own.float(),
  nbr.float(), extra])``): the row K8 takes and its output bit for bit;
* (d) the casts the unfused route issues around the gather, counted under a
  ``TorchDispatchMode``: none on the index route, one (before K6) on the
  table route, where each issued three before;
* the wrapper's refusals, and padded cells leaving live faces unchanged.

Inputs come from numpy seeds at a small size (a 300-point cylinder mesh,
hidden 128).
"""

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gnn_fluid_dynamics_tpu.data.synthetic import make_geometry
from gnn_fluid_dynamics_tpu.graph import from_geometry as jax_from_geometry
from gnn_fluid_dynamics_tpu.graph import to_static_bands as jax_to_static_bands
from gnn_fluid_dynamics_tpu.ops import pallas_agg
from gnn_fluid_dynamics_tpu.ops.reorder import rcm_reorder_geometry

import chip_smoke
from gnn_fluid_dynamics_tpu_torch.data.pipeline import (MeshDataset, Trajectory,
                                                        rollout_batch)
from gnn_fluid_dynamics_tpu_torch.graph import from_geometry, to_static_bands
from gnn_fluid_dynamics_tpu_torch.models import arch
from gnn_fluid_dynamics_tpu_torch.models.arch import ArchConfig, FaceBlock
from gnn_fluid_dynamics_tpu_torch.ops import kernels

H = 128


@pytest.fixture(scope="module")
def geom():
    return rcm_reorder_geometry(make_geometry("cylinder", n_points=300, seed=0))


@pytest.fixture(scope="module")
def graph(geom):
    return from_geometry(geom, pad_multiple=128, device="cpu")


@pytest.fixture(scope="module")
def table_graph(geom):
    """A graph on the table route (the trainer's validation batch), int8
    tables."""
    ds = MeshDataset([Trajectory(mesh_id="m0", geom=geom, fields={
        "cell_velocity": np.zeros((2, geom["cell_pos"].shape[0], 2))})],
        with_banded=True, banded_dtype="int8", device="cpu")
    g = to_static_bands(ds.get_batch(rollout_batch(ds)), derive_idx=False)
    assert g.table_route
    return g


def _wide_latents(rng, rows):
    """(rows, H) f32 normal values scaled over binades 2**-60..2**60, one in
    eight of them moved onto a tie between two bf16 values."""
    x = (rng.normal(size=(rows, H))
         * np.exp2(rng.integers(-60, 61, size=(rows, H)))).astype(np.float32)
    bits = x.view(np.uint32)
    tie = rng.random(size=(rows, H)) < 0.125
    bits[tie] = (bits[tie] & 0xFFFF0000) | 0x8000
    return x


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)


# ---- (a) against the Pallas wrapper -----------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_plain_version_on_f32_matches_pallas_exactly(geom, graph, seed):
    gj = jax_to_static_bands(jax_from_geometry(geom, pad_multiple=128,
                                               with_banded=True))
    x = _wide_latents(np.random.default_rng(seed), graph.num_cells)
    assert not np.array_equal(
        x, np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)))
    want = pallas_agg.gather_face_cells_pallas(jnp.asarray(x), gj)
    got = kernels.gather_face_cells(torch.from_numpy(x), graph)
    live = graph.face_mask.numpy()
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == (graph.num_faces, H)
        np.testing.assert_array_equal(a.float().numpy()[live],
                                      np.asarray(b)[live])


# ---- (b) the rounding ---------------------------------------------------------

def _rne_bits(x: np.ndarray):
    """bf16 bits of f32 ``x`` rounded to nearest, ties to even, and where
    ``x`` is NaN."""
    u = x.view(np.uint32).astype(np.uint64)
    nan = (u & 0x7FFFFFFF) > 0x7F800000
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16), nan


def test_plain_version_rounds_the_edges_as_torch(graph):
    x = chip_smoke.rounding_cases(graph.num_cells)
    own_idx, nbr_idx = graph.cell_edge_index.long()
    rne, nan = _rne_bits(x.numpy())
    for got, idx in zip(kernels.gather_face_cells_ref(x, graph),
                        (own_idx, nbr_idx)):
        want = x.to(torch.bfloat16)[idx]
        is_nan = torch.isnan(got)
        assert torch.equal(is_nan, torch.isnan(want))
        assert torch.equal(is_nan, torch.from_numpy(nan)[idx])
        assert torch.equal(_bits(got)[~is_nan], _bits(want)[~is_nan])
        assert np.array_equal(_bits(got).numpy().view(np.uint16)[~is_nan.numpy()],
                              rne[idx.numpy()][~is_nan.numpy()])


@pytest.mark.parametrize("bits,want", [
    (0x3F808000, 0x3F80),      # tie, down to the even neighbour
    (0x3F818000, 0x3F82),      # tie, up to the even neighbour
    (0xBF818000, 0xBF82),
    (0x3F807FFF, 0x3F80),      # just below a tie
    (0x3F808001, 0x3F81),      # just above a tie
    (0x7F7F7FFF, 0x7F7F),      # to bf16's largest finite value
    (0x7F7F8000, 0x7F80),      # beyond it: to +Inf
    (0xFF7FFFFF, 0xFF80),      # to -Inf
    (0x00018000, 0x0002),      # subnormal tie, up to the even neighbour
    (0x00008000, 0x0000),      # subnormal tie, down to zero
    (0x007FFFFF, 0x0080),      # the largest subnormal: the smallest normal
    (0x80000000, 0x8000),      # -0 stays -0
    (0x7F800000, 0x7F80),
    (0xFF800000, 0xFF80),
])
def test_rounding_cases_hold_each_edge(graph, bits, want):
    """Each edge value of ``chip_smoke.rounding_cases`` is there and rounds
    as stated, in the plain version and in torch's own cast."""
    x = chip_smoke.rounding_cases(graph.num_cells)
    o = int(graph.cell_edge_index[0, 0])          # face 0's owner
    row = x[o].numpy().view(np.uint32)
    assert bits in row
    col = int(np.flatnonzero(row == bits)[0])
    got = kernels.gather_face_cells_ref(x, graph)[0][0, col]
    assert int(_bits(got)) & 0xFFFF == want
    assert int(_bits(x[o, col].to(torch.bfloat16))) & 0xFFFF == want


def test_rounding_cases_hold_nans_a_bare_bit_rounding_would_lose(graph):
    """A NaN whose only set mantissa bits are low rounds to Inf under a bare
    round-to-nearest of its bits; the cast keeps it NaN."""
    x = chip_smoke.rounding_cases(graph.num_cells)
    o = int(graph.cell_edge_index[0, 0])          # face 0's owner
    row = x[o].numpy().view(np.uint32)
    assert 0x7F800001 in row
    rne, nan = _rne_bits(x[o].numpy())
    col = int(np.flatnonzero(row == 0x7F800001)[0])
    assert nan[col] and rne[col] == 0x7F80
    assert torch.isnan(x[o, col].to(torch.bfloat16))
    assert torch.isnan(kernels.gather_face_cells_ref(x, graph)[0][0, col])


# ---- (c) the face block's input and output --------------------------------

def _face_block():
    cfg = ArchConfig(hidden=H, aggregation="pallas", compute_dtype="bfloat16",
                     share_blocks=True, step_scalar=True)
    return FaceBlock(cfg, generator=torch.Generator().manual_seed(0))


def _before(cell, graph):
    """The gather as the kernel route ran it before K4 rounded its input:
    the latents cast to bf16, the kernel (its plain version here), both rows
    widened to f32."""
    c = cell.to(torch.bfloat16)
    if graph.table_route:
        own, nbr = kernels.table_dual(graph.cf_row_onehot, graph.cf_col_onehot,
                                      graph.cf_off, c)
    else:
        own, nbr = kernels.gather_face_cells(c, graph)
    return own.float(), nbr.float()


@pytest.mark.parametrize("route", ["index", "table"])
def test_face_block_input_and_output_unchanged(graph, table_graph, route,
                                               monkeypatch):
    """The face block's MLP runs as K8 (its plain version here): the row K8
    is handed, its parts concatenated as its plain version concatenates
    them, and its raw output against the MLP module on the row from
    before."""
    g = graph if route == "index" else table_graph
    rng = np.random.default_rng(5)
    cell = torch.from_numpy(rng.normal(size=(g.num_cells, H)).astype(np.float32))
    edge = torch.from_numpy(rng.normal(size=(g.num_faces, H)).astype(np.float32))
    extra = torch.tensor([[0.4]])
    block = _face_block()
    seen = []
    k8 = kernels.mlp_block

    def record(parts, extra, *args, **kwargs):
        seen.append(torch.cat([*parts, extra.expand(parts[0].shape[0], 1)],
                              dim=-1))
        return k8(parts, extra, *args, **kwargs)

    monkeypatch.setattr(kernels, "mlp_block", record)
    out = block(cell, edge, g, extra, route="unfused")
    own, nbr = _before(cell, g)
    x_before = torch.cat([edge, own, nbr, extra.expand(g.num_faces, 1)], dim=-1)
    out_before = block.mlp(x_before)
    (x,) = seen
    assert x.dtype == x_before.dtype == torch.float32
    assert torch.equal(_bits(x), _bits(x_before))
    assert out.dtype == torch.bfloat16
    assert torch.equal(_bits(out.float()), _bits(out_before))


# ---- (d) the casts around the gather ------------------------------------------

class _CountCasts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.casts = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.casts += func is torch.ops.aten._to_copy.default
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("route,want", [("index", 0), ("table", 1)])
def test_unfused_gather_issues_no_widening_casts(graph, table_graph,
                                                 monkeypatch, route, want):
    """``arch.gather_face_cells`` and ``arch._with_extra`` on the kernel
    route, the kernels stubbed with precomputed bf16 rows: the index route
    hands K4 the f32 latents as they are, the table route casts them once
    for K6, and neither widens the rows it gets back. The same count of the
    sequence run before (cast, kernel, two widenings) reads three."""
    g = graph if route == "index" else table_graph
    rng = np.random.default_rng(6)
    cell = torch.from_numpy(rng.normal(size=(g.num_cells, H)).astype(np.float32))
    edge = torch.from_numpy(rng.normal(size=(g.num_faces, H)).astype(np.float32))
    extra = torch.tensor([[0.4]])
    rows = kernels.gather_face_cells_ref(cell, g)
    given = []

    def stub(*args, **kwargs):
        given.append(args[0] if route == "index" else args[3])
        return rows

    monkeypatch.setattr(kernels, "gather_face_cells", stub)
    monkeypatch.setattr(kernels, "table_dual", stub)
    with _CountCasts() as mode:
        own, nbr = arch.gather_face_cells(cell, g, use_kernels=True)
        x = arch._with_extra([edge, own, nbr], extra, g.num_faces)
    assert mode.casts == want
    assert own.dtype == nbr.dtype == torch.bfloat16 and x.dtype == torch.float32
    assert given[0].dtype == (torch.float32 if route == "index"
                              else torch.bfloat16)
    with _CountCasts() as before:
        own, nbr = _before(cell, g)
        arch._with_extra([edge, own, nbr], extra, g.num_faces)
    assert before.casts == 3


# ---- the wrapper -------------------------------------------------------------

def test_wrapper_takes_f32_and_bf16_on_the_cpu(graph):
    rng = np.random.default_rng(8)
    x = torch.from_numpy(_wide_latents(rng, graph.num_cells))
    before = kernels.gather_face_cells.launches
    a = kernels.gather_face_cells(x, graph)
    b = kernels.gather_face_cells(x.to(torch.bfloat16), graph)
    for u, v in zip(a, b):
        assert u.dtype == torch.bfloat16
        assert torch.equal(_bits(u), _bits(v))
    assert kernels.gather_face_cells.launches == before


def _meta(graph, dtype=torch.float32, rows=None, cols=H):
    return torch.empty((rows or graph.num_cells, cols), dtype=dtype,
                       device="meta")


@pytest.mark.parametrize("case,match", [
    ("f64", "dtype"), ("f16", "dtype"), ("int32", "dtype"),
    ("rows", "shape"), ("width", "shape"), ("transposed", "contiguous"),
    ("offset", "aligned"), ("graph_on_cpu", "is on cpu")])
def test_wrapper_refuses_what_the_kernel_does_not_take(graph, case, match):
    """Latents off the CPU reach the argument checks, never the plain
    version: another dtype than f32 or bf16, another shape, a non-contiguous
    or misaligned tensor, or index vectors on another device."""
    x = {"f64": lambda: _meta(graph, torch.float64),
         "f16": lambda: _meta(graph, torch.float16),
         "int32": lambda: _meta(graph, torch.int32),
         "rows": lambda: _meta(graph, rows=graph.num_cells + 1),
         "width": lambda: _meta(graph, cols=H // 2),
         "transposed": lambda: torch.empty((H, graph.num_cells),
                                           device="meta").T,
         "offset": lambda: torch.empty(graph.num_cells * H + 1,
                                       device="meta")[1:].view(-1, H),
         "graph_on_cpu": lambda: _meta(graph, torch.bfloat16)}[case]()
    before = kernels.gather_face_cells.launches
    with pytest.raises(ValueError, match=match):
        kernels.gather_face_cells(x, graph)
    assert kernels.gather_face_cells.launches == before


def test_padded_cells_do_not_touch_live_faces_f32(graph):
    """Padded faces point at the last padded cell slot: changing every
    padded f32 latent leaves the live faces' rows unchanged."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(_wide_latents(rng, graph.num_cells))
    cm, fm = graph.cell_mask, graph.face_mask
    assert not cm.all() and not fm.all()
    y = x.clone()
    y[~cm] = float("nan")
    for a, b in zip(kernels.gather_face_cells(x, graph),
                    kernels.gather_face_cells(y, graph)):
        assert torch.equal(_bits(a[fm]), _bits(b[fm]))
