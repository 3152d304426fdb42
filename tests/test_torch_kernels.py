"""The plain versions of the port's GN-block kernels (the CPU path of
``ops/kernels.py``) against the JAX package's Pallas kernels in interpret
mode, and against its segment reference semantics in f32: the fused block's
K1-K3 and the unfused block's K4 (owner/neighbour gather) and K5 (3-vertex
mean).

Inputs and weights come from a numpy seed; the weights reach the port through
``params_from_flax``. Tolerances:

* f32, against the JAX f32 reference: rtol 1e-5, atol 1e-5 (the same math up
  to f32 summation order);
* bf16, against the Pallas kernels: 2**-7 relative plus 2**-7 absolute — one
  bf16 rounding step (8 bits of mantissa) where an f32 sum taken in another
  order lands on the other side of a rounding boundary;
* K4, against its Pallas kernel: exact. A gather copies rows rounded to
  bf16 once (the wrapper's cast), and the TPU's one-hot product (one
  nonzero per row, f32 accumulation) copies them too.
"""

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_fluid_dynamics_tpu.data.synthetic import make_geometry
from gnn_fluid_dynamics_tpu.graph import from_geometry as jax_from_geometry
from gnn_fluid_dynamics_tpu.graph import to_static_bands
from gnn_fluid_dynamics_tpu.models.arch import MLP as JaxMLP
from gnn_fluid_dynamics_tpu.models.arch import \
    aggregate_twice_mp as jax_aggregate_twice_mp
from gnn_fluid_dynamics_tpu.ops import pallas_agg
from gnn_fluid_dynamics_tpu.ops.reorder import rcm_reorder_geometry
from gnn_fluid_dynamics_tpu.ops.segment import \
    aggregate_edges_to_vertices_scatter as jax_scatter

from gnn_fluid_dynamics_tpu_torch.graph import from_geometry
from gnn_fluid_dynamics_tpu_torch.models.arch import MLP
from gnn_fluid_dynamics_tpu_torch.ops import kernels
from gnn_fluid_dynamics_tpu_torch.weights import params_from_flax

H = 128
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)


@pytest.fixture(scope="module")
def graphs():
    geom = rcm_reorder_geometry(make_geometry("cylinder", n_points=300, seed=0))
    gj = to_static_bands(jax_from_geometry(geom, pad_multiple=128,
                                           with_banded=True))
    gt = from_geometry(geom, pad_multiple=128, device="cpu")
    return gj, gt


def _flax_mlp_params(rng, k0):
    """A Flax MLP param tree (Dense kernels (in, out)) with LayerNorm."""
    def dense(n_in, n_out):
        return {"kernel": rng.normal(size=(n_in, n_out)) / np.sqrt(n_in),
                "bias": 0.1 * rng.normal(size=(n_out,))}
    return {"Dense_0": dense(k0, H), "Dense_1": dense(H, H),
            "Dense_2": dense(H, H),
            "LayerNorm_0": {"scale": 1.0 + 0.1 * rng.normal(size=(H,)),
                            "bias": 0.1 * rng.normal(size=(H,))}}


def _pallas_params(tree):
    """The ``MLP(..., raw=True)`` dict the Pallas kernels take."""
    f32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    return {"w0": f32(tree["Dense_0"]["kernel"]), "b0": f32(tree["Dense_0"]["bias"]),
            "w1": f32(tree["Dense_1"]["kernel"]), "b1": f32(tree["Dense_1"]["bias"]),
            "w2": f32(tree["Dense_2"]["kernel"]), "b2": f32(tree["Dense_2"]["bias"]),
            "ln_scale": f32(tree["LayerNorm_0"]["scale"]),
            "ln_bias": f32(tree["LayerNorm_0"]["bias"])}


def _port_weights(tree, k0, dtype):
    mlp = MLP(k0, H, H)
    mlp.load_state_dict(params_from_flax(tree))
    return mlp.kernel_weights(dtype)


def _latents(rng, n, dtype):
    x = rng.normal(size=(n, H)).astype(np.float32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16"
                else (jnp.float32, torch.float32))
    xj = jnp.asarray(x, jdt)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---- K3: edge -> vertex sum -------------------------------------------------

def test_edges_to_vertices_f32_matches_segment_reference(graphs):
    gj, gt = graphs
    rng = np.random.default_rng(0)
    ej, et = _latents(rng, gt.num_faces, "float32")
    want = jax_scatter(ej[:, :H // 2], ej[:, H // 2:], gj.vertex_edge_index,
                       gj.num_vertices)
    got = kernels.edges_to_vertices_ref(et, gt)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def test_edges_to_vertices_bf16_matches_pallas(graphs):
    gj, gt = graphs
    rng = np.random.default_rng(1)
    ej, et = _latents(rng, gt.num_faces, "bfloat16")
    want = pallas_agg.aggregate_edges_to_vertices_pallas(ej, gj)[:, :H // 2]
    got = kernels.edges_to_vertices(et, gt)        # CPU tensors: plain version
    assert got.dtype == torch.bfloat16 and got.shape == (gt.num_vertices, H // 2)
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


# ---- K1: fused face block ---------------------------------------------------

@pytest.mark.parametrize("dual_out", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_face_block_matches_pallas(graphs, dtype, dual_out):
    gj, gt = graphs
    rng = np.random.default_rng(2)
    tree = _flax_mlp_params(rng, 3 * H)
    cj, ct = _latents(rng, gt.num_cells, dtype)
    ej, et = _latents(rng, gt.num_faces, dtype)
    want = pallas_agg.fused_face_block_pallas(cj, ej, gj, _pallas_params(tree),
                                              dual_out=dual_out)
    w = _port_weights(tree, 3 * H, ct.dtype)
    got = kernels.fused_face_block(ct, et, gt, w, dual_out=dual_out)
    want, got = (want, got) if dual_out else ((want,), (got,))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for a, b in zip(got, want):
        assert a.dtype == ct.dtype and a.shape == (gt.num_faces, H)
        np.testing.assert_allclose(_np(a), _np(b), **tol)


# ---- K2: fused cell block ---------------------------------------------------

def test_fused_cell_block_f32_matches_segment_reference(graphs):
    """f32: the JAX package's plain cell block (3-vertex mean of the segment
    vertex sum, then its Flax MLP) gives the raw output; res = c + raw."""
    gj, gt = graphs
    rng = np.random.default_rng(3)
    tree = _flax_mlp_params(rng, H + H // 2)
    cj, ct = _latents(rng, gt.num_cells, "float32")
    ej, et = _latents(rng, gt.num_faces, "float32")
    agg = jax_aggregate_twice_mp(ej, gj, "segment")
    want_raw = JaxMLP(H, H).apply({"params": tree},
                                  jnp.concatenate([cj, agg], axis=1))
    w = _port_weights(tree, H + H // 2, torch.float32)
    vtx = kernels.edges_to_vertices(et, gt)
    raw, res = kernels.fused_cell_block(ct, vtx, gt, w, dual_out=True)
    np.testing.assert_allclose(_np(raw), _np(want_raw), **F32_TOL)
    np.testing.assert_allclose(_np(res), _np(cj + want_raw), **F32_TOL)


@pytest.mark.parametrize("dual_out", [False, True])
def test_fused_cell_block_bf16_matches_pallas(graphs, dual_out):
    gj, gt = graphs
    rng = np.random.default_rng(4)
    tree = _flax_mlp_params(rng, H + H // 2)
    cj, ct = _latents(rng, gt.num_cells, "bfloat16")
    ej, et = _latents(rng, gt.num_faces, "bfloat16")
    want = pallas_agg.fused_cell_block_pallas(cj, ej, gj, _pallas_params(tree),
                                              dual_out=dual_out)
    w = _port_weights(tree, H + H // 2, torch.bfloat16)
    got = kernels.fused_cell_block(ct, kernels.edges_to_vertices(et, gt), gt, w,
                                   dual_out=dual_out)
    want, got = (want, got) if dual_out else ((want,), (got,))
    # live cells only: the Pallas path's index vectors give a padded cell
    # (3 x the pad vertex) one vertex term where the segment reference, and
    # the port, sum three; padded rows are masked out downstream
    live = gt.cell_mask.numpy()
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == (gt.num_cells, H)
        np.testing.assert_allclose(_np(a)[live], _np(b)[live], **BF16_TOL)


# ---- K4: owner/neighbour gather ----------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gather_face_cells_matches_pallas_exactly(graphs, dtype):
    """bf16 latents are copied; f32 ones (not bf16-exact) are rounded to
    bf16 first, by the plain version as by the Pallas wrapper's cast."""
    gj, gt = graphs
    rng = np.random.default_rng(7)
    cj, ct = _latents(rng, gt.num_cells, dtype)
    want = pallas_agg.gather_face_cells_pallas(cj, gj)
    got = kernels.gather_face_cells(ct, gt)        # CPU tensors: plain version
    live = gt.face_mask.numpy()
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == (gt.num_faces, H)
        np.testing.assert_array_equal(_np(a)[live], _np(b)[live])


# ---- K5: 3-vertex cell mean -------------------------------------------------

def test_vertices_to_cells_f32_matches_segment_reference(graphs):
    """f32 latents: K3 then K5 is the JAX package's segment twice-message-
    passing aggregation."""
    gj, gt = graphs
    rng = np.random.default_rng(8)
    ej, et = _latents(rng, gt.num_faces, "float32")
    want = jax_aggregate_twice_mp(ej, gj, "segment")
    got = kernels.vertices_to_cells(kernels.edges_to_vertices(et, gt), gt)
    assert got.dtype == torch.float32 and got.shape == (gt.num_cells, H // 2)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def test_vertices_to_cells_bf16_matches_pallas(graphs):
    """bf16 latents: K3 then K5 against the Pallas edge->vertex sum and
    3-vertex sum with its f32 division by 3, on live cells (a padded cell
    sums the pad vertex once there, three times here)."""
    gj, gt = graphs
    rng = np.random.default_rng(9)
    ej, et = _latents(rng, gt.num_faces, "bfloat16")
    want = pallas_agg.aggregate_vertices_to_cells_pallas(
        pallas_agg.aggregate_edges_to_vertices_pallas(ej, gj), gj)
    got = kernels.vertices_to_cells(kernels.edges_to_vertices(et, gt), gt)
    assert got.dtype == torch.float32 and got.shape == (gt.num_cells, H // 2)
    live = gt.cell_mask.numpy()
    np.testing.assert_allclose(_np(got)[live], _np(want)[live], **BF16_TOL)


def test_vertices_to_cells_rounds_the_sum_before_dividing(graphs):
    """K5 rounds the 3-vertex f32 sum to bf16, then divides by 3 in f32 (the
    TPU kernel's output dtype, then its wrapper's epilogue); K2's mean
    rounds once, after the division."""
    _, gt = graphs
    rng = np.random.default_rng(10)
    vtx = torch.from_numpy(rng.normal(size=(gt.num_vertices, H // 2)).astype(
        np.float32)).to(torch.bfloat16)
    vf = gt.vertex_face.long()
    s = vtx.float()[vf[0]] + vtx.float()[vf[1]] + vtx.float()[vf[2]]
    got = kernels.vertices_to_cells(vtx, gt)
    torch.testing.assert_close(got, s.to(torch.bfloat16).float() / 3.0,
                               rtol=0, atol=0)
    assert not torch.equal(got, (s / 3.0).to(torch.bfloat16).float())


# ---- wrappers ---------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_launch_nothing(graphs):
    _, gt = graphs
    rng = np.random.default_rng(5)
    _, ct = _latents(rng, gt.num_cells, "bfloat16")
    _, et = _latents(rng, gt.num_faces, "bfloat16")
    wf = _port_weights(_flax_mlp_params(rng, 3 * H), 3 * H, torch.bfloat16)
    wc = _port_weights(_flax_mlp_params(rng, H + H // 2), H + H // 2,
                       torch.bfloat16)
    before = [f.launches for f in (kernels.fused_face_block,
                                   kernels.fused_cell_block,
                                   kernels.edges_to_vertices)]
    vtx = kernels.edges_to_vertices(et, gt)
    torch.testing.assert_close(vtx, kernels.edges_to_vertices_ref(et, gt),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        kernels.fused_cell_block(ct, vtx, gt, wc, dual_out=True),
        kernels.fused_cell_block_ref(ct, vtx, gt, wc, dual_out=True),
        rtol=0, atol=0)
    torch.testing.assert_close(kernels.fused_face_block(ct, et, gt, wf),
                               kernels.fused_face_block_ref(ct, et, gt, wf),
                               rtol=0, atol=0)
    after = [f.launches for f in (kernels.fused_face_block,
                                  kernels.fused_cell_block,
                                  kernels.edges_to_vertices)]
    assert after == before


def test_cpu_tensors_take_the_plain_version_unfused(graphs):
    _, gt = graphs
    rng = np.random.default_rng(11)
    _, ct = _latents(rng, gt.num_cells, "bfloat16")
    _, et = _latents(rng, gt.num_faces, "bfloat16")
    before = (kernels.gather_face_cells.launches,
              kernels.vertices_to_cells.launches)
    vtx = kernels.edges_to_vertices(et, gt)
    torch.testing.assert_close(kernels.vertices_to_cells(vtx, gt),
                               kernels.vertices_to_cells_ref(vtx, gt),
                               rtol=0, atol=0)
    torch.testing.assert_close(kernels.gather_face_cells(ct, gt),
                               kernels.gather_face_cells_ref(ct, gt),
                               rtol=0, atol=0)
    assert (kernels.gather_face_cells.launches,
            kernels.vertices_to_cells.launches) == before


@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_other_devices_never_take_the_plain_version(graphs, kernel):
    """A tensor off the CPU goes to the kernel's argument checks, which
    refuse what the kernel does not take; nothing falls back. K4 takes f32
    and bf16 latents, K5 bf16 vertex sums: each refuses another dtype, and
    on a dtype it takes, the graph's index vectors on the CPU."""
    _, gt = graphs
    if kernel == "K4":
        x = torch.empty((gt.num_cells, H), dtype=torch.float16, device="meta")
        taken = x.to(torch.float32)
        call = kernels.gather_face_cells
    else:
        x = torch.empty((gt.num_vertices, H // 2), dtype=torch.float32,
                        device="meta")
        taken = x.to(torch.bfloat16)
        call = kernels.vertices_to_cells
    before = call.launches
    with pytest.raises(ValueError, match="dtype"):
        call(x, gt)
    with pytest.raises(ValueError, match="is on cpu"):
        call(taken, gt)
    assert call.launches == before


def test_padded_rows_do_not_touch_live_rows_unfused(graphs):
    """The unfused block's kernels: changing every padded latent leaves the
    live outputs of K3, K5 and K4 unchanged."""
    _, gt = graphs
    rng = np.random.default_rng(12)
    _, ct = _latents(rng, gt.num_cells, "bfloat16")
    _, et = _latents(rng, gt.num_faces, "bfloat16")
    cm, fm = gt.cell_mask, gt.face_mask
    assert not cm.all() and not fm.all()
    ct2, et2 = ct.clone(), et.clone()
    ct2[~cm] = 7.0
    et2[~fm] = -5.0

    def run(c, e):
        mean = kernels.vertices_to_cells(kernels.edges_to_vertices(e, gt), gt)
        return (mean, *kernels.gather_face_cells(c, gt))

    for x, y, m in zip(run(ct, et), run(ct2, et2), (cm, fm, fm)):
        torch.testing.assert_close(x[m], y[m], rtol=0, atol=0)


def test_padded_rows_do_not_touch_live_rows(graphs):
    """Padded faces and cells point at the last padded slot: changing every
    padded latent leaves the live outputs of K1-K3 unchanged."""
    _, gt = graphs
    rng = np.random.default_rng(6)
    _, ct = _latents(rng, gt.num_cells, "bfloat16")
    _, et = _latents(rng, gt.num_faces, "bfloat16")
    wf = _port_weights(_flax_mlp_params(rng, 3 * H), 3 * H, torch.bfloat16)
    wc = _port_weights(_flax_mlp_params(rng, H + H // 2), H + H // 2,
                       torch.bfloat16)
    cm, fm, vm = gt.cell_mask, gt.face_mask, gt.vertex_mask
    assert not cm.all() and not fm.all() and not vm.all()
    ct2, et2 = ct.clone(), et.clone()
    ct2[~cm] = 7.0
    et2[~fm] = -5.0

    def run(c, e):
        vtx = kernels.edges_to_vertices(e, gt)
        c_raw, c_res = kernels.fused_cell_block(c, vtx, gt, wc, dual_out=True)
        return vtx, c_raw, c_res, kernels.fused_face_block(c_raw, e, gt, wf)

    a, b = run(ct, et), run(ct2, et2)
    for x, y, m in zip(a, b, (vm, cm, cm, fm)):
        torch.testing.assert_close(x[m], y[m], rtol=0, atol=0)


def test_kernel_weights_split_matches_dense_layers():
    """``kernel_weights`` holds each Dense kernel as (inputs, outputs): the
    fused input order [e | x[own] | x[nbr]] hits W0's rows in order."""
    mlp = MLP(3 * H, H, H, generator=torch.Generator().manual_seed(0))
    w = mlp.kernel_weights(torch.float32)
    x = torch.randn(5, 3 * H, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(x @ w.w0 + w.b0, mlp.dense0(x))
    assert mlp.kernel_weights(torch.float32) is w          # cached
    with torch.no_grad():
        mlp.dense0.weight.mul_(2.0)
    assert mlp.kernel_weights(torch.float32) is not w      # in-place change seen


# ---- K6/K7: the dense-table kernels ----------------------------------------
# Held against the JAX package's dense-table Pallas kernels on a batch of two
# meshes on the table route (the wrappers loop over the graphs, the port
# launches once per batch). The roll form and K7 sum in f32 in another order
# and round once: within one bf16 step. The cf form copies rows (one weight
# of 1 per row): exact.

@pytest.fixture(scope="module")
def table_graphs():
    from gnn_fluid_dynamics_tpu.data.pipeline import MeshDataset as JaxDataset
    from gnn_fluid_dynamics_tpu.data.pipeline import Trajectory as JaxTrajectory
    from gnn_fluid_dynamics_tpu_torch.data.pipeline import (MeshDataset,
                                                            Trajectory,
                                                            rollout_batch)
    from gnn_fluid_dynamics_tpu_torch.graph import \
        to_static_bands as torch_to_static_bands
    geoms = [rcm_reorder_geometry(make_geometry("cylinder", n_points=n, seed=s))
             for n, s in ((300, 0), (320, 1))]
    out = {}
    for dtype in ("int8", "bfloat16"):
        def trajs(cls):
            return [cls(mesh_id=f"sim{i}", geom=g, fields={
                "cell_velocity": np.zeros((2, g["cell_pos"].shape[0], 2))})
                for i, g in enumerate(geoms)]
        dj = JaxDataset(trajs(JaxTrajectory), with_banded=True,
                        banded_dtype=dtype)
        dt = MeshDataset(trajs(Trajectory), with_banded=True,
                         banded_dtype=dtype, device="cpu")
        samples = rollout_batch(dt)
        out[dtype] = (to_static_bands(dj.get_batch(samples), derive_idx=False),
                      torch_to_static_bands(dt.get_batch(samples),
                                            derive_idx=False))
    return out


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_table_dual_roll_matches_pallas(table_graphs, dtype):
    gj, gt = table_graphs[dtype]
    assert gj.es_tgt is None and gt.table_route and gt.num_graphs == 2
    rng = np.random.default_rng(13)
    ej, et = _latents(rng, gt.num_faces, "bfloat16")
    want = pallas_agg.aggregate_edges_to_vertices_pallas(ej, gj)[:, :H // 2]
    got = kernels.table_dual(gt.es_onehot, gt.er_onehot, gt.es_off, et,
                             combine_roll=True)
    assert got.dtype == torch.bfloat16 and got.shape == (gt.num_vertices, H // 2)
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)
    # the vertex sums K3 computes from the index vectors
    np.testing.assert_allclose(_np(got), _np(kernels.edges_to_vertices(et, gt)),
                               **BF16_TOL)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_table_dual_cf_matches_pallas_exactly(table_graphs, dtype):
    gj, gt = table_graphs[dtype]
    rng = np.random.default_rng(14)
    cj, ct = _latents(rng, gt.num_cells, "bfloat16")
    want = pallas_agg.gather_face_cells_pallas(cj, gj)
    got = kernels.table_dual(gt.cf_row_onehot, gt.cf_col_onehot,
                             gt.cf_off, ct)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == (gt.num_faces, H)
        np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_table_single_matches_pallas(table_graphs, dtype):
    """K7 with its 1/3 epilogue against the Pallas wrapper on every row:
    padded cells store a weight of 3 on the pad vertex, which both
    multiply."""
    gj, gt = table_graphs[dtype]
    assert int(gt.vc_onehot.max()) == 3
    rng = np.random.default_rng(15)
    vj, vt = _latents(rng, gt.num_vertices, "bfloat16")
    want = pallas_agg.aggregate_vertices_to_cells_pallas(vj, gj)
    got = kernels.table_single(gt.vc_onehot, gt.vc_off,
                               vt[:, :H // 2].contiguous())
    assert got.dtype == torch.float32 and got.shape == (gt.num_cells, H // 2)
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_tables_with_other_weights_match_pallas(dtype):
    """Random tables with weights in -3..3 (not a mesh's 0/1): K6 and K7
    multiply by the stored weight, as the TPU's one-hot product does."""
    rng = np.random.default_rng(16)
    T, B, S = 3, 256, 512
    oh = [np.where(rng.random((T, 128, B)) < 0.02,
                   rng.integers(-3, 4, (T, 128, B)), 0) for _ in range(3)]
    off = np.array([0, 128, 256], np.int32)
    jdt, tdt = DTYPE_PAIRS[dtype]
    ohj = [jnp.asarray(o, jdt) for o in oh]
    oht = [torch.from_numpy(o).to(tdt) for o in oh]
    sj, st = _latents(rng, S, "bfloat16")
    want_a, want_b = pallas_agg.banded_dual_pallas(ohj[0], ohj[1],
                                                   jnp.asarray(off), sj)
    got_a, got_b = kernels.table_dual(oht[0], oht[1], torch.from_numpy(off), st)
    np.testing.assert_allclose(_np(got_a), _np(want_a), **BF16_TOL)
    np.testing.assert_allclose(_np(got_b), _np(want_b), **BF16_TOL)
    want = pallas_agg.banded_dual_pallas(ohj[0], ohj[1], jnp.asarray(off), sj,
                                         combine_roll=H // 2)[:, :H // 2]
    got = kernels.table_dual(oht[0], oht[1], torch.from_numpy(off), st,
                             combine_roll=True)
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)
    want = pallas_agg.banded_single_pallas(ohj[2], jnp.asarray(off), sj)
    want = _np(want)[:, :H // 2] / 3.0
    got = kernels.table_single(oht[2], torch.from_numpy(off),
                               st[:, :H // 2].contiguous())
    np.testing.assert_allclose(_np(got), want, **BF16_TOL)


DTYPE_PAIRS = {"int8": (jnp.int8, torch.int8),
               "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def test_table_weights_round_to_bf16_first():
    """An f32 table's weights are rounded to bf16 before the product, as the
    TPU kernel's ``oh.astype(band.dtype)`` does: (1 + 2**-9) * -1 + 1 * 1
    sums to 0 with the weight rounded (to 1.0) and to -2**-9 without."""
    oh = torch.zeros((1, 128, 128))
    oh[0, 0, 5] = 1.0 + 2.0 ** -9
    oh[0, 0, 6] = 1.0
    src = torch.zeros((128, H), dtype=torch.bfloat16)
    src[5], src[6] = -1.0, 1.0
    off = torch.zeros(1, dtype=torch.int32)
    a, _ = kernels.table_dual(oh, oh, off, src)
    assert float(a[0, 0]) == 0.0
    s = kernels.table_single(oh, off, src[:, :H // 2].contiguous())
    assert float(s[0, 0]) == 0.0
    assert float((oh[0, 0, 5] * src[5, 0].float()) + src[6, 0].float()) != 0.0


def test_cpu_tensors_take_the_plain_version_tables(table_graphs):
    _, gt = table_graphs["int8"]
    rng = np.random.default_rng(17)
    _, et = _latents(rng, gt.num_faces, "bfloat16")
    _, ct = _latents(rng, gt.num_cells, "bfloat16")
    before = (kernels.table_dual.launches, kernels.table_single.launches)
    vtx = kernels.table_dual(gt.es_onehot, gt.er_onehot, gt.es_off, et,
                             combine_roll=True)
    torch.testing.assert_close(vtx, kernels.table_dual_ref(
        gt.es_onehot, gt.er_onehot, gt.es_off, et, True), rtol=0, atol=0)
    torch.testing.assert_close(
        kernels.table_single(gt.vc_onehot, gt.vc_off, vtx),
        kernels.table_single_ref(gt.vc_onehot, gt.vc_off, vtx),
        rtol=0, atol=0)
    torch.testing.assert_close(
        kernels.table_dual(gt.cf_row_onehot, gt.cf_col_onehot, gt.cf_off,
                           ct),
        kernels.table_dual_ref(gt.cf_row_onehot, gt.cf_col_onehot,
                               gt.cf_off, ct), rtol=0, atol=0)
    assert (kernels.table_dual.launches,
            kernels.table_single.launches) == before


@pytest.mark.parametrize("kernel", ["K6", "K7"])
def test_other_devices_never_take_the_plain_version_tables(table_graphs,
                                                           kernel):
    """Off the CPU the tables and sources go to the kernel's argument
    checks, which refuse what the kernel does not take; nothing falls
    back."""
    _, gt = table_graphs["int8"]
    meta = torch.device("meta")
    if kernel == "K6":
        call = kernels.table_dual
        src = torch.empty((gt.num_faces, H), dtype=torch.bfloat16, device=meta)
        args = (gt.es_onehot, gt.er_onehot, gt.es_off)
    else:
        call = kernels.table_single
        src = torch.empty((gt.num_vertices, H // 2), dtype=torch.bfloat16,
                          device=meta)
        args = (gt.vc_onehot, gt.vc_off)
    before = call.launches
    with pytest.raises(ValueError, match="dtype"):
        call(*(a.to(meta) for a in args[:-1]), args[-1].to(meta), src.float())
    with pytest.raises(ValueError, match="dtype"):
        call(args[0].to(meta, torch.int32),
             *(a.to(meta) for a in args[1:]), src)
    with pytest.raises(ValueError, match="is on cpu"):
        call(*args, src)
    assert call.launches == before
