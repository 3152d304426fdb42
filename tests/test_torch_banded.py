"""The port's banded tables and batched graphs against the JAX package's:
``build_banded_tables``, ``canonicalize_tables`` and ``from_geometry(
with_banded=True)`` give the same tables and offsets, exactly (the same
integer and 0/1/3 arithmetic in numpy), for the three table groups the
dense-table kernels read (es/er, vc, cf); ``batch_graphs`` gives the same
index arrays, and tables that apply the same weights to the same source
rows (the same arrays where the meshes' tables were canonicalized first);
so does the in-memory ``MeshDataset``, which does not canonicalize. Also the
route marker that stands in for the JAX package's "no index vectors" test.

Two RCM-ordered cylinder meshes of different sizes (518 and 538 cells)
padded to one shape, so that their band offsets differ, and a third (562
cells) whose cell -> face band is narrower than the first's.
"""

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_fluid_dynamics_tpu.data.pipeline import MeshDataset as JaxMeshDataset
from gnn_fluid_dynamics_tpu.data.pipeline import Trajectory as JaxTrajectory
from gnn_fluid_dynamics_tpu.data.synthetic import (channel_flow_trajectory,
                                                   make_geometry)
from gnn_fluid_dynamics_tpu.graph import banded_tables_for as jax_tables_for
from gnn_fluid_dynamics_tpu.graph import batch_graphs as jax_batch_graphs
from gnn_fluid_dynamics_tpu.graph import from_geometry as jax_from_geometry
from gnn_fluid_dynamics_tpu.graph import to_static_bands as jax_to_static_bands
from gnn_fluid_dynamics_tpu.ops import banded as jax_banded
from gnn_fluid_dynamics_tpu.ops.reorder import rcm_reorder_geometry

from gnn_fluid_dynamics_tpu_torch.data.pipeline import (MeshDataset,
                                                        Trajectory,
                                                        rollout_batch)
from gnn_fluid_dynamics_tpu_torch.graph import (banded_tables_for,
                                                batch_graphs, from_geometry,
                                                to_static_bands,
                                                vertex_incidence_csr)
from gnn_fluid_dynamics_tpu_torch.ops import banded

GROUPS = {"es": ("es_onehot", "er_onehot"), "vc": ("vc_onehot",),
          "cf": ("cf_row_onehot", "cf_col_onehot")}
PAD = {"cell": 640, "face": 1024, "vertex": 384}   # both meshes' shared pad
DTYPES = {"int8": (jnp.int8, torch.int8),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float32": (jnp.float32, torch.float32)}


@pytest.fixture(scope="module")
def geoms():
    return [rcm_reorder_geometry(make_geometry("cylinder", n_points=n, seed=s))
            for n, s in ((300, 0), (320, 1))]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _same_tables(tj, tt):
    for group, keys in GROUPS.items():
        assert getattr(tt, f"{group}_offsets") == getattr(tj, f"{group}_offsets")
        assert tt.sources[group] == tj.sources[group]
        for key in keys:
            np.testing.assert_array_equal(getattr(tt, key), getattr(tj, key),
                                          err_msg=key)


def _same_graph_tables(gj, gt, base=None):
    """The same tables and offsets; ``base``: the first source row of each
    tile's graph in the port's batched offsets, per group."""
    for group, keys in GROUPS.items():
        off = _np(getattr(gt, f"{group}_off"))
        if base is not None:
            off = off - base[group]
        np.testing.assert_array_equal(off, _np(getattr(gj, f"{group}_off")))
        for key in keys:
            a, b = getattr(gt, key), getattr(gj, key)
            assert str(a.dtype).split(".")[-1] == str(b.dtype), key
            np.testing.assert_array_equal(_np(a), _np(b), err_msg=key)


def _operator(oh, off, num_sources):
    """The dense (targets, sources) matrix a table applies: tile t's column
    c weighs source row off[t] + c."""
    oh, off = _np(oh), np.asarray(off)
    t, r, c = np.nonzero(oh)
    out = np.zeros((oh.shape[0] * oh.shape[1], num_sources), np.float32)
    np.add.at(out, (t * oh.shape[1] + r, off[t] + c), oh[t, r, c])
    return out


def _base(g, sources):
    """Per group, the first source row of each tile's graph in a batch."""
    out = {}
    for group, keys in GROUPS.items():
        T = getattr(g, keys[0]).shape[0]
        out[group] = np.repeat(np.arange(g.num_graphs) * sources[group],
                               T // g.num_graphs)
    return out


def _same_graph_operators(gj, gt, sources):
    """Tables that apply the same weights to the same source rows, each band
    inside the batched source."""
    n = gt.num_graphs
    base = _base(gt, sources)
    for group, keys in GROUPS.items():
        off_t = _np(getattr(gt, f"{group}_off"))
        off_j = _np(getattr(gj, f"{group}_off")) + base[group]
        B = getattr(gt, keys[0]).shape[2]
        assert off_t.min() >= 0 and (off_t - base[group]).max() + B <= \
            sources[group]
        for key in keys:
            a, b = getattr(gt, key), getattr(gj, key)
            assert str(a.dtype).split(".")[-1] == str(b.dtype), key
            np.testing.assert_array_equal(
                _operator(a, off_t, n * sources[group]),
                _operator(b, off_j, n * sources[group]), err_msg=key)


def test_build_banded_tables_matches_jax(geoms):
    for geom in geoms:
        _same_tables(jax_tables_for(geom, PAD), banded_tables_for(geom, PAD))
        _same_tables(jax_banded.build_banded_tables(geom),
                     banded.build_banded_tables(geom))


def test_canonicalize_tables_matches_jax(geoms):
    pad = PAD
    want = jax_banded.canonicalize_tables([jax_tables_for(g, pad) for g in geoms])
    got = banded.canonicalize_tables([banded_tables_for(g, pad) for g in geoms])
    assert got[0].es_offsets == got[1].es_offsets
    assert got[0].es_offsets != banded_tables_for(geoms[0], pad).es_offsets \
        or got[1].es_offsets != banded_tables_for(geoms[1], pad).es_offsets
    for tj, tt in zip(want, got):
        _same_tables(tj, tt)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_from_geometry_with_banded_matches_jax(geoms, dtype):
    geom = geoms[0]
    gj = jax_from_geometry(geom, pad_multiple=128, with_banded=True,
                           banded_dtype=DTYPES[dtype][0])
    gt = from_geometry(geom, pad_multiple=128, with_banded=True,
                       banded_dtype=dtype, device="cpu")
    assert gt.table_route
    assert gt.es_onehot.dtype == DTYPES[dtype][1]
    _same_graph_tables(gj, gt)
    _same_graph_tables(jax_to_static_bands(gj, derive_idx=False),
                       to_static_bands(gt, derive_idx=False))


@pytest.mark.parametrize("canonical", [True, False])
def test_batch_graphs_matches_jax(geoms, canonical):
    """Canonicalized tables batch into the JAX package's arrays, with each
    graph's first source row added to its tiles' offsets (one launch per
    batched table). Tables as each mesh's own widen to the batch's band:
    tiles whose band would run past their graph's source rows start lower,
    so the tables differ from the JAX package's padded ones but apply the
    same weights to the same rows."""
    pad = PAD
    if not canonical:
        geoms = [geoms[0], rcm_reorder_geometry(
            make_geometry("cylinder", n_points=320, seed=3))]
    tj = [jax_tables_for(g, pad) for g in geoms]
    tt = [banded_tables_for(g, pad) for g in geoms]
    if canonical:
        tj, tt = jax_banded.canonicalize_tables(tj), banded.canonicalize_tables(tt)
    else:
        # the second mesh's last cf tiles start at 512 with width 128: at
        # the first's width 256 they must start lower
        assert tt[1].cf_row_onehot.shape[2] < tt[0].cf_row_onehot.shape[2]
        assert max(tt[1].cf_offsets) + tt[0].cf_row_onehot.shape[2] > pad["cell"]
    gjs = [jax_from_geometry(g, dt=0.01 * (i + 1), reynolds=100.0 * i,
                             pad_to=pad, with_banded=True, banded_tables=t,
                             banded_dtype=jnp.int8)
           for i, (g, t) in enumerate(zip(geoms, tj))]
    gts = [from_geometry(g, dt=0.01 * (i + 1), reynolds=100.0 * i, pad_to=pad,
                         with_banded=True, banded_tables=t,
                         banded_dtype="int8", device="cpu")
           for i, (g, t) in enumerate(zip(geoms, tt))]
    bj, bt = jax_batch_graphs(gjs), batch_graphs(gts)
    assert bt.num_graphs == bj.num_graphs == 2 and bt.table_route
    for key in ("cell_edge_index", "vertex_edge_index", "face_index",
                "vertex_face", "cell_mask", "face_mask", "vertex_mask",
                "face_boundary_mask", "cell_batch", "face_batch", "dt",
                "reynolds", "cell_pos", "face_area", "cell_normal"):
        np.testing.assert_array_equal(_np(getattr(bt, key)),
                                      _np(getattr(bj, key)), err_msg=key)
    sources = {"es": pad["face"], "vc": pad["vertex"], "cf": pad["cell"]}
    if canonical:
        _same_graph_tables(bj, bt, _base(bt, sources))
    _same_graph_operators(bj, bt, sources)
    ptr, row = vertex_incidence_csr(_np(bt.vertex_edge_index),
                                    bt.num_vertices)
    np.testing.assert_array_equal(bt.vertex_inc_ptr.numpy(), ptr)
    np.testing.assert_array_equal(bt.vertex_inc_row.numpy(), row)


def test_route_marker(geoms):
    """A graph built with tables is on the table route until
    ``to_static_bands`` derives the index route; a graph without tables is
    on the index route and stays there."""
    geom = geoms[0]
    gt = from_geometry(geom, pad_multiple=128, with_banded=True, device="cpu")
    assert gt.table_route
    assert to_static_bands(gt, derive_idx=False).table_route
    idx = to_static_bands(gt, derive_idx=True)
    assert not idx.table_route and idx.es_onehot is not None
    assert not to_static_bands(idx, derive_idx=False).table_route
    plain = from_geometry(geom, pad_multiple=128, device="cpu")
    assert not plain.table_route and plain.es_onehot is None
    assert to_static_bands(plain) is plain
    with pytest.raises(ValueError, match="one route"):
        batch_graphs([gt, idx])


def test_bands_past_the_source_rows_are_refused(geoms):
    with pytest.raises(ValueError, match="past the"):
        from_geometry(geoms[0], pad_multiple=128, with_banded=True,
                      band_pad={"vc": 512}, device="cpu")


def test_mesh_dataset_matches_jax(geoms):
    """The in-memory dataset's validation batch: the same windows,
    ground-truth stacks, and tables that apply the same weights to the same
    rows as the JAX package's canonical ones (the port keeps each mesh's
    own)."""
    def trajs(cls):
        out = []
        for i, g in enumerate(geoms):
            f = channel_flow_trajectory(g, num_timesteps=6, dt=0.01)
            out.append(cls(mesh_id=f"sim{i}", geom=g, fields=f))
        return out

    dj = JaxMeshDataset(trajs(JaxTrajectory), with_banded=True,
                        banded_dtype="int8", pad_multiple=128)
    dt = MeshDataset(trajs(Trajectory), with_banded=True, banded_dtype="int8",
                     pad_multiple=128, device="cpu")
    assert rollout_batch(dt) == rollout_batch(dj) == [("sim0", 0), ("sim1", 0)]
    assert dt.sim_ids() == dj.sim_ids() and dt.pad_to == dj.pad_to
    gj = jax_to_static_bands(dj.get_batch(rollout_batch(dj)), derive_idx=False)
    gt = to_static_bands(dt.get_batch(rollout_batch(dt)), derive_idx=False)
    assert gt.table_route
    _same_graph_operators(gj, gt, {"es": dt.pad_to["face"],
                                   "vc": dt.pad_to["vertex"],
                                   "cf": dt.pad_to["cell"]})
    for key in ("cell_velocity", "face_flux", "cell_edge_index", "dt"):
        np.testing.assert_array_equal(_np(getattr(gt, key)),
                                      _np(getattr(gj, key)), err_msg=key)
    for a, b in zip(dt.trajectory_targets(["sim0", "sim1"], 0, 3),
                    dj.trajectory_targets(["sim0", "sim1"], 0, 3)):
        np.testing.assert_array_equal(_np(a), _np(b))
