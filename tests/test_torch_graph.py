"""The port's mesh generation, reordering and MeshGraph construction give the
same arrays, bit for bit, as the JAX package's on the same seed."""

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
import numpy as np
import pytest
import torch

from gnn_fluid_dynamics_tpu.data import synthetic as jsyn
from gnn_fluid_dynamics_tpu import graph as jgraph
from gnn_fluid_dynamics_tpu.ops import reorder as jreorder
from gnn_fluid_dynamics_tpu.ops.segment import build_vertex_incidence

from gnn_fluid_dynamics_tpu_torch.data import synthetic as tsyn
from gnn_fluid_dynamics_tpu_torch import graph as tgraph
from gnn_fluid_dynamics_tpu_torch.ops import reorder as treorder

MESHES = {
    "structured": dict(nx=8, ny=6),
    "cylinder": dict(n_points=300, seed=0),
}


def _assert_same_dict(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_make_geometry_bit_identical(kind):
    _assert_same_dict(tsyn.make_geometry(kind, **MESHES[kind]),
                      jsyn.make_geometry(kind, **MESHES[kind]))


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_rcm_reorder_bit_identical(kind):
    geom = jsyn.make_geometry(kind, **MESHES[kind])
    _assert_same_dict(treorder.rcm_reorder_geometry(geom),
                      jreorder.rcm_reorder_geometry(geom))


@pytest.mark.parametrize("traj", ["channel_flow_trajectory",
                                  "taylor_green_trajectory"])
def test_trajectories_bit_identical(traj):
    geom = jsyn.make_geometry("cylinder", **MESHES["cylinder"])
    _assert_same_dict(getattr(tsyn, traj)(geom, num_timesteps=3, dt=0.01),
                      getattr(jsyn, traj)(geom, num_timesteps=3, dt=0.01))


@pytest.mark.parametrize("pad", [0, 128])
@pytest.mark.parametrize("kind", sorted(MESHES))
def test_from_geometry_bit_identical(kind, pad):
    geom = jreorder.rcm_reorder_geometry(jsyn.make_geometry(kind, **MESHES[kind]))
    fields = jsyn.channel_flow_trajectory(geom, num_timesteps=2, dt=0.01)
    gj = jgraph.from_geometry(geom, fields, dt=0.02, pad_multiple=pad)
    gt = tgraph.from_geometry(geom, fields, dt=0.02, pad_multiple=pad,
                              device="cpu")
    compared = 0
    for field in gt.__dataclass_fields__:
        if field not in jgraph.MeshGraph.__dataclass_fields__:
            continue
        a, b = getattr(gt, field), getattr(gj, field)
        if field == "num_graphs":
            assert a == b
            continue
        assert (a is None) == (b is None), field
        if a is None:
            continue
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, field
        np.testing.assert_array_equal(a.numpy(), b, err_msg=field)
        compared += 1
    assert compared >= 27


@pytest.mark.parametrize("pad", [0, 128])
def test_vertex_csr_matches_incidence_table(pad):
    """The kernel's CSR lists, per vertex, the same (face, half) incidences in
    the same order as the JAX package's padded incidence table."""
    geom = jsyn.make_geometry("cylinder", **MESHES["cylinder"])
    g = tgraph.from_geometry(geom, pad_multiple=pad, device="cpu")
    inc = build_vertex_incidence(g.vertex_edge_index.numpy(), g.num_vertices)
    ptr, rows = g.vertex_inc_ptr.numpy(), g.vertex_inc_row.numpy()
    assert ptr[-1] == 2 * g.num_faces == rows.shape[0]
    for v in range(g.num_vertices):
        want = (2 * inc.edge_id[v] + inc.half[v])[inc.valid[v]]
        np.testing.assert_array_equal(rows[ptr[v]:ptr[v + 1]], want)


def test_from_geometry_rejects_out_of_range_ids():
    geom = dict(jsyn.make_geometry("structured", nx=4, ny=3))
    geom["vertex_face"] = geom["vertex_face"].copy()
    geom["vertex_face"][0, 0] = geom["vertex_pos"].shape[0]
    with pytest.raises(ValueError, match="vertex_face"):
        tgraph.from_geometry(geom, device="cpu")


def test_from_geometry_needs_a_card_unless_cpu():
    geom = tsyn.make_geometry("structured", nx=4, ny=3)
    if torch.cuda.is_available():
        assert tgraph.from_geometry(geom).cell_pos.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tgraph.from_geometry(geom)
