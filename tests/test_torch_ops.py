"""The port's plain tensor ops against their JAX counterparts on seeded
inputs: aggregation semantics, flux conversion, cell->face interpolation,
the rollout metrics, feature assembly and the normalization statistics.
All in f32; tolerance rtol 1e-6, atol 1e-6 (the same arithmetic, summed in
another order at most)."""

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_fluid_dynamics_tpu.data.synthetic import (channel_flow_trajectory,
                                                   make_geometry)
from gnn_fluid_dynamics_tpu.graph import from_geometry as jax_from_geometry
from gnn_fluid_dynamics_tpu.models import losses as jlosses
from gnn_fluid_dynamics_tpu.models import normalizer as jnorm
from gnn_fluid_dynamics_tpu.models import transforms as jtransforms
from gnn_fluid_dynamics_tpu.ops import fvm as jfvm
from gnn_fluid_dynamics_tpu.ops import geometry as jgeometry
from gnn_fluid_dynamics_tpu.ops import segment as jseg

from gnn_fluid_dynamics_tpu_torch.graph import from_geometry
from gnn_fluid_dynamics_tpu_torch.models import losses as tlosses
from gnn_fluid_dynamics_tpu_torch.models import normalizer as tnorm
from gnn_fluid_dynamics_tpu_torch.models import transforms as ttransforms
from gnn_fluid_dynamics_tpu_torch.ops import fvm as tfvm
from gnn_fluid_dynamics_tpu_torch.ops import geometry as tgeometry
from gnn_fluid_dynamics_tpu_torch.ops import segment as tseg

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def graphs():
    geom = make_geometry("cylinder", n_points=300, seed=0)
    fields = channel_flow_trajectory(geom, num_timesteps=2, dt=0.01)
    return (jax_from_geometry(geom, fields, pad_multiple=128),
            from_geometry(geom, fields, pad_multiple=128, device="cpu"))


def _pair(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


def test_edges_to_vertices_and_cell_mean(graphs):
    gj, gt = graphs
    rng = np.random.default_rng(0)
    fj, ft = _pair(rng, gt.num_faces, 8)
    rj, rt = _pair(rng, gt.num_faces, 8)
    vj = jseg.aggregate_edges_to_vertices_scatter(fj, rj, gj.vertex_edge_index,
                                                  gj.num_vertices)
    vt = tseg.aggregate_edges_to_vertices_scatter(ft, rt, gt.vertex_edge_index,
                                                  gt.num_vertices)
    _close(vt, vj)
    _close(tseg.gather_vertices_to_cells(vt, gt.vertex_face),
           jseg.gather_vertices_to_cells(vj, gj.vertex_face))


def test_face_flux_to_cell_flux_and_divergence(graphs):
    gj, gt = graphs
    rng = np.random.default_rng(1)
    fj, ft = _pair(rng, gt.num_faces, 1)
    cj = jfvm.face_flux_to_cell_flux_g(fj, gj)
    ct = tfvm.face_flux_to_cell_flux_g(ft, gt)
    _close(ct, cj)
    _close(tfvm.divergence_from_cell_flux(ct[..., 0]),
           jfvm.divergence_from_cell_flux(cj[..., 0]))


def test_cell_to_face(graphs):
    gj, gt = graphs
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng, gt.num_cells, 2)
    _close(tgeometry.cell_to_face(xt, gt.cell_edge_index, gt.face_pos,
                                  gt.cell_pos),
           jgeometry.cell_to_face(xj, gj.cell_edge_index, gj.face_pos,
                                  gj.cell_pos), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fn", ["rel_mse_per_graph", "mse_per_graph"])
def test_rollout_metrics(graphs, fn):
    gj, gt = graphs
    rng = np.random.default_rng(3)
    pj, pt = _pair(rng, gt.num_cells, 2)
    tj, tt = _pair(rng, gt.num_cells, 2)
    want = getattr(jlosses, fn)(pj, tj, gj.cell_mask, gj.cell_batch, 1)
    got = getattr(tlosses, fn)(pt, tt, gt.cell_mask, gt.cell_batch, 1)
    _close(got, want)


def test_standard_face_features(graphs):
    gj, gt = graphs
    rng = np.random.default_rng(4)
    vj, vt = _pair(rng, gt.num_cells, 2)
    bj, bt = _pair(rng, gt.num_faces, 2)
    xj, mj = jtransforms.standard_face_features(gj, vj, 5, bc_velocity=bj)
    xt, mt = ttransforms.standard_face_features(gt, vt, 5, bc_velocity=bt)
    _close(xt, xj)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(
        ttransforms.rollout_bc_mask(gt.face_type).numpy(),
        np.asarray(jtransforms.rollout_bc_mask(gj.face_type)))


def test_normalization_round_trip_and_stats(graphs):
    _, gt = graphs
    rng = np.random.default_rng(5)
    x = rng.normal(2.0, 3.0, size=(gt.num_cells, 2)).astype(np.float32)
    nmap_j = jnorm.NormalizationMap(
        {"a": jnorm.StatSpec("z_score", ("cell_x", 0, 1)),
         "b": jnorm.StatSpec("z_score", ("cell_x", 1, 2))},
        (jnorm.Field("a", "cell_x", 0, 1, "a"),
         jnorm.Field("b", "cell_x", 1, 2, "b")), ())
    nmap_t = tnorm.NormalizationMap(
        {"a": tnorm.StatSpec("z_score", ("cell_x", 0, 1)),
         "b": tnorm.StatSpec("z_score", ("cell_x", 1, 2))},
        (tnorm.Field("a", "cell_x", 0, 1, "a"),
         tnorm.Field("b", "cell_x", 1, 2, "b")), ())
    acc_j, acc_t = jnorm.StatsAccumulator(nmap_j), tnorm.StatsAccumulator(nmap_t)
    for half in (slice(0, 300), slice(300, None)):   # two batches: Welford merge
        acc_j.update({"cell_x": jnp.asarray(x[half])},
                     {"cell_x": jnp.asarray(np.asarray(gt.cell_mask)[half])})
        acc_t.update({"cell_x": torch.from_numpy(x[half])},
                     {"cell_x": gt.cell_mask[half]})
    sj, st = acc_j.finalize(), acc_t.finalize()
    assert sj == st
    stats_j = jnorm.stats_to_arrays(sj)
    stats_t = tnorm.stats_to_tensors(st, "cpu")
    nj = jnorm.normalize_inputs({"cell_x": jnp.asarray(x)}, nmap_j, stats_j)
    nt = tnorm.normalize_inputs({"cell_x": torch.from_numpy(x)}, nmap_t, stats_t)
    _close(nt["cell_x"], nj["cell_x"])
    back = tnorm.normalize_inputs(nt, nmap_t, stats_t, inverse=True)
    _close(back["cell_x"], x, rtol=1e-5, atol=1e-5)


def test_fluxd_normalisation_map_and_outputs_match_jax():
    """FluxD's map (registry, input and output fields) is the JAX package's,
    and ``normalize_outputs`` (both directions) gives the same numbers."""
    from gnn_fluid_dynamics_tpu.models import get_model_class
    from gnn_fluid_dynamics_tpu.models.base import ModelConfig as JaxModelConfig

    from gnn_fluid_dynamics_tpu_torch.models.base import ModelConfig
    from gnn_fluid_dynamics_tpu_torch.models.flux import FluxD

    jm = get_model_class("FluxD")(JaxModelConfig(name="FluxD", hidden_width=8,
                                                 mp_num=1))
    tm = FluxD(ModelConfig(hidden_width=8, mp_num=1), device="cpu")
    assert [f.__dict__ for f in tm.nmap.inputs] == \
        [f.__dict__ for f in jm.nmap.inputs]
    assert [f.__dict__ for f in tm.nmap.outputs] == \
        [f.__dict__ for f in jm.nmap.outputs]
    assert {k: v.__dict__ for k, v in tm.nmap.registry.items()} == \
        {k: v.__dict__ for k, v in jm.nmap.registry.items()}
    rng = np.random.default_rng(6)
    stats = {k: {"mean": float(rng.normal()), "std": float(rng.uniform(0.1, 2)),
                 "min": -1.0, "max": 1.0} for k in jm.nmap.registry}
    cj, ct = _pair(rng, 10, 2)
    fj, ft = _pair(rng, 12, 6)
    for inverse in (False, True):
        want = jnorm.normalize_outputs({"cell_out": cj, "face_out": fj},
                                       jm.nmap, jnorm.stats_to_arrays(stats),
                                       inverse=inverse)
        got = tnorm.normalize_outputs({"cell_out": ct, "face_out": ft},
                                      tm.nmap, tnorm.stats_to_tensors(stats, "cpu"),
                                      inverse=inverse)
        _close(got["cell_out"], want["cell_out"])
        _close(got["face_out"], want["face_out"])
