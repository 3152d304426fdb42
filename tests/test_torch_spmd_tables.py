"""Space sharding on the table route (``parallel/spmd.py``: each rank's own
banded tables for K6/K7) on the CPU with gloo: the partition of a graph
with int8 tables in the test process, and sharded rollouts on the table
route in a 2-rank and a 4-rank group of processes (``torch.multiprocessing``
on ``tests/torch_spmd_ranks.py``'s ``tables_main``), against the port's
single process on the same table route and the JAX package's
``make_spmd_rollout`` on a graph on its table route (Pallas in interpret
mode, partitioned over the conftest's host devices).

The mesh is ``test_torch_spmd.py``'s: the RCM-ordered 300-point cylinder
(518 cells, 851 faces, padded to 640 and 896), its channel flow, order-1
MLS weights; the models hidden 16, 2 blocks, on the kernel route
(``"pallas"``: on the CPU each kernel wrapper runs its plain version),
weights from the JAX package's seeded init.

Tolerances:

* a rank's tables against the tables of its local geometry (its index
  arrays mapped to its rows, built here by ``ops.banded``): bit for bit;
  applied to random f32 sources against the index tables' sums at the
  rows an owned row reads, within 1e-6 of the largest (the sums run in
  another order);
* a sharded rollout against the single process's table route: the
  fields bit for bit on the live rows (a local band holds a tile's
  nonzero entries in the global order, its other columns zero, and the
  plain versions' sums come out alike), the metrics, sums of per-rank
  partial sums, within METRIC_RTOL;
* against the JAX package: BF16_TOL of each field's largest magnitude, and
  its single-device metrics within BF16_TOL.
"""

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
import shutil

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from torch_spmd_ranks import STEPS, build_model, table_graph, tables_main

from gnn_fluid_dynamics_tpu.data.synthetic import (channel_flow_trajectory,
                                                   make_geometry)
from gnn_fluid_dynamics_tpu.graph import from_geometry as jax_from_geometry
from gnn_fluid_dynamics_tpu.graph import to_static_bands as jax_static_bands
from gnn_fluid_dynamics_tpu.models import get_model_class as jax_model_class
from gnn_fluid_dynamics_tpu.models.base import ModelConfig as JaxModelConfig
from gnn_fluid_dynamics_tpu.models.base import feature_masks as jax_masks
from gnn_fluid_dynamics_tpu.models.normalizer import \
    StatsAccumulator as JaxStatsAccumulator
from gnn_fluid_dynamics_tpu.ops.mls import compute_mls_weights
from gnn_fluid_dynamics_tpu.ops.reorder import rcm_reorder_geometry
from gnn_fluid_dynamics_tpu.parallel import (make_mesh_spatial,
                                             make_spmd_rollout, replicate_2d,
                                             shard_graph_spatial)
from gnn_fluid_dynamics_tpu.rollout import engine as jax_engine

from gnn_fluid_dynamics_tpu_torch.graph import to_static_bands
from gnn_fluid_dynamics_tpu_torch.ops import kernels
from gnn_fluid_dynamics_tpu_torch.ops.banded import build_banded_tables
from gnn_fluid_dynamics_tpu_torch.parallel import spmd
from gnn_fluid_dynamics_tpu_torch.rollout import engine
from gnn_fluid_dynamics_tpu_torch.weights import params_from_flax

HIDDEN, MP = 16, 2
METRIC_RTOL = 1e-5
BF16_TOL = 4e-2
TABLE_CASES = ("FluxD", "FvgnF", "MgnA", "ConservativeH")
# kernel wrapper calls per step on the table route: the GN blocks' K6
# (es/er, and cf before the face MLP) and K7; ConservativeH's blocks
# gather their cells by index (no cf) and take K6's wide roll
CALLS_PER_STEP = {"FluxD": {"table_dual": 2 * MP, "table_single": MP},
                  "FvgnF": {"table_dual": 2 * MP, "table_single": MP},
                  "MgnA": {"table_dual": 2 * MP, "table_single": MP},
                  "ConservativeH": {"table_dual": MP, "table_single": MP}}
# exchanges per step: the encoder's 2 (ConservativeH's face latents in one),
# 2 a block, the face decoder's output, the new cell state (MgnA has no
# face decoder)
EXCHANGES_PER_STEP = {"FluxD": 8, "FvgnF": 8, "MgnA": 7, "ConservativeH": 8}


@pytest.fixture(scope="module")
def data():
    """The mesh, and per case the JAX model on its table route with its
    statistics and variables."""
    geom = rcm_reorder_geometry(make_geometry("cylinder", n_points=300, seed=0))
    fields = channel_flow_trajectory(geom, num_timesteps=STEPS + 2, dt=0.01)
    mls = {}
    for loc in ("cell", "face"):
        nb, w = compute_mls_weights(geom[f"{loc}_pos"], 1)
        mls[f"{loc}_grad_weights"], mls[f"{loc}_grad_neighbours"] = w, nb
    pad = ((0, 0), (0, 640 - geom["cell_pos"].shape[0]), (0, 0))
    gt = [np.pad(fields[k][1:STEPS + 1], pad).astype(np.float32)
          for k in ("cell_velocity", "cell_pressure")]
    window = {k: v[:2] for k, v in fields.items()}
    window.update(mls)
    jg = jax_static_bands(jax_from_geometry(geom, window, dt=0.01,
                                            pad_multiple=128,
                                            with_banded=True),
                          derive_idx=False)
    assert jg.cf_row_idx is None and jg.hv_onehot is not None
    models = {}
    for name in TABLE_CASES:
        jm = jax_model_class(name)(JaxModelConfig(
            name=name, hidden_width=HIDDEN, mp_num=MP, aggregation="pallas"))
        _, feats = jm.transform_rollout(jg)
        acc = JaxStatsAccumulator(jm.nmap)
        acc.update(feats, jax_masks(jg, feats))
        stats = acc.finalize()
        jm.set_stats(stats)
        variables = jm.init(jax.random.PRNGKey(0), jg, feats)
        models[name] = (jm, feats, variables, {
            k: {s: float(v) for s, v in d.items()} for k, d in stats.items()})
    return {"geom": geom, "fields": fields, "mls": mls, "gt": gt,
            "jax_graph": jg, "models": models}


def _spec(data, name):
    _, _, variables, stats = data["models"][name]
    return {"name": name, "stats": stats,
            "config": {"hidden_width": HIDDEN, "mp_num": MP,
                       "aggregation": "pallas", "scale_init": None}
            if name == "FluxD" else
            {"hidden_width": HIDDEN, "mp_num": MP, "aggregation": "pallas"},
            "state_dict": params_from_flax(variables)}


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    """The 2-rank and the 4-rank groups of ``tables_main``, started once
    together; returns ``load(world, rank)`` and the inputs."""
    work = tmp_path_factory.mktemp("spmd_tables")
    inputs = {"geom": data["geom"], "fields": data["fields"],
              "mls": data["mls"], "ground_truth": data["gt"],
              "table_rollouts": {name: _spec(data, name)
                                 for name in TABLE_CASES}}
    torch.save(inputs, work / "inputs.pt")
    groups = {n: mp.spawn(tables_main, args=(n, str(work)), nprocs=n,
                          join=False) for n in (2, 4)}

    def load(world, rank=0):
        while not groups[world].join():
            pass
        return torch.load(work / f"tables_{world}_rank{rank}.pt",
                          weights_only=False)
    yield load, inputs
    shutil.rmtree(work, ignore_errors=True)


# ---- the partition of a graph with tables ----------------------------------------

def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def parts(data):
    """The port's table-route graph and its 2- and 4-way local graphs."""
    g = table_graph({"geom": data["geom"], "fields": data["fields"],
                     "mls": data["mls"]})
    out = {}
    for n in (2, 4):
        part = spmd.partition(g, n)
        out[n] = (part, [spmd.local_graph(g, part, s) for s in range(n)])
    return g, out


def _local_index(g, lg):
    """The local graph's index arrays, mapped here from the global graph's
    by the rows it holds (an index leaving them points at the pad row), and
    the cf entries kept: those that do not leave."""
    gid = {k: _np(v) for k, v in lg.halo.gid.items()}
    held = {"cell": lg.num_cells, "face": lg.num_faces,
            "vertex": lg.num_vertices}
    n_held = {}
    for kind, ids in gid.items():
        last = {"cell": g.num_cells, "face": g.num_faces,
                "vertex": g.num_vertices}[kind] - 1
        n_held[kind] = int(np.flatnonzero(ids == last)[0])
    g2l = {}
    for kind, n in n_held.items():
        m = np.full(gid[kind].max() + 2, held[kind] - 1, np.int64)
        m[gid[kind][:n]] = np.arange(n)
        g2l[kind] = m

    def local(name, src, dst):
        x = _np(getattr(g, name)).astype(np.int64)[:, gid[src][:n_held[src]]]
        x = g2l[dst][x]
        return np.pad(x, ((0, 0), (0, held[src] - n_held[src])),
                      constant_values=held[dst] - 1)
    index = {"vertex_edge_index": local("vertex_edge_index", "face", "vertex"),
             "vertex_face": local("vertex_face", "cell", "vertex"),
             "cell_edge_index": local("cell_edge_index", "face", "cell")}
    keep = np.ones((2, held["face"]), bool)
    keep[:, :n_held["face"]] = (index["cell_edge_index"][:, :n_held["face"]]
                                != held["cell"] - 1)
    return index, keep, n_held


@pytest.mark.parametrize("n", [2, 4])
def test_local_tables_are_the_tables_of_the_local_geometry(parts, n):
    """Each rank's es/er, cf and vc tables and offsets equal, bit for bit,
    the tables ``ops.banded`` builds from its local index arrays (the
    global ones mapped to its rows here), without the cf entries of a
    ghost face's cell the rank does not hold; the graph stays on the table
    route."""
    g, by_n = parts
    for s, lg in enumerate(by_n[n][1]):
        assert lg.table_route and lg.es_onehot.dtype == torch.int8
        index, keep, n_held = _local_index(g, lg)
        geom = dict(index)
        for kind, rows in (("cell", lg.num_cells), ("face", lg.num_faces),
                           ("vertex", lg.num_vertices)):
            geom[f"{kind}_pos"] = np.zeros((rows, 2))
        want = build_banded_tables(geom, cf_valid=keep)
        for key in ("es_onehot", "er_onehot", "vc_onehot", "cf_row_onehot",
                    "cf_col_onehot"):
            np.testing.assert_array_equal(
                _np(getattr(lg, key).float()), getattr(want, key), key)
        for group in ("es", "vc", "cf"):
            np.testing.assert_array_equal(_np(getattr(lg, f"{group}_off")),
                                          getattr(want, f"{group}_offsets"))
        widths = spmd.band_widths(lg)
        print(f"1 x {n} rank {s}: band widths {widths}, global "
              f"{spmd.band_widths(g)}; cf entries left out "
              f"{int((~keep).sum())}")
        # only a live ghost face drops an entry, never an owned one
        dropped = np.flatnonzero(~keep.all(0))
        assert np.all(dropped < n_held["face"])
        assert not _np(lg.face_mask)[dropped].any()


@pytest.mark.parametrize("n", [2, 4])
def test_local_tables_sum_as_the_index_tables(parts, n):
    """The plain versions of K6 and K7 on each rank's tables, on random f32
    sources, against the index tables' sums: es/er (the vertex sums) at the
    vertices of owned cells, vc at the owned cells, cf at the owned
    faces."""
    _, by_n = parts
    gen = torch.Generator().manual_seed(3)
    for lg in by_n[n][1]:
        own_c, own_f = lg.cell_mask, lg.face_mask
        e = torch.randn(lg.num_faces, 32, generator=gen)
        vtx = kernels.table_dual_ref(lg.es_onehot, lg.er_onehot, lg.es_off,
                                     e, combine_roll=True)
        vei = lg.vertex_edge_index.long()
        want = torch.zeros(lg.num_vertices, 16).index_add_(
            0, vei[0], e[:, :16]).index_add_(0, vei[1], e[:, 16:])
        at = torch.unique(lg.vertex_face[:, own_c].long())
        torch.testing.assert_close(vtx[at], want[at], rtol=0,
                                   atol=1e-6 * float(want.abs().max()))
        v = torch.randn(lg.num_vertices, 16, generator=gen)
        cm = kernels.table_single_ref(lg.vc_onehot, lg.vc_off, v)
        want = v[lg.vertex_face.long()].mean(0)
        torch.testing.assert_close(cm[own_c], want[own_c], rtol=0,
                                   atol=1e-6 * float(want.abs().max()))
        c = torch.randn(lg.num_cells, 16, generator=gen)
        row, col = kernels.table_dual_ref(lg.cf_row_onehot, lg.cf_col_onehot,
                                          lg.cf_off, c)
        cei = lg.cell_edge_index.long()
        assert torch.equal(row[own_f], c[cei[0]][own_f])
        assert torch.equal(col[own_f], c[cei[1]][own_f])


def test_local_graph_takes_its_route(parts):
    """A local graph keeps its whole graph's route: ``to_static_bands``
    with ``derive_idx`` puts it on the index route, without it it stays on
    the table route; a graph with tables on the index route shards into
    local graphs on the index route that carry their tables."""
    g, by_n = parts
    lg = by_n[2][1][0]
    assert to_static_bands(lg, derive_idx=False).table_route
    index = to_static_bands(lg)
    assert not index.table_route and index.es_onehot is lg.es_onehot
    part = by_n[2][0]
    lg_index = spmd.local_graph(to_static_bands(g), part, 1)
    assert not lg_index.table_route
    assert torch.equal(lg_index.vc_onehot, by_n[2][1][1].vc_onehot)


# ---- the sharded rollouts on the table route ---------------------------------------

def _live(graph, key, v):
    mask = graph.face_mask if key.startswith("face") else graph.cell_mask
    return v[mask] if key == "final_cell_state" else v[:, mask]


@pytest.fixture(scope="module")
def singles(ranks, parts):
    """Per case, the port's single-process rollout on the table route."""
    _, inputs = ranks
    g, _ = parts
    gt = [torch.from_numpy(x) for x in inputs["ground_truth"]]
    out = {}
    for name, spec in inputs["table_rollouts"].items():
        m = build_model(spec)
        _, feats = m.transform_rollout(g)
        out[name] = engine.rollout_scan(m, g, feats, *gt, engine.RolloutConfig(
            num_steps=STEPS, compute_error=True, save_fields=True))
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", TABLE_CASES)
def test_sharded_table_rollout_equals_the_single_process(ranks, parts,
                                                         singles, name,
                                                         world):
    """The 1 x ``world`` rollout on the table route (every rank on its own
    tables) against the single process's table route: the gathered fields
    bit for bit on the live rows, the metrics within METRIC_RTOL; the
    kernel wrappers it called were the table route's alone, as many a step
    as the single process calls, and it refreshed EXCHANGES_PER_STEP row
    sets a step."""
    load, _ = ranks
    g, _ = parts
    for r in range(world):
        got = load(world, r)
        assert got["table_route"]
        print(f"1 x {world} rank {r}: band widths {got['bands']}, local "
              f"cells/faces/vertices {got['local_rows']}")
        case = got[name]
        assert case["calls"] == {k: v * STEPS for k, v in
                                 CALLS_PER_STEP[name].items()}
        assert case["exchanges"] == EXCHANGES_PER_STEP[name] * STEPS
    got = load(world)[name]
    errors, fields = singles[name]
    assert set(got["fields"]) == set(fields)
    for key, v in fields.items():
        assert torch.equal(_live(g, key, got["fields"][key]),
                           _live(g, key, v)), key
    for key, v in errors.items():
        np.testing.assert_allclose(got["errors"][key].numpy(), v.numpy(),
                                   rtol=METRIC_RTOL, err_msg=key)


@pytest.fixture(scope="module")
def jax_rollouts(data):
    """Per case, the JAX package's single-device rollout on its table route
    (with the metrics) and its ``make_spmd_rollout`` on 2 and 4 host
    devices."""
    jg, gt = data["jax_graph"], data["gt"]
    out = {}
    for name, (jm, feats, variables, _) in data["models"].items():
        cfg = jax_engine.RolloutConfig(num_steps=STEPS, compute_error=True,
                                       save_fields=True)
        errors, _ = jax.jit(lambda v, g_, f: jax_engine.rollout_scan(
            jm, v, g_, f, gt[0], gt[1], cfg))(variables, jg, feats)
        sharded = {}
        for n in (2, 4):
            mesh = make_mesh_spatial(n)
            _, fields = make_spmd_rollout(jm, jax_engine.RolloutConfig(
                num_steps=STEPS, compute_error=False, save_fields=True))(
                replicate_2d(variables, mesh), shard_graph_spatial(jg, mesh),
                feats)
            sharded[n] = jax.device_get(fields)
        out[name] = (jax.device_get(errors), sharded)
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", TABLE_CASES)
def test_sharded_table_rollout_matches_jax(ranks, parts, jax_rollouts, name,
                                           world):
    """The 1 x ``world`` rollout on the table route against the JAX
    package's ``make_spmd_rollout`` of a graph on its table route on
    ``world`` host devices (fields), and its single-device rollout
    (metrics): within BF16_TOL of each field's largest magnitude."""
    load, _ = ranks
    g, _ = parts
    got = load(world)[name]
    want_errors, sharded = jax_rollouts[name]
    for key, v in sharded[world].items():
        a = _live(g, key, got["fields"][key]).numpy()
        b = _live(g, key, torch.from_numpy(np.array(v))).numpy()
        assert np.abs(a - b).max() <= BF16_TOL * np.abs(b).max(), key
    for key, v in want_errors.items():
        np.testing.assert_allclose(got["errors"][key].numpy(), np.asarray(v),
                                   rtol=BF16_TOL,
                                   atol=BF16_TOL * float(np.abs(v).max()),
                                   err_msg=key)
