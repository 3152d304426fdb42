"""The port's size buckets against the JAX package's: the assignment of
meshes to buckets and their pads, the per-bucket training batches and the
chunked samplers on a bucketed dataset, every pad-dependent array of
``MeshDataset``, the banded tables at a bucket's pad, a FluxD train step on
a bucketed batch, and the rollout writer at a bucket's pad; and the port's
own rules: the caches keyed by pad, the validation batch's pad, the training
CLI with ``dataset.num_buckets`` 2.

Meshes: structured meshes of a few sizes, some of them tied, with
Taylor-Green trajectories made from numpy seeds.

Tolerances: the buckets, batches and data exactly (the same numpy code on
the same arrays, ``assert_array_equal``); the table aggregations exactly:
the kernels' plain versions sum one-hot table entries times integer-valued
f32 sources, so every sum is exact in f32 whichever band offsets (the
port's own per mesh, the JAX package's canonical ones) hold them; the train
step at ``tests/test_torch_train.py``'s f32 tolerances (each loss within
1e-5 relative, each gradient leaf within 1e-4 of its largest magnitude).
"""

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
import json
import os

import h5py
import jax
import numpy as np
import pytest
import torch

from gnn_fluid_dynamics_tpu.data import pipeline as jax_pipeline
from gnn_fluid_dynamics_tpu.data import samplers as jax_samplers
from gnn_fluid_dynamics_tpu.data.synthetic import (make_geometry,
                                                   taylor_green_trajectory)
from gnn_fluid_dynamics_tpu.rollout.writer import \
    SimulationWriter as JaxSimulationWriter
from test_models import LOSS_WEIGHTS, make_model

from gnn_fluid_dynamics_tpu_torch.data import pipeline, samplers
from gnn_fluid_dynamics_tpu_torch.models.base import ModelConfig
from gnn_fluid_dynamics_tpu_torch.models.registry import get_model_class
from gnn_fluid_dynamics_tpu_torch.ops import kernels
from gnn_fluid_dynamics_tpu_torch.rollout.writer import SimulationWriter
from gnn_fluid_dynamics_tpu_torch.training import train
from gnn_fluid_dynamics_tpu_torch.training.config import load_config
from gnn_fluid_dynamics_tpu_torch.weights import params_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTHETIC = os.path.join(ROOT, "config", "train_synthetic.json")
# (nx, ny) of each mesh: cells 48, 64, 48, 56, 64, 48 (three ties at 48)
SIZES = ((6, 4), (8, 4), (6, 4), (7, 4), (8, 4), (6, 4))
# banded: cells 160, 320, 160, 224, padded to 128 rows
BANDED_SIZES = ((10, 8), (20, 8), (10, 8), (14, 8))
WINDOW = 3
F32_LOSS_RTOL, F32_GRAD_TOL = 1e-5, 1e-4      # tests/test_torch_train.py's
FLUXD_WEIGHTS = {**LOSS_WEIGHTS, "face_pressure_rel": 0.5}


def _trajectories(kind, sizes=SIZES, steps=(7, 8, 9)):
    out = []
    for i, (nx, ny) in enumerate(sizes):
        geom = make_geometry("structured", nx=nx, ny=ny, jitter=0.1, seed=i)
        fields = taylor_green_trajectory(geom, dt=0.01,
                                         num_timesteps=steps[i % len(steps)])
        out.append(kind(mesh_id=f"m{i}", geom=geom, fields=dict(fields),
                        dt=0.01))
    return out


def _datasets(num_buckets, sizes=SIZES, pad=16, **kw):
    """The same trajectories in a JAX and a port dataset."""
    return (jax_pipeline.MeshDataset(_trajectories(jax_pipeline.Trajectory,
                                                   sizes),
                                     data_window=WINDOW, pad_multiple=pad,
                                     num_buckets=num_buckets, **kw),
            pipeline.MeshDataset(_trajectories(pipeline.Trajectory, sizes),
                                 data_window=WINDOW, pad_multiple=pad,
                                 num_buckets=num_buckets, device="cpu", **kw))


@pytest.fixture(scope="module")
def bucketed():
    return _datasets(3)


# ---- the buckets ---------------------------------------------------------------

@pytest.mark.parametrize("num_buckets", [1, 2, 3, 4, 9])
def test_buckets_match_jax(num_buckets):
    """``bucket_of``, ``bucket_pad`` and ``pad_to`` equal the JAX package's,
    ties and more buckets than meshes included (clamped to one a mesh)."""
    jds, tds = _datasets(num_buckets)
    assert tds.bucket_of == jds.bucket_of
    assert tds.bucket_pad == jds.bucket_pad
    assert tds.pad_to == jds.pad_to
    assert len(tds.bucket_pad) == min(num_buckets, len(SIZES))
    for ids in (("m0", "m2"), ("m1", "m4"), ("m0", "m1"), tuple(tds.sim_ids())):
        assert tds._pad_for(ids) == jds._pad_for(ids)


@pytest.mark.parametrize("num_buckets", [1, 2, 3, 4])
def test_the_validation_batch_is_padded_to_pad_to(num_buckets):
    """The trainer's snapshot payload cuts the validation batch at
    ``pad_to``: the batch of every mesh has that pad whatever the buckets
    (one bucket's pad is the pad of all its meshes; several buckets give
    ``pad_to``), and so has a one-mesh dataset."""
    _, tds = _datasets(num_buckets)
    assert tds._pad_for(tds.sim_ids()) == tds.pad_to
    one = pipeline.MeshDataset(tds.trajectories[1:2], num_buckets=num_buckets,
                               pad_multiple=16, device="cpu")
    assert one._pad_for(one.sim_ids()) == one.pad_to


@pytest.mark.parametrize("seed", [0, 7])
def test_train_batches_match_jax(bucketed, seed):
    """Per-bucket batches, the buckets in first-seen order, all batches then
    permuted: JAX's list for the seed, every batch within one bucket, and
    the generator left where JAX leaves it."""
    jds, tds = bucketed
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    want = list(jax_pipeline.train_batches(jds, 2, rj))
    got = list(pipeline.train_batches(tds, 2, rt))
    assert got == want and len(got) > 3
    assert all(len({tds.bucket_of[m] for m, _ in b}) == 1 for b in got)
    assert rt.integers(1 << 30) == rj.integers(1 << 30)


@pytest.mark.parametrize("name", ["balanced_chunked", "static_chunked"])
@pytest.mark.parametrize("batch_size", [2, 3])
def test_chunked_samplers_match_jax_on_buckets(bucketed, name, batch_size):
    """The chunked samplers read ``bucket_of``: their batches equal JAX's on
    the bucketed dataset, and each stays within one bucket."""
    jds, tds = bucketed
    rj, rt = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(2):   # two epochs: the generator carries over
        want = list(jax_samplers.get_sampler(name)(jds, batch_size, rj))
        got = list(samplers.get_sampler(name)(tds, batch_size, rt))
        assert got == want
        assert all(len({tds.bucket_of[m] for m, _ in b}) == 1 for b in got)


# ---- the data at each pad ------------------------------------------------------

BATCHES = {"one bucket": [("m0", 1), ("m2", 2), ("m0", 0)],
           "mixed": [("m0", 1), ("m1", 2), ("m3", 0)]}


def _fields(graph):
    return {k: np.asarray(getattr(graph, k)) for k in pipeline.FIELD_KEYS
            if getattr(graph, k) is not None}


@pytest.mark.parametrize("which", sorted(BATCHES))
def test_batches_match_jax_at_their_pad(bucketed, which):
    """``get_batch``, ``get_batch_stack``, ``device_fields``,
    ``trajectory_fields`` and ``trajectory_targets`` equal JAX's arrays for a
    batch within one bucket (its pad) and for one across buckets
    (``pad_to``), and the static graph has that pad."""
    jds, tds = bucketed
    samples = BATCHES[which]
    ids = tuple(m for m, _ in samples)
    pad = tds._pad_for(ids)
    assert (pad == tds.pad_to) == (which == "mixed")
    gj, gt = jds.get_batch(samples), tds.get_batch(samples)
    assert gt.num_cells == len(ids) * pad["cell"] == gj.num_cells
    assert gt.num_faces == len(ids) * pad["face"] == gj.num_faces
    assert gt.num_vertices == len(ids) * pad["vertex"] == gj.num_vertices
    for k, want in _fields(gj).items():
        np.testing.assert_array_equal(_fields(gt)[k], want)
    for k in ("cell_pos", "face_index", "cell_edge_index", "vertex_face",
              "cell_mask", "face_mask"):
        np.testing.assert_array_equal(getattr(gt, k).numpy(),
                                      np.asarray(getattr(gj, k)))
    stack = [[(m, t + 1) for m, t in samples], samples]
    (_, sj), (_, st) = jds.get_batch_stack(stack), tds.get_batch_stack(stack)
    assert set(st) == set(sj)
    for k in sj:
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(sj[k]))
    dj, dt = jds.device_fields(ids), tds.device_fields(ids)
    assert set(dt) == set(dj)
    for k in dj:
        np.testing.assert_array_equal(dt[k].numpy(), np.asarray(dj[k]))
    fj = jds.trajectory_fields(list(ids), 0, 3)
    ft = tds.trajectory_fields(list(ids), 0, 3)
    assert set(ft) == set(fj)
    for k in fj:
        np.testing.assert_array_equal(ft[k], fj[k])
    for a, b in zip(tds.trajectory_targets(list(ids), 1, 2),
                    jds.trajectory_targets(list(ids), 1, 2)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_device_field_bytes_match_jax(bucketed):
    """Each mesh counted at its own bucket's pad, as JAX counts it; fewer
    bytes than at the one pad of all."""
    jds, tds = bucketed
    assert tds.estimate_device_field_bytes() == jds.estimate_device_field_bytes()
    _, flat = _datasets(1)
    assert tds.estimate_device_field_bytes() < flat.estimate_device_field_bytes()


def test_caches_keep_each_pad_apart(bucketed):
    """A mesh's static graph is cached once per pad, and a combination's
    batched graph and trajectory store are built at the combination's pad:
    an entry built at one pad is never served for another."""
    _, tds = bucketed
    tds.get_batch([("m0", 0), ("m2", 0)])
    tds.get_batch([("m0", 0), ("m1", 0)])
    keys = [k for k in tds._static_graphs if k[0] == "m0"]
    assert sorted(keys) == sorted(
        {("m0",) + tds._pad_key(tds.bucket_pad[tds.bucket_of["m0"]]),
         ("m0",) + tds._pad_key(tds.pad_to)})
    for (mesh_id, *pk), g in tds._static_graphs.items():
        assert (g.num_cells, g.num_faces, g.num_vertices) == tuple(pk)
    for ids, g in tds._batched_cache.items():
        pad = tds._pad_for(ids)
        assert g.num_cells == len(ids) * pad["cell"]
    for ids in (("m0", "m2"), ("m0", "m1")):
        dev = tds.device_fields(ids)
        assert dev["cell_velocity"].shape[1] == len(ids) * tds._pad_for(ids)["cell"]
        assert dev["face_flux"].shape[1] == len(ids) * tds._pad_for(ids)["face"]


def test_grad_weights_drop_the_cached_graphs():
    """``add_grad_weights`` drops every cached static and batched graph (of
    every pad), keeps the tables, and the next batch carries the weights."""
    _, tds = _datasets(2)
    tds.get_batch([("m0", 0), ("m2", 0)])
    tds.get_batch([("m0", 0), ("m1", 0)])
    assert tds._static_graphs and tds._batched_cache
    tds.add_grad_weights("cell", 1)
    assert not tds._static_graphs and not tds._batched_cache
    g = tds.get_batch([("m0", 0), ("m2", 0)])
    assert g.cell_grad_weights is not None
    assert g.cell_grad_weights.shape[0] == 2 * tds._pad_for(("m0", "m2"))["cell"]


def test_bounded_caches_are_lrus():
    """With ``max_cached_graphs`` the static graphs and the tables are LRUs
    of that many (mesh, pad) entries: the least recently used goes first."""
    tds = pipeline.MeshDataset(_trajectories(pipeline.Trajectory,
                                             BANDED_SIZES),
                               pad_multiple=128, with_banded=True,
                               num_buckets=2, max_cached_graphs=2,
                               device="cpu")
    for m in ("m0", "m2", "m0", "m3"):
        tds._static_graph(m, tds.bucket_pad[tds.bucket_of[m]])
        assert len(tds._static_graphs) <= 2 and len(tds._tables_cache) <= 2
    assert [k[0] for k in tds._static_graphs] == ["m0", "m3"]
    # the tables are read when a graph is built: m0's graph was a hit
    assert [k[0] for k in tds._tables_cache] == ["m2", "m3"]
    with pytest.raises(ValueError, match="max_cached_graphs"):
        pipeline.MeshDataset(tds.trajectories, max_cached_graphs=0,
                             device="cpu")


# ---- the banded tables at a bucket's pad ---------------------------------------

def _aggregate(es, er, es_off, vc, vc_off, cf_row, cf_col, cf_off, src):
    """K6's roll form, K7 and K6's cf form through their plain versions:
    (vertex sums, cell means, owner rows, neighbour rows). ``src`` holds
    the integer-valued face (F, 2W), vertex (V, W) and cell (C, W) sources."""
    t = lambda x: torch.from_numpy(np.array(x))      # noqa: E731
    vsum = kernels.table_dual(t(es), t(er), t(es_off).int(), src["face"],
                              combine_roll=True)
    cells = kernels.table_single(t(vc), t(vc_off).int(), src["vertex"])
    row, col = kernels.table_dual(t(cf_row), t(cf_col), t(cf_off).int(),
                                  src["cell"])
    return [x.numpy() for x in (vsum, cells, row, col)]


def _graph_tables(g):
    return (g.es_onehot, g.er_onehot, g.es_off, g.vc_onehot, g.vc_off,
            g.cf_row_onehot, g.cf_col_onehot, g.cf_off)


def _sources(rng, pad, n=1, width=8):
    def ints(rows, w):
        return torch.from_numpy(rng.integers(-8, 9, size=(rows, w)).astype(
            np.float32))
    return {"face": ints(n * pad["face"], 2 * width),
            "vertex": ints(n * pad["vertex"], width),
            "cell": ints(n * pad["cell"], width)}


@pytest.mark.parametrize("which", ["bucket 0", "bucket 1", "pad_to"])
def test_tables_at_a_pad_aggregate_as_jax_canonical_tables(which):
    """At each bucket's pad, and at ``pad_to`` for bucket 0's meshes, the
    port's tables (each mesh's own band offsets, never rebased) give, through
    K6's and K7's plain versions, the aggregation of the JAX package's
    canonicalised tables exactly; per mesh and for the batch of the
    bucket's meshes, whose tables ``batch_graphs`` widens to one band."""
    jds, tds = _datasets(2, BANDED_SIZES, pad=128, with_banded=True,
                         banded_dtype="float32")
    b = 1 if which == "bucket 1" else 0
    ids = [m for m in tds.sim_ids() if tds.bucket_of[m] == b]
    assert len(ids) == 2
    pad = tds.pad_to if which == "pad_to" else tds.bucket_pad[b]
    if which == "pad_to":
        assert pad != tds.bucket_pad[b]
    rng = np.random.default_rng(11)
    srcs = [_sources(rng, pad) for _ in ids]
    want = []
    for m, src in zip(ids, srcs):
        gj = jds._static_graph(m, pad)
        gt = tds._static_graph(m, pad)
        w = _aggregate(*_graph_tables(gj), src)
        got = _aggregate(*_graph_tables(gt), src)
        for a, c in zip(got, w):
            np.testing.assert_array_equal(a, c)
        want.append(w)
    batched = pipeline.batch_graphs([tds._static_graph(m, pad) for m in ids])
    cat = {k: torch.cat([s[k] for s in srcs]) for k in srcs[0]}
    got = _aggregate(*_graph_tables(batched), cat)
    for i, a in enumerate(got):
        np.testing.assert_array_equal(a, np.concatenate([w[i] for w in want]))
    if which != "pad_to":
        # the dataset's batch of the bucket is that batched graph
        g = tds.get_batch([(m, 0) for m in ids])
        for x, y in zip(_graph_tables(g), _graph_tables(batched)):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


# ---- a train step and the writer on a bucketed batch ---------------------------

def test_fluxd_train_step_on_a_bucketed_batch_matches_jax(bucketed):
    """FluxD (hidden 32, 2 blocks, f32, ``"segment"``) on a batch of one
    bucket at its pad: one train-mode forward, loss and backward on each
    side (no noise, flip or dropout), each loss within 1e-5 relative, each
    parameter's gradient within 1e-4 of its leaf's largest magnitude."""
    jds, tds = bucketed
    samples = BATCHES["one bucket"]
    gj, gt = jds.get_batch(samples), tds.get_batch(samples)
    assert gt.num_cells < len(samples) * tds.pad_to["cell"]
    jm = make_model("FluxD", gj, compute_dtype="float32",
                    aggregation="segment")
    jm.loss_weights = FLUXD_WEIGHTS
    tgj, feats_j = jm.transform_features(gj, None, mode="train")
    variables = jm.init(jax.random.PRNGKey(0), tgj, feats_j)

    def loss_fn(params):
        out, _ = jm.forward({**variables, "params": params}, tgj, feats_j,
                            mode="train")
        ls = jm.loss(out, feats_j, tgj)
        return ls["total_log_loss"], ls

    grads_j, ls_j = jax.grad(loss_fn, has_aux=True)(variables["params"])
    grads_j = params_from_flax(grads_j)

    tm = get_model_class("FluxD")(
        ModelConfig(name="FluxD", hidden_width=32, mp_num=2,
                    aggregation="segment", compute_dtype="float32"),
        device="cpu", loss_weights=FLUXD_WEIGHTS)
    tm.set_stats({k: {s: float(v) for s, v in d.items()}
                  for k, d in jm.stats.items()})
    tm.module.load_state_dict(params_from_flax(variables))
    tgt, feats_t = tm.transform_features(gt, None, mode="train")
    ls_t = tm.loss(tm.forward(tgt, feats_t, mode="train"), feats_t, tgt)
    ls_t["total_log_loss"].backward()
    assert set(ls_t) == set(ls_j)
    for k in ls_j:
        want = float(ls_j[k])
        assert abs(ls_t[k].item() - want) <= F32_LOSS_RTOL * max(abs(want),
                                                                  1e-30), k
    params = dict(tm.module.named_parameters())
    assert set(grads_j) == set(params)
    for k, want in grads_j.items():
        got = params[k].grad
        assert got is not None and torch.isfinite(got).all(), k
        err = float((got - want).abs().max())
        assert err <= F32_GRAD_TOL * float(want.abs().max()), (k, err)


def test_writer_cuts_each_mesh_at_the_bucket_pad(bucketed, tmp_path):
    """A rollout set within one bucket is batched at the bucket's pad; the
    port's writer cuts each mesh's rows there and writes the JAX writer's
    datasets, equal."""
    jds, tds = bucketed
    ids = ["m2", "m0"]
    assert tds._pad_for(ids) != tds.pad_to
    fields = tds.trajectory_fields(ids, 0, 4)
    gt = tds.trajectory_fields(ids, 1, 4)
    steps = [1, 2, 3, 4]
    for writer, ds, name in ((JaxSimulationWriter, jds, "jax.h5"),
                             (SimulationWriter, tds, "port.h5")):
        w = writer(str(tmp_path / name), ds, ids)
        w.write_fields(fields, steps, ground_truth=gt, save_frequency=2)
        w.close()
    with h5py.File(tmp_path / "jax.h5") as fj, \
            h5py.File(tmp_path / "port.h5") as ft:
        for m in ids:
            n = tds.by_id[m].geom["cell_pos"].shape[0]
            assert ft[m]["cell"]["velocity"].shape == (2, n, 2)
            for grp in ("cell", "face"):
                assert set(ft[m][grp]) == set(fj[m][grp])
                for k in fj[m][grp]:
                    np.testing.assert_array_equal(ft[m][grp][k][()],
                                                  fj[m][grp][k][()])
            np.testing.assert_array_equal(ft[m]["timesteps"][()],
                                          fj[m]["timesteps"][()])


# ---- the training CLI ----------------------------------------------------------

def test_train_main_pads_by_bucket(tmp_path, monkeypatch, capsys):
    """``train.main`` with ``dataset.num_buckets`` 2 on three synthetic
    meshes of two sizes: the training set has two buckets with their own
    pads (printed), and the run ends with finite losses."""
    with open(SYNTHETIC) as f:
        cfg = json.load(f)
    cfg["dataset"]["num_buckets"] = 2
    cfg["dataset"]["stats_fpath"] = str(tmp_path / "stats.json")
    cfg["training"].update(data_sim_limit=3, data_timestep_range=[0, 6],
                           epochs=1, mini_epoch_size=4, pad_multiple=16)
    cfg["rollout"].update(data_sim_limit=3, data_timestep_range=[0, 4])
    cfg["logging"].update(valid_frequency=1, save_frequency=0)
    path = tmp_path / "train.json"
    path.write_text(json.dumps(cfg))
    monkeypatch.chdir(tmp_path)
    trainer, state = train.main(["--config", str(path), "--device", "cpu",
                                 "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "bucket pads" in out
    assert trainer.step_count > 0
    config = load_config(str(path))
    model = train.build_model(config, "cpu")
    tds, vds = train.build_datasets(config, type(model), device="cpu")
    assert len(tds.bucket_pad) == 2 and tds.bucket_pad[0] != tds.bucket_pad[1]
    assert len(vds.bucket_pad) == 2
    metrics = [os.path.join(dp, "metrics.jsonl")
               for dp, _, files in os.walk(tmp_path / "runs")
               if "metrics.jsonl" in files]
    assert len(metrics) == 1
    with open(metrics[0]) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["train/total_log_loss"] for r in rows
              if "train/total_log_loss" in r]
    assert losses and np.isfinite(losses).all()
