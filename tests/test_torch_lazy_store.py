"""The port's out-of-core HDF5 store against the JAX package's: the lazy
loader's selection, windows and flux scale, the store's LRU (its hits and
misses after the same reads, its bound, its reopening in a new process),
the RCM views, ``add_grad_weights_to_file``; the dataset's bounded caches
over a streamed set; streamed batches and train steps against the eager
ones; ``build_datasets``' choice of loader (ROADMAP §3, repaired 10) in the
training CLI and the rollout entry point; and the module's import without
h5py.

Files are written with h5py into ``tmp_path`` from structured meshes with
Taylor-Green trajectories.

Tolerances: none; everything is compared exactly. A lazy read returns the
file's array (times the flux scale, one f32 product as in the JAX
package), and the port's streamed and eager datasets assemble the same
arrays, so their batches, tables and train steps agree bit for bit.
"""

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
import json
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

from gnn_fluid_dynamics_tpu.data import hdf5 as jax_hdf5
from gnn_fluid_dynamics_tpu.data import pipeline as jax_pipeline
from gnn_fluid_dynamics_tpu.data.synthetic import (make_geometry,
                                                   taylor_green_trajectory)
from gnn_fluid_dynamics_tpu.models import get_model_class as jax_model_class
from gnn_fluid_dynamics_tpu.ops import reorder as jax_reorder
from gnn_fluid_dynamics_tpu.training.config import Config as JaxConfig
from gnn_fluid_dynamics_tpu.training.train import \
    build_datasets as jax_build_datasets

from gnn_fluid_dynamics_tpu_torch.data import hdf5, pipeline
from gnn_fluid_dynamics_tpu_torch.ops import reorder
from gnn_fluid_dynamics_tpu_torch.rollout import run
from gnn_fluid_dynamics_tpu_torch.training import train
from gnn_fluid_dynamics_tpu_torch.training.config import Config
from gnn_fluid_dynamics_tpu_torch.training.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _trajectories(n, T=7, derived=True):
    """``n`` meshes of three sizes; with ``derived`` False every other one
    lacks the sign/slot tables, as the reference's files do."""
    out = []
    for i in range(n):
        geom = make_geometry("structured", nx=6 + i % 3, ny=4, jitter=0.1,
                             seed=i)
        fields = dict(taylor_green_trajectory(geom, num_timesteps=T, dt=0.01))
        if not derived and i % 2:
            geom = {k: v for k, v in geom.items()
                    if k not in hdf5.DERIVED_KEYS}
        out.append(pipeline.Trajectory(mesh_id=f"mesh_{i}", geom=geom,
                                       fields=fields, dt=0.01, reynolds=100.0))
    return out


def _file(tmp_path, n, name="train.h5", **kw):
    path = str(tmp_path / name)
    hdf5.save_dataset(path, _trajectories(n, **kw))
    return path


# ---- the loader ----------------------------------------------------------------

SELECTIONS = [{}, {"sim_limit": 3}, {"sim_index": [4, 1]},
              {"shuffle": True, "seed": 5}, {"shuffle": True, "seed": 5,
                                             "sim_limit": 2}]


@pytest.mark.parametrize("sel", SELECTIONS, ids=str)
def test_lazy_loader_matches_jax(tmp_path, sel):
    """The selection, dt and Reynolds number, the fields' shapes and
    windows (the face flux times ``flux_scale`` on read) and the geometry
    equal the JAX package's lazy loader's and the port's eager loader's."""
    path = _file(tmp_path, 6, derived=False)
    got = hdf5.load_dataset_lazy(path, flux_scale=1000.0, **sel)
    want = jax_hdf5.load_dataset_lazy(path, flux_scale=1000.0, **sel)
    eager = hdf5.load_dataset(path, flux_scale=1000.0, **sel)
    assert [t.mesh_id for t in got] == [t.mesh_id for t in want] \
        == [t.mesh_id for t in eager]
    for g, w, e in zip(got, want, eager):
        assert isinstance(g.geom, hdf5.LazyGeom)
        assert (g.dt, g.reynolds) == (w.dt, w.reynolds) == (e.dt, e.reynolds)
        assert set(g.fields) == set(w.fields) == set(e.fields)
        for k, arr in g.fields.items():
            assert isinstance(arr, hdf5.LazyArray)
            assert arr.shape == w.fields[k].shape == e.fields[k].shape
            assert len(arr) == arr.shape[0]
            for idx in (2, slice(1, 4), slice(0, None)):
                np.testing.assert_array_equal(arr[idx], w.fields[k][idx])
                np.testing.assert_array_equal(arr[idx], e.fields[k][idx])
        assert set(g.geom.keys()) == set(w.geom.keys()) == set(e.geom)
        for k in e.geom:
            np.testing.assert_array_equal(g.geom[k], w.geom[k])
            np.testing.assert_array_equal(g.geom[k], e.geom[k])
    assert got[0].fields["face_flux"].scale == 1000.0
    with pytest.raises(ValueError, match="sim_limit"):
        hdf5.load_dataset_lazy(path, sim_limit=7)


def test_grad_weights_are_read_eagerly(tmp_path):
    path = _file(tmp_path, 3)
    hdf5.add_grad_weights_to_file(path, "cell", 1)
    got = hdf5.load_dataset_lazy(path, grad_weights_order={"cell": 1})
    want = jax_hdf5.load_dataset_lazy(path, grad_weights_order={"cell": 1})
    for g, w in zip(got, want):
        assert set(g.grad_weights) == set(w.grad_weights) == {
            "cell_grad_weights", "cell_grad_neighbours"}
        for k, v in g.grad_weights.items():
            assert isinstance(v, np.ndarray)
            np.testing.assert_array_equal(v, w.grad_weights[k])


# ---- the store's LRU -----------------------------------------------------------

def _reads(trajs, transformed):
    """One sequence of geometry reads: every key of mesh 0, then a few keys
    of each mesh twice (the derived ones of a file without them included),
    then each mesh's RCM view."""
    out = []
    g0 = trajs[0].geom
    out += [g0[k].sum() for k in g0.keys()]
    for _ in range(2):
        for t in trajs:
            for k in ("cell_pos", "owner_local_slot", "face_index",
                      "cell_face_sign"):
                out.append(t.geom[k].sum())
    for t in transformed:
        out.append(t["cell_pos"].sum())
        out.append(t["vertex_face"].sum())
    return out


@pytest.mark.parametrize("entries", [3, 5, 40])
def test_store_lru_matches_jax(tmp_path, entries):
    """The same reads through each package's store give the same arrays and
    the same hits, misses and cached keys, in LRU order, never more than
    ``cache_entries`` (a derived table is returned even where the bound
    evicts it at once)."""
    path = _file(tmp_path, 4, derived=False)
    stores = []
    for mod, ro in ((hdf5, reorder), (jax_hdf5, jax_reorder)):
        trajs = mod.load_dataset_lazy(path, cache_entries=entries)
        transformed = [mod.TransformedLazyGeom(t.geom, ro.rcm_reorder_geometry,
                                               "__rcm__") for t in trajs]
        values = _reads(trajs, transformed)
        store = trajs[0].geom.store
        assert all(t.geom.store is store for t in trajs)
        assert len(store._cache) <= entries
        stores.append((values, store))
    (got, sp), (want, sj) = stores
    np.testing.assert_array_equal(got, want)
    assert (sp.hits, sp.misses) == (sj.hits, sj.misses)
    assert sp.hits > 0 and sp.misses > 0
    assert list(sp._cache) == list(sj._cache)


def test_dataset_construction_reads_as_jax(tmp_path):
    """Building a bucketed dataset over a streamed set reads the store as
    the JAX package's does: the same hits and misses."""
    path = _file(tmp_path, 5)
    counts = []
    for mod, pl, kw in ((hdf5, pipeline, {"device": "cpu"}),
                        (jax_hdf5, jax_pipeline, {})):
        trajs = mod.load_dataset_lazy(path, cache_entries=4)
        pl.MeshDataset(trajs, pad_multiple=16, num_buckets=2,
                       max_cached_graphs=2, **kw)
        store = trajs[0].geom.store
        counts.append((store.hits, store.misses, list(store._cache)))
    assert counts[0] == counts[1]


def test_store_reopens_in_a_new_process(tmp_path, monkeypatch):
    """The handle belongs to the process that opened it: under another
    process id the next read opens the file again, and reads the same."""
    path = _file(tmp_path, 2)
    traj = hdf5.load_dataset_lazy(path)[0]
    store = traj.fields["cell_velocity"].store
    first = traj.fields["cell_velocity"][1]
    handle = store._file
    assert store._pid == os.getpid()
    assert store.file is handle
    monkeypatch.setattr(hdf5.os, "getpid", lambda: -7)
    again = traj.fields["cell_velocity"][1]
    assert store._file is not handle and store._pid == -7
    np.testing.assert_array_equal(again, first)


def test_rcm_views_match_reorder(tmp_path):
    """``PermutedLazyArray`` reads ``reorder_fields``' arrays and
    ``TransformedLazyGeom`` holds ``rcm_reorder_geometry``'s, as in both
    packages; the transformed dict is one LRU entry."""
    traj = _trajectories(1)[0]
    path = str(tmp_path / "one.h5")
    hdf5.save_dataset(path, [traj])
    new_geom = reorder.rcm_reorder_geometry(traj.geom)
    ref = reorder.reorder_fields(traj.fields, traj.geom, new_geom)
    jref = jax_reorder.reorder_fields(traj.fields, traj.geom,
                                      jax_reorder.rcm_reorder_geometry(traj.geom))
    lt = hdf5.load_dataset_lazy(path)[0]
    cperm, fperm = reorder.perms_from_pos(lt.geom, new_geom)
    geom = hdf5.TransformedLazyGeom(lt.geom, reorder.rcm_reorder_geometry,
                                    "__rcm__")
    assert set(geom.keys()) == set(new_geom)
    for k in new_geom:
        np.testing.assert_array_equal(geom[k], new_geom[k])
        assert k in geom and geom.get(k) is geom[k]
    assert ("mesh_0", "__rcm__") in lt.geom.store._cache
    for k, v in lt.fields.items():
        view = hdf5.PermutedLazyArray(v, cperm if k.startswith("cell")
                                      else fperm)
        assert view.shape == v.shape and len(view) == len(v)
        for idx in (2, slice(1, 3)):
            np.testing.assert_array_equal(view[idx], ref[k][idx])
            np.testing.assert_array_equal(view[idx], jref[k][idx])


# ---- the dataset over a streamed set -------------------------------------------

def test_bounded_caches_over_twelve_meshes(tmp_path):
    """``MeshDataset(max_cached_graphs=3)`` over 12 streamed meshes with
    banded tables, two buckets: while every mesh is visited (pairs across
    the buckets too) the static graphs and the tables hold at most 3
    entries and the store at most its 5; the store both hits and misses."""
    n = 12
    path = _file(tmp_path, n)
    trajs = hdf5.load_dataset_lazy(path, cache_entries=5)
    store = trajs[0].geom.store
    ds = pipeline.MeshDataset(trajs, pad_multiple=128, with_banded=True,
                              num_buckets=2, max_cached_graphs=3,
                              device="cpu")
    for i in range(n):
        g = ds.get_batch([(f"mesh_{i}", 0), (f"mesh_{(i + 1) % n}", 1)])
        assert torch.isfinite(g.cell_velocity).all()
        assert len(ds._static_graphs) <= 3
        assert len(ds._tables_cache) <= 3
        assert len(store._cache) <= 5
    assert store.misses > 0 and store.hits > 0


def _dataset_pair(path, **kw):
    eager = pipeline.MeshDataset(hdf5.load_dataset(path), device="cpu", **kw)
    lazy = pipeline.MeshDataset(hdf5.load_dataset_lazy(path, cache_entries=4),
                                max_cached_graphs=2, device="cpu", **kw)
    return eager, lazy


def _same_graph(a, b):
    for k, v in vars(a).items():
        w = getattr(b, k)
        if isinstance(v, torch.Tensor):
            torch.testing.assert_close(w, v, rtol=0, atol=0, msg=k)
        else:
            assert w == v, k


def test_lazy_banded_batches_equal_eager(tmp_path):
    """Streamed batches with banded tables, in one bucket and across two,
    equal the eager dataset's in every tensor, after evictions too; the
    stacks, trajectory stores and ground truth equal as well."""
    path = _file(tmp_path, 5)
    eager, lazy = _dataset_pair(path, pad_multiple=128, with_banded=True,
                                num_buckets=2, data_window=3)
    for samples in ([("mesh_0", 0), ("mesh_3", 2)],
                    [("mesh_1", 1), ("mesh_2", 0)],
                    [("mesh_4", 3)], [("mesh_0", 0), ("mesh_3", 2)]):
        _same_graph(lazy.get_batch(samples), eager.get_batch(samples))
        ids = tuple(m for m, _ in samples)
        for k, v in eager.device_fields(ids).items():
            torch.testing.assert_close(lazy.device_fields(ids)[k], v,
                                       rtol=0, atol=0)
        fe = eager.trajectory_fields(list(ids), 0, 3)
        fl = lazy.trajectory_fields(list(ids), 0, 3)
        for k in fe:
            np.testing.assert_array_equal(fl[k], fe[k])
    stack = [[("mesh_1", 0), ("mesh_2", 1)], [("mesh_1", 2), ("mesh_2", 0)]]
    (_, se), (_, sl) = eager.get_batch_stack(stack), lazy.get_batch_stack(stack)
    for k in se:
        torch.testing.assert_close(sl[k], se[k], rtol=0, atol=0)
    assert lazy.estimate_device_field_bytes() == eager.estimate_device_field_bytes()


def test_lazy_train_steps_equal_eager(tmp_path):
    """Three FluxD train steps (hidden 16, one block, noise and flip on)
    from the streamed dataset give the eager dataset's losses and
    parameters bit for bit."""
    path = _file(tmp_path, 4)
    eager, lazy = _dataset_pair(path, pad_multiple=16, num_buckets=2,
                                data_window=2)
    cfg = Config.from_dict({
        "model": {"name": "FluxD", "hidden_width": 16, "mp_num": 1},
        "training": {"batch_size": 2, "noise_std": 0.01}})
    batches = list(pipeline.train_batches(eager, 2,
                                          np.random.default_rng(0)))[:3]
    runs = []
    for ds in (eager, lazy):
        model = train.build_model(cfg, "cpu")
        model.set_stats(train.compute_stats(cfg, model, ds, save=False))
        trainer = Trainer(cfg, model)
        state = trainer.init_state()
        losses = [trainer.train_step(state, ds.get_batch(b), 1e-3)[
            "total_log_loss"].item() for b in batches]
        runs.append((losses, [p.detach().clone()
                              for p in state.module.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert np.isfinite(runs[0][0]).all()
    for a, b in zip(runs[0][1], runs[1][1]):
        torch.testing.assert_close(b, a, rtol=0, atol=0)


# ---- MLS weights in the file ---------------------------------------------------

def _grad_groups(path):
    with h5py.File(path, "r") as f:
        out = {"orders": list(f["meta"]["cell_grad_weights_orders"][()])}
        for m in (k for k in f if k.startswith("mesh")):
            for o, sub in f[m]["cell_grad_weights"].items():
                out[(m, o)] = (sub["neighbours"][()], sub["weights"][()])
    return out


def test_add_grad_weights_to_file_matches_jax(tmp_path):
    """The port writes the JAX package's datasets and orders list; a repeat
    call changes nothing, ``recompute`` rewrites, a second order is
    appended."""
    paths = [_file(tmp_path, 3, name=n) for n in ("port.h5", "jax.h5")]
    for p, fn in zip(paths, (hdf5.add_grad_weights_to_file,
                             jax_hdf5.add_grad_weights_to_file)):
        fn(p, "cell", 1)
        fn(p, "cell", 2)
    got, want = _grad_groups(paths[0]), _grad_groups(paths[1])
    assert got.keys() == want.keys() and got["orders"] == [1, 2]
    for k in got:
        if k != "orders":
            for a, b in zip(got[k], want[k]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    # a repeat is a no-op: a planted value survives it, and recompute
    # rewrites it
    with h5py.File(paths[0], "a") as f:
        f["mesh_0/cell_grad_weights/1/weights"][0, 0, 0] = 99.0
    hdf5.add_grad_weights_to_file(paths[0], "cell", 1)
    assert _grad_groups(paths[0])[("mesh_0", "1")][1][0, 0, 0] == 99.0
    hdf5.add_grad_weights_to_file(paths[0], "cell", 1, recompute=True)
    again = _grad_groups(paths[0])
    np.testing.assert_array_equal(again[("mesh_0", "1")][1],
                                  want[("mesh_0", "1")][1])
    assert again["orders"] == [1, 2]


# ---- build_datasets: the auto rule (ROADMAP §3, repaired 10) -------------------

def _config(path_dir, cache_meshes, lazy=None, aggregation="segment",
            sim_limit=None, module="builtin"):
    return {"dataset": {"module": module, "dpath": str(path_dir),
                        "lazy": lazy, "cache_meshes": cache_meshes},
            "model": {"name": "FluxD", "hidden_width": 16, "mp_num": 1,
                      "aggregation": aggregation},
            "training": {"data_subset": "train", "data_sim_limit": sim_limit,
                         "data_timestep_range": [0, 4]},
            "rollout": {"data_subset": "train", "data_sim_limit": sim_limit,
                        "data_timestep_range": [0, 4]}}


@pytest.mark.parametrize("n,sim_limit,streams", [(4, None, True),
                                                 (3, None, False),
                                                 (4, 3, False), (5, 4, True)])
def test_auto_rule_streams_past_cache_meshes(tmp_path, n, sim_limit, streams):
    """With ``dataset.lazy`` unset a subset of more than ``cache_meshes``
    (3) meshes streams: its fields are LazyArrays and both datasets' graph
    caches are bounded at ``cache_meshes``; at ``cache_meshes`` meshes it
    stays in memory, unbounded. The JAX package decides alike."""
    _file(tmp_path, n)
    cfg = _config(tmp_path, 3, sim_limit=sim_limit)
    from gnn_fluid_dynamics_tpu_torch.models.flux import FluxD
    dsets = train.build_datasets(Config.from_dict(cfg), FluxD, device="cpu")
    jsets = jax_build_datasets(JaxConfig.from_dict(cfg),
                               jax_model_class("FluxD"))
    for ds, jds in zip(dsets, jsets):
        assert len(ds.trajectories) == (sim_limit or n)
        lazy = isinstance(ds.trajectories[0].fields["cell_velocity"],
                          hdf5.LazyArray)
        jlazy = isinstance(jds.trajectories[0].fields["cell_velocity"],
                           jax_hdf5.LazyArray)
        assert lazy == jlazy == streams
        assert ds.max_cached_graphs == jds.max_cached_graphs == (
            3 if streams else None)
        if streams:
            assert ds.trajectories[0].geom.store.cache_entries == 3


def test_lazy_forced_either_way(tmp_path):
    """``dataset.lazy`` true streams a small subset, false reads a large one
    into memory; the ``synthetic`` module never streams."""
    _file(tmp_path, 2)
    from gnn_fluid_dynamics_tpu_torch.models.flux import FluxD
    tds, _ = train.build_datasets(Config.from_dict(_config(
        tmp_path, 100, lazy=True)), FluxD, splits=("train",), device="cpu")
    assert isinstance(tds.trajectories[0].geom, hdf5.LazyGeom)
    assert tds.max_cached_graphs == 100
    tds, _ = train.build_datasets(Config.from_dict(_config(
        tmp_path, 1, lazy=False)), FluxD, splits=("train",), device="cpu")
    assert isinstance(tds.trajectories[0].fields["cell_velocity"], np.ndarray)
    assert tds.max_cached_graphs is None
    cfg = _config(tmp_path, 1, lazy=True, module="synthetic", sim_limit=3)
    tds, vds = train.build_datasets(Config.from_dict(cfg), FluxD,
                                    device="cpu")
    for ds in (tds, vds):
        assert isinstance(ds.trajectories[0].geom, dict)
        assert ds.max_cached_graphs is None


def test_lazy_rcm_split_equals_eager(tmp_path):
    """With a banded aggregation a streamed split is RCM-ordered lazily
    (its fields ``PermutedLazyArray``s, its geometry a
    ``TransformedLazyGeom``), and its batches, tables included, equal the
    eager split's; the JAX package's streamed split holds the same
    fields."""
    _file(tmp_path, 4)
    from gnn_fluid_dynamics_tpu_torch.models.flux import FluxD
    sets = []
    for lazy in (True, False):
        cfg = _config(tmp_path, 100, lazy=lazy, aggregation="auto")
        sets.append(train.build_datasets(Config.from_dict(cfg), FluxD,
                                         device="cpu"))
    (tl, vl), (te, ve) = sets
    assert isinstance(vl.trajectories[0].geom, hdf5.TransformedLazyGeom)
    assert isinstance(vl.trajectories[0].fields["face_flux"],
                      hdf5.PermutedLazyArray)
    assert vl.with_banded and not tl.with_banded
    for lazy_ds, eager_ds in ((tl, te), (vl, ve)):
        for samples in ([("mesh_0", 0), ("mesh_2", 1)], [("mesh_3", 2)]):
            _same_graph(lazy_ds.get_batch(samples),
                        eager_ds.get_batch(samples))
    _, jv = jax_build_datasets(
        JaxConfig.from_dict(_config(tmp_path, 100, lazy=True,
                                    aggregation="segment")),
        jax_model_class("FluxD"), splits=("valid",))
    for t, jt in zip(ve.trajectories, jv.trajectories):
        assert jt.mesh_id == t.mesh_id
    # JAX's "segment" split is not reordered: compare through the RCM views
    for t, jt in zip(vl.trajectories, jv.trajectories):
        perm = t.fields["cell_velocity"].perm
        np.testing.assert_array_equal(t.fields["cell_velocity"][1],
                                      jt.fields["cell_velocity"][1][perm])


def test_rollout_entry_point_streams(tmp_path, monkeypatch):
    """``train.main`` and ``rollout.run.main`` (which takes the checkpoint's
    dataset section, as the JAX package does) with ``cache_meshes`` 2 and
    three meshes a subset: both read their splits through the lazy loader,
    and the rollout's errors and fields equal, bit for bit, those of the
    same entry point reading the file into memory."""
    data = tmp_path / "data"
    data.mkdir()
    _file(data, 3, name="valid.h5")
    _file(data, 3, name="train.h5")
    monkeypatch.chdir(tmp_path)
    cfg = _config(data, 2, aggregation="auto")
    cfg["model"]["name"] = "FvgnA"
    cfg["training"].update(epochs=1, batch_size=2, mini_epoch_size=4)
    cfg["rollout"].update(data_subset="valid", data_sim_limit=3)
    cfg["logging"] = {"project": "lazy", "name": "fvgna",
                      "save_frequency": 1, "valid_frequency": 1}
    (tmp_path / "train.json").write_text(json.dumps(cfg))
    calls = []
    real = hdf5.load_dataset_lazy

    def spy(*args, **kw):
        calls.append(os.path.basename(args[0]))
        return real(*args, **kw)

    monkeypatch.setattr(hdf5, "load_dataset_lazy", spy)
    train.main(["--config", str(tmp_path / "train.json"), "--device", "cpu",
                "--ckpt-dir", str(tmp_path / "ck"), "--debug"])
    assert calls == ["train.h5", "valid.h5"]
    cfg["model"]["fpath"] = str(tmp_path / "ck" / "latest")
    (tmp_path / "rollout.json").write_text(json.dumps(cfg))
    streamed = run.main(["--config", str(tmp_path / "rollout.json"),
                         "--device", "cpu", "--output", "streamed"])
    assert calls[2:] == ["valid.h5"]

    def eager(path, cache_entries, **kw):
        calls.append("eager")
        return hdf5.load_dataset(path, **kw)

    monkeypatch.setattr(hdf5, "load_dataset_lazy", eager)
    want = run.main(["--config", str(tmp_path / "rollout.json"),
                     "--device", "cpu", "--output", "eager"])
    assert calls[3:] == ["eager"]
    assert streamed["num_steps"] == want["num_steps"] > 0
    for part in ("errors", "fields"):
        assert set(streamed[part]) == set(want[part])
        for k, v in want[part].items():
            torch.testing.assert_close(streamed[part][k], v, rtol=0, atol=0)


# ---- without h5py --------------------------------------------------------------

BLOCKED = r"""
import sys
sys.modules["h5py"] = None
from gnn_fluid_dynamics_tpu_torch.data import hdf5
from gnn_fluid_dynamics_tpu_torch.training import train
try:
    hdf5.load_dataset_lazy("absent.h5")
except ImportError as exc:
    print("ImportError:", exc)
    sys.exit(0 if "h5py" in str(exc) else 1)
sys.exit(2)
"""


def test_the_module_imports_without_h5py():
    """Where h5py cannot be imported (the card's machine) the module and the
    training CLI import, and the lazy loader raises an ImportError naming
    h5py."""
    res = subprocess.run([sys.executable, "-c", BLOCKED], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "h5py" in res.stdout
