"""The program's span and counter recorder (``training/profiling.py``):
off by default and then inert, nesting by parent id, one rollout id a
rollout, the spans of each rollout step and of set-up's phases as the
program opens them, the counters of builds, loads, weight packs, table
builds and GN-block routes, and the spans as the profiler's host ranges.
The recorder has no counterpart in the JAX package; these tests hold the
port alone."""

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
import json
import os
import stat
import types

import numpy as np
import pytest
import torch

from gnn_fluid_dynamics_tpu_torch.data.node_types import NodeType
from gnn_fluid_dynamics_tpu_torch.data.pipeline import (MeshDataset,
                                                        Trajectory,
                                                        rollout_batch)
from gnn_fluid_dynamics_tpu_torch.data.synthetic import (channel_flow_trajectory,
                                                         cylinder_channel_mesh)
from gnn_fluid_dynamics_tpu_torch.graph import to_static_bands
from gnn_fluid_dynamics_tpu_torch.models.base import ModelConfig, feature_masks
from gnn_fluid_dynamics_tpu_torch.models.normalizer import StatsAccumulator
from gnn_fluid_dynamics_tpu_torch.models.registry import get_model_class
from gnn_fluid_dynamics_tpu_torch.ops import kernels
from gnn_fluid_dynamics_tpu_torch.ops.connectivity import build_geometry
from gnn_fluid_dynamics_tpu_torch.ops.reorder import rcm_reorder_geometry
from gnn_fluid_dynamics_tpu_torch.rollout import engine
from gnn_fluid_dynamics_tpu_torch.training import profiling

STEPS, HIDDEN, MP = 3, 32, 2
ENGINE_SPANS = ("model.forward", "rollout.derive", "rollout.metrics",
                "rollout.feedback")


def _trajectories(n_meshes=2):
    """``n_meshes`` RCM-ordered 300-point cylinder meshes through the
    program's set-up path, each with STEPS + 2 states of channel flow."""
    out = []
    for i in range(n_meshes):
        geom = rcm_reorder_geometry(build_geometry(
            *cylinder_channel_mesh(n_points=300, seed=i), NodeType))
        out.append(Trajectory(mesh_id=f"m{i}", geom=geom, dt=0.01,
                              fields=channel_flow_trajectory(geom, STEPS + 2)))
    return out


@pytest.fixture(scope="module")
def dataset():
    return MeshDataset(_trajectories(), with_banded=True, device="cpu")


def _rollout_inputs(ds, name, aggregation="segment", table=False):
    graph = to_static_bands(ds.get_batch(rollout_batch(ds)),
                            derive_idx=not table)
    model = get_model_class(name)(ModelConfig(
        name=name, hidden_width=HIDDEN, mp_num=MP, aggregation=aggregation),
        device="cpu")
    _, feats = model.transform_rollout(graph)
    acc = StatsAccumulator(model.nmap)
    acc.update(feats, feature_masks(graph, feats))
    model.set_stats(acc.finalize())
    pad = graph.num_cells
    gt = {}
    for key in ("cell_velocity", "cell_pressure"):
        trajs = [ds.by_id[m] for m, _ in rollout_batch(ds)]
        rows = [np.pad(t.fields[key][1:STEPS + 1],
                       ((0, 0), (0, pad // len(trajs) - t.fields[key].shape[1]),
                        (0, 0))) for t in trajs]
        gt[key] = torch.from_numpy(np.concatenate(rows, axis=1))
    return model, graph, feats, gt


def _rollout(inputs, save_fields=True):
    model, graph, feats, gt = inputs
    return engine.rollout_scan(
        model, graph, feats, gt["cell_velocity"], gt["cell_pressure"],
        engine.RolloutConfig(num_steps=STEPS, compute_error=True,
                             save_fields=save_fields))


def test_off_by_default_touches_neither_profiler_nor_clock(dataset,
                                                           monkeypatch):
    """Outside ``recording`` every span is one shared no-op context and a
    counter is dropped: a rollout, even under an active profiler, enters
    no profiler range and reads no clock of the recorder's."""
    def refuse(*args, **kwargs):
        raise AssertionError("the recorder is off")

    assert profiling._record is None
    assert profiling.span("a") is profiling.span("b", route="fused")
    profiling.count("x")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_Open", refuse)
    monkeypatch.setattr(profiling.time, "perf_counter_ns", refuse)
    inputs = _rollout_inputs(dataset, "FluxD")
    errors, _ = _rollout(inputs)
    assert errors["velocity_error"].shape == (STEPS, 2)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _rollout(inputs)
    with profiling.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}
    assert profiling._record is None


def test_spans_nest_by_parent_and_share_the_rollout_id(dataset):
    inputs = _rollout_inputs(dataset, "FluxD")
    with profiling.recording() as rec:
        with profiling.span("outer", step=7) as outer:
            with profiling.span("inner", route="x") as inner:
                pass
        _rollout(inputs)
        _rollout(inputs)
    by_id = {s.id: s for s in rec.spans}
    assert by_id[inner.id].parent == outer.id and by_id[outer.id].parent is None
    assert by_id[inner.id].attrs == {"step": 7, "route": "x"}
    rollouts = rec.named("rollout")
    assert len(rollouts) == 2 and all(r.parent is None for r in rollouts)
    assert [r.attrs["rollout"] for r in rollouts] == [r.id for r in rollouts]
    for r in rollouts:
        inside = [s for s in rec.spans if s.attrs.get("rollout") == r.id]
        assert len(inside) == 1 + STEPS * (6 + MP)
        for s in inside:
            up = by_id.get(s.parent)
            assert s is r or up.attrs["rollout"] == r.id
            assert r.start_ns <= s.start_ns <= s.end_ns <= r.end_ns
        steps = [s for s in inside if s.name == "rollout.step"]
        assert [s.attrs["step"] for s in steps] == list(range(STEPS))
        assert all(s.parent == r.id for s in steps)
    step_of = {s.id: s.attrs["step"] for s in rec.named("rollout.step")}
    for s in rec.spans:
        if s.name in ENGINE_SPANS + ("rollout.save",):
            assert step_of[s.parent] == s.attrs["step"]
        if s.name == "gn_block":
            assert by_id[s.parent].name == "model.forward"
            assert by_id[s.parent].attrs["step"] == s.attrs["step"]


@pytest.mark.parametrize("name, aggregation, table, route", [
    ("FluxD", "segment", False, "plain"),
    ("FvgnF", "segment", False, "plain"),
    ("FluxD", "pallas", False, "fused"),
    ("FvgnF", "pallas", False, "unfused"),
    ("FluxD", "pallas", True, "table"),
])
@pytest.mark.parametrize("save_fields", [True, False])
def test_each_rollout_step_records_its_layers_once(dataset, name, aggregation,
                                                   table, route, save_fields):
    """Per step: one forward, ``mp_num`` GN blocks on the graph's route,
    one each of derive, metrics and feedback, and the save only under
    ``save_fields``; the route's counter counts the blocks, and on the
    unfused route ``gn_mlp.plain`` the sub-blocks' MLPs. After a first
    rollout the fused blocks' packed weights are cached: no pack."""
    inputs = _rollout_inputs(dataset, name, aggregation, table)
    _rollout(inputs)
    with profiling.recording() as rec:
        _rollout(inputs, save_fields)
    want = {n: 1 for n in ("rollout.step",) + ENGINE_SPANS}
    want["gn_block"] = MP
    if save_fields:
        want["rollout.save"] = 1
    for step in range(STEPS):
        got = {}
        for s in rec.spans:
            if s.attrs.get("step") == step:
                got[s.name] = got.get(s.name, 0) + 1
        assert got == want
    assert {s.attrs["route"] for s in rec.named("gn_block")} == {route}
    counters = {f"gn_block.{route}": STEPS * MP}
    if route in ("unfused", "table"):
        # at hidden 32 and in f32 K8 takes no MLP: each sub-block's runs as
        # the module
        counters["gn_mlp.plain"] = 2 * STEPS * MP
    assert rec.counters == counters


def test_setup_phases_and_their_counters(monkeypatch):
    """Set-up's spans, the tables inside the batch, a table build counted
    once a (mesh, pad) and a weight pack once a set of weights."""
    with profiling.recording() as rec:
        ds = MeshDataset(_trajectories(), with_banded=True, device="cpu")
        graph = to_static_bands(ds.get_batch(rollout_batch(ds)))
        ds.get_batch(rollout_batch(ds))
    names = [s.name for s in rec.spans]
    for phase, n in (("setup.connectivity", 2), ("setup.rcm", 2),
                     ("setup.tables", 2), ("setup.batch", 2),
                     ("setup.static_bands", 1)):
        assert names.count(phase) == n, (phase, names)
    batch = {s.id for s in rec.named("setup.batch")}
    by_id = {s.id: s for s in rec.spans}

    def ancestors(s):
        while s.parent is not None:
            s = by_id[s.parent]
            yield s.id
    assert all(batch & set(ancestors(s)) for s in rec.named("setup.tables"))
    assert rec.counters == {"dataset.table_builds": 2}
    assert not graph.table_route

    model = get_model_class("FluxD")(ModelConfig(
        name="FluxD", hidden_width=HIDDEN, mp_num=MP), device="cpu")
    mlp = model.module.epd.blocks[0].cell_block.mlp
    with profiling.recording() as rec:
        first = mlp.kernel_weights(packed=True)
        assert mlp.kernel_weights(packed=True) is first
        with torch.no_grad():
            mlp.dense0.bias.add_(1.0)
        mlp.kernel_weights(packed=True)
    assert rec.counters == {"mlp.weight_packs": 2}


def test_kernel_build_and_load_are_counted_once(tmp_path, monkeypatch):
    """The first use builds every missing library (one compiler process
    each) and loads them all inside ``setup.kernels``; later uses find
    them loaded. A stand-in compiler writes the outputs and a stand-in
    loader takes the libraries."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then : > "$2"; fi; shift\ndone\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)

    class Library:
        def __init__(self, path):
            assert os.path.exists(path)

        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels.ctypes, "CDLL", Library)
    with profiling.recording() as rec:
        kernels._library("face_block")
        kernels._library("table_single")
    n = len(kernels.SOURCES)
    assert rec.counters == {"kernels.builds": n, "kernels.loads": n}
    assert [s.name for s in rec.spans] == ["setup.kernels"]
    monkeypatch.setattr(kernels, "_libs", {})
    with profiling.recording() as rec:
        kernels._library("cell_block")
    assert rec.counters == {"kernels.loads": n}


def test_spans_are_the_profilers_host_ranges(dataset, tmp_path):
    """Under an active profiler each span is the host range
    ``gfd::<name>``, as long as the span and as many."""
    inputs = _rollout_inputs(dataset, "FvgnF")
    path = str(tmp_path / "trace.json")
    with profiling.recording() as rec:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _rollout(inputs)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith("gfd::"):
            ranges.setdefault(e["name"][len("gfd::"):], []).append(e["dur"])
    want = {}
    for s in rec.spans:
        want.setdefault(s.name, []).append(s.seconds * 1e6)
    assert {k: len(v) for k, v in ranges.items()} == {k: len(v) for k, v in want.items()}
    # the range opens before the span's clock starts and closes after it stops
    assert sum(ranges["rollout"]) >= sum(want["rollout"]) - 1.0
