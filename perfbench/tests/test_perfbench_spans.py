"""The span readings (``perfbench/spans.py``): kernels, idle stretches and
host self time put down to the program's innermost ``gfd::`` range, on a
synthetic trace in the style of ``test_perfbench_trace.py``; and a run of a
cell on the CPU at a tiny size, set-up and the profiled stretch recorded,
the window not."""

from types import SimpleNamespace

import pytest
import torch

from perfbench import spans
from perfbench.harness.rollout import RolloutCell
from perfbench.harness.trace import Trace
from perfbench.tests.test_perfbench_reference import tiny


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def _trace():
    """One step: the forward (0..30) holds a GN block (2..12); metrics at
    40..50; a kernel launched outside every range at 60."""
    return Trace([
        _x("user_annotation", "gfd::rollout.step", 0, 55),
        _x("user_annotation", "gfd::model.forward", 0, 30),
        _x("user_annotation", "perfbench::gn_block", 1, 12),
        _x("user_annotation", "gfd::gn_block", 2, 10),
        _x("user_annotation", "gfd::rollout.metrics", 40, 10),
        _x("cpu_op", "aten::add", 41, 2),
        _x("cuda_runtime", "cudaLaunchKernel", 3, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernelExC", 5, 1, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 1, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 42, 1, correlation=4),
        _x("cuda_runtime", "cudaLaunchKernel", 60, 1, correlation=5),
        _x("kernel", "gfd::k3", 10, 6, correlation=1),
        _x("kernel", "gfd::k2", 14, 6, correlation=2),    # overlaps k3
        _x("kernel", "encoder", 30, 4, correlation=3),
        _x("kernel", "add", 50, 2, correlation=4),
        _x("kernel", "late", 70, 1, correlation=5),
    ])


def test_device_time_by_innermost_and_enclosing_range():
    d = spans.device_ms_by_span(_trace(), steps=2)
    # k3 and k2 overlap (10..20); the forward adds the encoder (4)
    assert d["gn_block"] == pytest.approx(10e-3 / 2)
    assert d["model.forward"] == pytest.approx(14e-3 / 2)
    assert d["rollout.step"] == pytest.approx(16e-3 / 2)
    assert d["rollout.metrics"] == pytest.approx(2e-3 / 2)
    assert "perfbench::gn_block" not in d and "gfd::gn_block" not in d
    r = spans.traced_readings(_trace(), [], steps=2)
    assert r["engine_device_ms"] == pytest.approx(2e-3 / 2)
    assert r["gn_block_device_ms"] == d["gn_block"]


def test_idle_stretches_by_the_innermost_range_of_the_launch():
    idle = spans.idle_ms_by_span(_trace(), steps=1)
    # 20..30 ends at the encoder, launched in the forward outside the block;
    # 34..50 at "add", launched in the metrics (inside aten::add); 52..70 at
    # a kernel launched outside every range
    assert idle == pytest.approx({"model.forward": 10e-3,
                                  "rollout.metrics": 16e-3,
                                  spans.NO_SPAN: 18e-3})


def test_innermost_walks_past_ranges_that_ended():
    ranges = [(0, 100, "a"), (10, 20, "b"), (30, 40, "c"), (30, 35, "e"),
              (31, 32, "d")]
    assert spans.innermost(ranges, 33) == "e"
    assert spans.innermost(ranges, 37) == "c"
    assert spans.innermost(ranges, 31.5) == "d"
    assert spans.innermost(ranges, 50) == "a"
    assert spans.innermost(ranges, 150) == spans.NO_SPAN


def _span(id, parent, name, start, end):
    return SimpleNamespace(id=id, parent=parent, name=name, start_ns=start,
                           end_ns=end, seconds=(end - start) * 1e-9)


def test_host_self_time_and_setup_phases():
    record = [_span(2, 1, "b", 10, 40), _span(3, 1, "b", 30, 60),
              _span(4, 2, "c", 15, 20), _span(1, None, "a", 0, 100)]
    host = spans.host_ms_by_span(record, steps=1)
    # a: 100 less its children's union (10..60); b: 30 - 5 and 30
    assert host == pytest.approx({"a": 50e-6, "b": 55e-6, "c": 5e-6})
    setup = [_span(1, None, "setup.connectivity", 0, 10 ** 9),
             _span(2, None, "setup.rcm", 0, 2 * 10 ** 9),
             _span(3, None, "setup.batch", 0, 3 * 10 ** 9),
             _span(4, 3, "setup.tables", 0, 10 ** 9),
             _span(5, None, "rollout", 0, 4 * 10 ** 9),
             _span(6, None, "rollout", 0, 10 ** 9)]
    by = spans.setup_s_by_span(setup)
    assert by == pytest.approx({"setup.connectivity": 1, "setup.rcm": 2,
                                "setup.batch": 3, "setup.tables": 1})
    assert spans.setup_metrics(by, setup) == pytest.approx(
        {"setup_geometry_s": 3, "setup_graph_s": 3, "setup_warmup_s": 4})
    assert spans.setup_metrics({}, [])["setup_warmup_s"] is None


@pytest.mark.parametrize("name", ["fluxd.rollout.b8", "fvgnf.rollout.b8",
                                  "fluxd.valid.b8"])
def test_cpu_run_records_setup_and_the_stretch_not_the_window(
        name, tmp_path, monkeypatch):
    from gnn_fluid_dynamics_tpu_torch.training import profiling
    window = RolloutCell.window
    seen = []

    def checked(self, seconds):
        seen.append(profiling._record)
        return window(self, seconds)

    monkeypatch.setattr(RolloutCell, "window", checked)
    spec = tiny(name)
    mp = spec["config"]["mp_num"]
    out = spans.run(spec, 2 ** 33 + 1, 0.0, 0, torch.device("cpu"), 0.0,
                    tmp_path)
    assert seen == [None]
    per_step = out["spans_per_step"]
    want = {"rollout.step": 1, "model.forward": 1, "gn_block": mp,
            "rollout.derive": 1, "rollout.metrics": 1, "rollout.save": 1,
            "rollout.feedback": 1}
    assert {k: per_step[k] for k in want} == pytest.approx(want)
    # the stretch is one rollout of trace_steps steps
    assert per_step["rollout"] == pytest.approx(1 / spec["traffic"]["trace_steps"])
    steps = spec["traffic"]["trace_steps"]
    # the CPU takes the plain route; the table route's tables are built
    # once a mesh in set-up and never in the stretch
    assert out["counters"]["traced"] == {"gn_block.plain": mp * steps}
    table = spec["traffic"]["route"] == "table"
    assert out["counters"]["setup"].get("dataset.table_builds", 0) == (
        2 if table else 0)
    m = out["metrics"]
    assert m["setup_geometry_s"] > 0 and m["setup_graph_s"] > 0
    assert m["setup_warmup_s"] > 0
    assert 0 <= out["setup_uncovered_s"]
    assert set(out["setup_s_by_span"]) >= {"setup.connectivity", "setup.rcm",
                                           "setup.batch", "setup.static_bands"}


def test_pairs_record_their_on_halves_alone(tmp_path, monkeypatch):
    """With ``pairs``, each window and each profiled stretch runs with the
    recorder off, then on (the next pair the other way round); each
    window's throughput counts its own rollouts."""
    from gnn_fluid_dynamics_tpu_torch.training import profiling
    window = RolloutCell.window
    seen = []

    def checked(self, seconds):
        seen.append(profiling._record is not None)
        return window(self, seconds)

    monkeypatch.setattr(RolloutCell, "window", checked)
    spec = tiny("fluxd.rollout.b8")
    out = spans.run(spec, 2 ** 33 + 2, 0.0, 2, torch.device("cpu"), 0.0,
                    tmp_path)
    assert seen == [False, True, True, False]
    assert [w["recording"] for w in out["windows"]] == seen
    rates = [w["rollout_throughput"] for w in out["windows"]]
    assert max(rates) < 3 * min(rates)
    assert [s["recording"] for s in out["stretches"]] == seen
    assert set(out["harness_s_by_span"]) == {
        "harness.meshes", "harness.flow", "harness.weights",
        "harness.ground_truth"}
    assert out["before_setup_s"] >= 0 and out["setup_uncovered_s"] >= 0
