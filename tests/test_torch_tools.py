"""The port's training tools, against the JAX package's where it has
them: ``trace`` with the recorder's spans and ``device_memory_stats``
(``training/profiling.py``); the per-head report and CLI of
``training/diagnose.py``; the sweep tool (``training/sweep.py``); and the logger's TensorBoard and
wandb sinks (``training/logging.py``), with a resumed run continuing the
checkpoint's wandb run.

Tolerances: ``head_report`` in f32 at hidden 32 and 2 blocks with the Flax
weights carried over by ``params_from_flax``, each statistic within
HEAD_RTOL relative (and HEAD_ATOL absolute, for a mean near zero) of the
JAX package's: the same math up to f32 summation order; the learned
scalars exactly (copied). The TensorBoard events: the same tags, steps and
f32 values, exactly.
"""

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
import glob
import io
import json
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

from test_models import build_graph

from gnn_fluid_dynamics_tpu.data.synthetic import (
    make_geometry as jax_make_geometry,
    taylor_green_trajectory as jax_tg)
from gnn_fluid_dynamics_tpu.graph import from_geometry as jax_from_geometry
from gnn_fluid_dynamics_tpu.models import get_model_class as jax_model_class
from gnn_fluid_dynamics_tpu.models.base import ModelConfig as JaxModelConfig
from gnn_fluid_dynamics_tpu.models.base import feature_masks as jax_masks
from gnn_fluid_dynamics_tpu.models.normalizer import \
    StatsAccumulator as JaxStatsAccumulator
from gnn_fluid_dynamics_tpu.ops import mls as jax_mls
from gnn_fluid_dynamics_tpu.training import diagnose as jdiagnose
from gnn_fluid_dynamics_tpu.training import sweep as jsweep
from gnn_fluid_dynamics_tpu.training.config import Config as JaxConfig
from gnn_fluid_dynamics_tpu.training.logging import Logger as JaxLogger

from gnn_fluid_dynamics_tpu_torch.graph import from_geometry
from gnn_fluid_dynamics_tpu_torch.models.base import ModelConfig
from gnn_fluid_dynamics_tpu_torch.models.registry import get_model_class
from gnn_fluid_dynamics_tpu_torch.rollout.run import restore_model
from gnn_fluid_dynamics_tpu_torch.training import (diagnose, profiling,
                                                   sweep, train)
from gnn_fluid_dynamics_tpu_torch.training.checkpoint import Checkpointer
from gnn_fluid_dynamics_tpu_torch.training.config import Config
from gnn_fluid_dynamics_tpu_torch.training.logging import Logger
from gnn_fluid_dynamics_tpu_torch.weights import params_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTHETIC = os.path.join(ROOT, "config", "train_synthetic.json")
HIDDEN, MP = 32, 2
HEAD_RTOL, HEAD_ATOL = 1e-5, 1e-6
STATS = ("corr", "rel", "pred_mean", "pred_std", "tgt_mean", "tgt_std")


# ---- profiling ----------------------------------------------------------------

def test_trace_writes_a_file_with_the_annotation(tmp_path):
    """A span recorded under ``trace`` is the trace's host range
    ``gfd::<name>``; outside ``recording`` it marks nothing."""
    with profiling.trace(str(tmp_path / "on")), profiling.recording():
        with profiling.span("tools_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with profiling.trace(str(tmp_path / "off")):
        with profiling.span("tools_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    for sub, want in (("on", 1), ("off", 0)):
        files = glob.glob(str(tmp_path / sub / "*.pt.trace.json"))
        assert len(files) == 1
        with open(files[0]) as f:
            ranges = [e for e in json.load(f)["traceEvents"]
                      if e.get("name") == "gfd::tools_region"]
        assert len(ranges) == want
        assert all(e["cat"] == "user_annotation" for e in ranges)


def test_device_memory_stats_off_the_card():
    assert profiling.device_memory_stats(torch.device("cpu")) == {}
    assert profiling.device_memory_stats("cpu") == {}
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}


def test_resolve_device_names_the_card_by_its_index(monkeypatch):
    """``"cuda"`` resolves to ``cuda:<current card>``, the device a tensor
    on the card reports, so that an entry point's model and its dataset's
    graphs compare equal (``rollout_scan`` refuses a graph on another
    device than the model's: ``training.train``'s and ``rollout.run``'s
    default ``--device cuda`` failed there at the first validation)."""
    import gnn_fluid_dynamics_tpu_torch as pkg
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert pkg.resolve_device("cuda") == torch.device("cuda", 3)
    assert pkg.resolve_device() == torch.device("cuda", 3)
    assert pkg.resolve_device("cuda:1") == torch.device("cuda", 1)
    assert pkg.resolve_device(torch.device("cpu")) == torch.device("cpu")


# ---- diagnose -----------------------------------------------------------------

def _pair(name, graph_fn, scale_init="stats"):
    """The JAX model ``name`` (hidden HIDDEN, MP blocks, f32, plain route)
    initialized from PRNGKey(0) with statistics of its graph, and the port's
    with the same weights and statistics: (jax model, variables, graph,
    feats, port model, graph, feats)."""
    gj, gt = graph_fn()
    jm = jax_model_class(name)(JaxModelConfig(
        name=name, hidden_width=HIDDEN, mp_num=MP, aggregation="segment",
        scale_init=scale_init))
    _, jfeats = jm.transform_features(gj, None, mode="rollout")
    acc = JaxStatsAccumulator(jm.nmap)
    acc.update(jfeats, jax_masks(gj, jfeats))
    stats = acc.finalize()
    jm.set_stats(stats)
    variables = jm.init(jax.random.PRNGKey(0), gj, jfeats)
    tm = get_model_class(name)(ModelConfig(
        name=name, hidden_width=HIDDEN, mp_num=MP, aggregation="segment",
        scale_init=scale_init), device="cpu")
    tm.set_stats(jax.tree.map(lambda x: np.asarray(x, np.float32), stats))
    tm.module.load_state_dict(params_from_flax(variables))
    _, tfeats = tm.transform_rollout(gt)
    return jm, variables, gj, jfeats, tm, gt, tfeats


def _cylinder_graphs():
    geom = jax_make_geometry("cylinder", n_points=300, seed=1)
    fields = dict(jax_tg(geom, num_timesteps=3, dt=0.01))
    for loc in ("cell", "face"):
        nb, w = jax_mls.compute_mls_weights(geom[f"{loc}_pos"], 1)
        fields[f"{loc}_grad_weights"], fields[f"{loc}_grad_neighbours"] = w, nb
    return (jax_from_geometry(geom, fields, dt=0.01, pad_multiple=32),
            from_geometry(geom, fields, dt=0.01, pad_multiple=32,
                          device="cpu"))


def _structured_graphs():
    gj = build_graph()
    geom = jax_make_geometry("structured", nx=6, ny=4)
    fields = dict(jax_tg(geom, num_timesteps=3, dt=0.01))
    return gj, from_geometry(geom, fields, dt=0.01, pad_multiple=32,
                             device="cpu")


def _assert_same_report(got, want):
    assert got.keys() == want.keys()
    for head, spaces in want.items():
        if head == "_scalar_params":
            assert got[head] == pytest.approx(spaces, rel=0, abs=0)
            continue
        assert got[head].keys() == spaces.keys(), head
        for space, r in spaces.items():
            for k in STATS:
                a, b = got[head][space][k], r[k]
                assert abs(a - b) <= HEAD_RTOL * abs(b) + HEAD_ATOL, \
                    (head, space, k, a, b)


@pytest.mark.parametrize("name,graphs", [
    ("FluxD", _cylinder_graphs), ("MgnA", _cylinder_graphs),
    ("FvgnA", _structured_graphs)])
def test_head_report_matches_jax(name, graphs):
    jm, variables, gj, jfeats, tm, gt, tfeats = _pair(name, graphs)
    want = jdiagnose.head_report(jm, variables, gj, jfeats)
    got = diagnose.head_report(tm, gt, tfeats)
    _assert_same_report(got, want)
    assert {"normalized", "physical"} <= set(
        next(v for k, v in got.items() if not k.startswith("_")))


def test_head_report_flags_collapse_as_jax_does():
    """JAX ``tests/test_models.py:487``'s case: an untrained FluxD with the
    reference's constant scales on the structured Taylor-Green graph; the
    physical velocity head near rel 1; ``print_report`` flags a head as
    collapsed exactly where its prediction's spread is under 5 % of its
    target's; the learned scales listed."""
    jm, variables, gj, jfeats, tm, gt, tfeats = _pair(
        "FluxD", _structured_graphs, scale_init=None)
    want = jdiagnose.head_report(jm, variables, gj, jfeats)
    got = diagnose.head_report(tm, gt, tfeats)
    _assert_same_report(got, want)
    assert 0.5 < got["face_velocity_x"]["physical"]["rel"] < 2.0
    for head, spaces in got.items():
        if not head.startswith("_"):
            for r in spaces.values():
                assert np.isfinite(r["rel"]) and np.isfinite(r["corr"])
    assert any("scale" in k for k in got["_scalar_params"])
    out = io.StringIO()
    stdout, sys.stdout = sys.stdout, out
    try:
        diagnose.print_report(got, "header")
    finally:
        sys.stdout = stdout
    lines = out.getvalue().splitlines()
    assert lines[0] == "header"
    heads = [(h, sp, r) for h, spaces in got.items() if h != "_scalar_params"
             for sp, r in spaces.items()]
    assert len(lines) == 1 + len(heads) + len(got["_scalar_params"])
    for line, (head, space, r) in zip(lines[1:], heads):
        assert line.split()[:2] == [head, space]
        collapsed = r["tgt_std"] > 0 and r["pred_std"] < 0.05 * r["tgt_std"]
        assert ("COLLAPSED" in line) == collapsed, line
    assert sum(l.strip().startswith("scalar ") for l in lines) == len(
        got["_scalar_params"])


@pytest.fixture(scope="module")
def trained_checkpoint(tmp_path_factory):
    """``config/train_synthetic.json`` at FluxD, trained by the port's
    ``train.main`` on the CPU with a checkpoint."""
    work = tmp_path_factory.mktemp("diag")
    cfg = json.load(open(SYNTHETIC))
    cfg["model"]["name"] = "FluxD"
    cfg["training"]["epochs"] = 1
    cfg["dataset"]["stats_fpath"] = None
    path = work / "fluxd.json"
    path.write_text(json.dumps(cfg))
    cwd = os.getcwd()
    os.chdir(work)
    try:
        train.main(["--config", str(path), "--device", "cpu", "--ckpt-dir",
                    str(work / "ckpt")])
    finally:
        os.chdir(cwd)
    return work, path


def test_diagnose_main_on_a_port_checkpoint(trained_checkpoint, capsys):
    """``diagnose.main --device cpu`` restores the checkpoint (its config
    adopted), probes the asked sample of the validation split, prints the
    report as JSON, or as lines; the report is ``head_report`` of the
    restored model on that sample."""
    work, cfg = trained_checkpoint
    ckpt = str(work / "ckpt")
    report = diagnose.main(["--config", str(cfg), "--ckpt", ckpt, "--json",
                            "--device", "cpu", "--sample", "1"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(report))
    model, config, meta = restore_model(ckpt + "/latest", torch.device("cpu"))
    _, ds = train.build_datasets(config, type(model), splits=("valid",),
                                 device="cpu")
    graph = ds.get_item(1)
    _, feats = model.transform_rollout(graph)
    assert diagnose.head_report(model, graph, feats) == report
    assert "face_flux" in report and "_scalar_params" in report
    diagnose.main(["--config", str(cfg), "--ckpt", ckpt + "/latest",
                   "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"checkpoint {ckpt}/latest (mini_epoch "
                               f"{meta['mini_epoch']}) model FluxD")
    assert any(l.strip().startswith("cell_velocity_change") for l in lines)
    with pytest.raises(FileNotFoundError):
        diagnose.main(["--config", str(cfg), "--ckpt", str(work / "none"),
                       "--device", "cpu"])


def test_diagnose_needs_a_card_unless_asked_for_the_cpu(trained_checkpoint):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    work, cfg = trained_checkpoint
    with pytest.raises(RuntimeError, match="no CUDA device"):
        diagnose.main(["--config", str(cfg), "--ckpt", str(work / "ckpt")])


# ---- sweep --------------------------------------------------------------------

@pytest.mark.parametrize("name", ["sweep.json", "sweep-multi.json"])
def test_sweep_combinations_match_jax(name):
    cfg = json.load(open(os.path.join(ROOT, "config", name)))
    got = sweep.generate_parameter_combinations(cfg)
    assert got == jsweep.generate_parameter_combinations(cfg)
    assert len(got) == {"sweep.json": 8, "sweep-multi.json": 4}[name]
    a, b = {"x": {"y": 1}}, {"x": {"y": 1}}
    for key, value in got[0].items():
        sweep.set_nested_value(a, key, value)
        jsweep.set_nested_value(b, key, value)
    assert a == b


@pytest.mark.parametrize("shard", [0, 1, 2])
def test_sweep_dry_run_and_sharding_match_jax(tmp_path, monkeypatch, capsys,
                                              shard):
    """Each shard's dry run lists the same combinations in both packages,
    with the base config found relative to the repository from another
    working directory."""
    monkeypatch.chdir(tmp_path)
    path = os.path.join(ROOT, "config", "sweep.json")
    args = ["--config", path, "--shard-index", str(shard), "--num-shards",
            "3", "--dry-run"]
    jsweep.main(args)
    want = capsys.readouterr().out
    sweep.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    assert got.count("[sweep ") == len(range(shard, 8, 3))


def _sweep_config(tmp_path, base):
    base_path = tmp_path / "base.json"
    base_path.write_text(json.dumps(base))
    sweep_path = tmp_path / "sweep.json"
    sweep_path.write_text(json.dumps({
        "base_config": "base.json", "mode": "grid",
        "parameters": {"training.lr_max": [1e-3, 3e-4]}}))
    return str(sweep_path)


def test_sweep_runs_a_job_on_the_cpu(tmp_path, monkeypatch):
    """Shard 0 of 2 runs combination 0 as ``training.train --device cpu``
    in a subprocess: exit code 0, its run directory ``<name>-0`` with a
    ``metrics.jsonl`` (the base config resolved next to the sweep file)."""
    monkeypatch.chdir(tmp_path)
    base = json.load(open(SYNTHETIC))
    base["training"].update(epochs=1, mini_epoch_size=4,
                            data_timestep_range=[0, 4])
    base["rollout"]["data_timestep_range"] = [0, 3]
    base["logging"].update(name="sw", valid_frequency=1, save_frequency=0)
    base["dataset"]["stats_fpath"] = None
    cfg = _sweep_config(tmp_path, base)
    sweep.main(["--config", cfg, "--shard-index", "0", "--num-shards", "2",
                "--device", "cpu"])
    runs = glob.glob(str(tmp_path / "runs" / "synthetic" / "default" /
                         "sw-0(*)" / "metrics.jsonl"))
    assert len(runs) == 1
    with open(runs[0]) as f:
        assert any("train/total_log_loss" in json.loads(l) for l in f)
    assert not glob.glob(str(tmp_path / "runs" / "*" / "*" / "sw-1(*)"))


def test_sweep_stops_with_a_failing_jobs_exit_code(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.chdir(tmp_path)
    base = json.load(open(SYNTHETIC))
    base["model"]["name"] = "NoSuchModel"
    cfg = _sweep_config(tmp_path, base)
    with pytest.raises(SystemExit) as exc:
        sweep.main(["--config", cfg, "--device", "cpu"])
    assert exc.value.code not in (0, None)
    out = capsys.readouterr().out
    assert f"[sweep 0] FAILED rc={exc.value.code}; aborting" in out
    assert "[sweep 1]" not in out


# ---- the logger's sinks -------------------------------------------------------

def _tb_events(run_dir):
    """(tag, step, value) of every scalar in the run's event files, read by
    TensorBoard's own loader."""
    from tensorboard.backend.event_processing.event_file_loader import \
        EventFileLoader
    from tensorboard.util import tensor_util
    out = []
    for path in sorted(glob.glob(os.path.join(run_dir, "tb",
                                              "events.out.tfevents*"))):
        for ev in EventFileLoader(path).Load():
            for v in ev.summary.value:
                out.append((v.tag, ev.step, float(
                    tensor_util.make_ndarray(v.tensor)),
                    v.metadata.plugin_data.plugin_name))
    return out


def _log_some(logger):
    logger.save_loss({"total_log_loss": 1.25, "face_flux_loss": 3}, 3, "train")
    logger.save_scalar(0.5, 4, "lr")
    logger.save_scalar(2, 5, "valid/total_mean_error")
    logger.save_plot([1.0, 2.0], 5, "curves")
    logger.close()


def test_tensorboard_sink_matches_jax(tmp_path):
    pytest.importorskip("tensorboard")
    pytest.importorskip("tensorflow")
    d = {"logging": {"name": "tb", "use_tensorboard": True}}
    jl = JaxLogger(JaxConfig.from_dict(d), base_dir=str(tmp_path / "j"))
    tl = Logger(Config.from_dict(d), base_dir=str(tmp_path / "t"))
    _log_some(jl)
    _log_some(tl)
    want, got = _tb_events(jl.directory), _tb_events(tl.directory)
    assert got == want
    assert [(t, s) for t, s, _, _ in got] == [
        ("train/total_log_loss", 3), ("train/face_flux_loss", 3), ("lr", 4),
        ("valid/total_mean_error", 5)]
    with open(os.path.join(tl.directory, "metrics.jsonl")) as f:
        assert len(f.readlines()) == 4


def test_absent_wandb_says_so_and_carries_on(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)
    d = {"logging": {"name": "wb", "use_wandb": True}}
    for mod, cfg in ((JaxLogger, JaxConfig), (Logger, Config)):
        logger = mod(cfg.from_dict(d), base_dir=str(tmp_path / mod.__module__))
        assert logger.wandb is None
        _log_some(logger)
        with open(os.path.join(logger.directory, "metrics.jsonl")) as f:
            assert len(f.readlines()) == 4
    out = capsys.readouterr().out.splitlines()
    msgs = [l for l in out if l.startswith("wandb unavailable")]
    assert len(msgs) == 2 and msgs[0] == msgs[1]
    assert msgs[0].endswith("falling back to JSONL only")


def _fake_wandb():
    """A stand-in for the wandb module that records its runs' inits, logs
    and artifacts; each new run takes the id ``run-<n>``."""
    wb = types.ModuleType("wandb")
    wb.inits, wb.logs, wb.artifacts = [], [], []

    class Artifact:
        def __init__(self, name, type, metadata):
            self.name, self.metadata, self.dirs = name, metadata, []

        def add_dir(self, path):
            self.dirs.append(path)

    def init(**kw):
        wb.inits.append(kw)
        return types.SimpleNamespace(
            id=kw["id"] or f"run-{len(wb.inits) - 1}",
            log=lambda record, step: wb.logs.append((record, step)),
            log_artifact=wb.artifacts.append, finish=lambda: None)

    wb.Artifact, wb.init = Artifact, init
    return wb


def test_both_sinks_take_each_records_step(tmp_path, monkeypatch):
    """With wandb and TensorBoard both on, each sink gets the record's step.
    The JAX package's wandb branch pops the step first, so its TensorBoard
    scalars all land at step 0; the tags and values are still its own."""
    pytest.importorskip("tensorboard")
    pytest.importorskip("tensorflow")
    wb = _fake_wandb()
    monkeypatch.setitem(sys.modules, "wandb", wb)
    d = {"logging": {"name": "both", "use_wandb": True,
                     "use_tensorboard": True}}
    jl = JaxLogger(JaxConfig.from_dict(d), base_dir=str(tmp_path / "j"))
    _log_some(jl)
    wb.logs.clear()
    tl = Logger(Config.from_dict(d), base_dir=str(tmp_path / "t"))
    _log_some(tl)
    want, got = _tb_events(jl.directory), _tb_events(tl.directory)
    steps = [3, 3, 4, 5]
    assert [s for _, s, _, _ in want] == [0] * 4
    assert got == [(t, s, v, p) for (t, _, v, p), s in zip(want, steps)]
    assert wb.logs == [
        ({"train/total_log_loss": 1.25, "train/face_flux_loss": 3.0}, 3),
        ({"lr": 0.5}, 4), ({"valid/total_mean_error": 2.0}, 5),
        ({"curves": [1.0, 2.0]}, 5)]
    with open(os.path.join(tl.directory, "metrics.jsonl")) as f:
        assert [json.loads(l)["step"] for l in f] == [3, 4, 5, 5]


def test_resume_continues_the_checkpoints_wandb_run(tmp_path, monkeypatch):
    """``train.main`` records the logger's wandb run id in each
    checkpoint's meta and uploads the checkpoint as an artifact; a run
    resumed from it opens that wandb run again (``resume="must"``)."""
    wb = _fake_wandb()
    monkeypatch.setitem(sys.modules, "wandb", wb)
    monkeypatch.chdir(tmp_path)
    cfg = json.load(open(SYNTHETIC))
    cfg["training"]["epochs"] = 1
    cfg["dataset"]["stats_fpath"] = None
    cfg["logging"]["use_wandb"] = True
    path = tmp_path / "wb.json"
    path.write_text(json.dumps(cfg))
    ckpt = str(tmp_path / "ckpt")
    args = ["--config", str(path), "--device", "cpu", "--ckpt-dir", ckpt]
    train.main(args)
    first = wb.inits[0]
    assert first["id"] is None and first["resume"] is None
    latest = Checkpointer(ckpt).resolve("latest")
    with open(os.path.join(latest, "meta.json")) as f:
        assert json.load(f)["wandb_id"] == "run-0"
    assert wb.artifacts and all(a.name == "model-ckpt" and len(a.dirs) == 1
                                for a in wb.artifacts)
    assert wb.artifacts[-1].dirs == [latest]
    train.main(args + ["--resume", "latest"])
    assert len(wb.inits) == 2
    assert wb.inits[1]["id"] == "run-0" and wb.inits[1]["resume"] == "must"
