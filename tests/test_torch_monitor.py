"""The port's grad/param monitor (``training/monitoring.py``) against the JAX
package's ``ModelMonitor``: the records of its three methods on the same
converted parameters and gradients; ``weights.flax_paths``, which names
them; the records ``Trainer.run`` writes at each mini-epoch, one step a call
and four (the indexed call), beside the JAX package's ``Trainer.run``; the
gradients taken before the clip; and ``train.main``, which builds a monitor
where the JAX package's does.

Tolerances: the monitor's records on the same numbers within MONITOR_RTOL
(f32 norms summed in another order); ``Trainer.run``'s records (FvgnD,
hidden 16, one block, f32, noise and flip off, two epochs, the first the
pushforward warm-up) within RUN_RTOL of the JAX package's: the two packages'
steps part by f32 rounding, which the gradients' norms and the scalars show
at up to 9.3e-6 over 12 steps; an update's norm, a sum over AdamW's updates
of ~lr an element whose sign may flip where a gradient element is near 0,
within UPDATE_RTOL (3.1e-5 seen); the unclipped norms bit for bit against a
run without clip.
"""

import json
import os

import jax
import numpy as np
import pytest

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
from test_torch_fused_steps import (_configs, _models, _train_data,
                                    _without_random_transforms)

from gnn_fluid_dynamics_tpu.data.synthetic import (make_geometry,
                                                   taylor_green_trajectory)
from gnn_fluid_dynamics_tpu.graph import from_geometry
from gnn_fluid_dynamics_tpu.models import get_model_class as jax_model_class
from gnn_fluid_dynamics_tpu.models.base import ModelConfig as JaxModelConfig
from gnn_fluid_dynamics_tpu.models.base import feature_masks as jax_masks
from gnn_fluid_dynamics_tpu.models.normalizer import \
    StatsAccumulator as JaxStatsAccumulator
from gnn_fluid_dynamics_tpu.training.monitoring import \
    ModelMonitor as JaxModelMonitor

from gnn_fluid_dynamics_tpu_torch.models.base import ModelConfig
from gnn_fluid_dynamics_tpu_torch.models.registry import (MODEL_REGISTRY,
                                                          get_model_class)
from gnn_fluid_dynamics_tpu_torch.training import train, trainer
from gnn_fluid_dynamics_tpu_torch.training.monitoring import ModelMonitor
from gnn_fluid_dynamics_tpu_torch.weights import flax_paths, params_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTHETIC = os.path.join(ROOT, "config", "train_synthetic.json")
HIDDEN = 16
MONITOR_RTOL = 1e-6
RUN_RTOL = 1e-4
UPDATE_RTOL = 1e-3
# one model of each structure the monitor meets: FluxD's learned scales,
# FvgnA's BatchNorm'd face areas, ConservativeA's own encoder and blocks
MONITORED = ("FluxD", "FvgnA", "ConservativeA")


class _Recorder:
    """A logger that keeps what it is given, in order."""

    def __init__(self):
        self.scalars, self.losses = [], []

    def save_scalar(self, value, step, prefix):
        self.scalars.append((prefix, step, float(value)))

    def save_loss(self, values, step, prefix):
        self.losses.append((prefix, step, dict(values)))

    def monitored(self):
        return [r for r in self.scalars if r[0].split("/")[0] in (
            "gradients", "updates", "scalar_params")]


def _assert_same_records(got, want, rtol, update_rtol=None):
    assert [(k, s) for k, s, _ in got] == [(k, s) for k, s, _ in want]
    for (key, step, a), (_, _, b) in zip(got, want):
        tol = update_rtol if (update_rtol and key == "updates/face_mlp") else rtol
        assert abs(a - b) <= tol * abs(b) + 1e-30, (key, step, a, b)


def _jax_variables(name):
    """The JAX model ``name`` at HIDDEN and two blocks, initialized from
    PRNGKey(0) on a small graph with statistics from it."""
    geom = make_geometry("structured", nx=6, ny=4)
    fields = dict(taylor_green_trajectory(geom, num_timesteps=3, dt=0.01))
    g = from_geometry(geom, fields, dt=0.01, pad_multiple=32)
    m = jax_model_class(name)(JaxModelConfig(hidden_width=HIDDEN, mp_num=2))
    _, feats = m.transform_features(g, None, mode="rollout")
    acc = JaxStatsAccumulator(m.nmap)
    acc.update(feats, jax_masks(g, feats))
    m.set_stats(acc.finalize())
    return jax.tree.map(np.asarray, dict(m.init(jax.random.PRNGKey(0), g,
                                                feats)))


@pytest.mark.parametrize("name", MONITORED)
def test_monitor_logs_what_jax_logs(name):
    """The same parameters and seeded gradients in both packages (the Flax
    trees converted by ``params_from_flax``): the decoder's gradient norms
    per output channel, the update between two parameter sets and every
    scalar parameter with its gradient, under the same keys and steps, in
    the same order, within MONITOR_RTOL; the Flax paths of the port's
    parameters are those of the JAX package's tree."""
    variables = _jax_variables(name)
    params = variables["params"]
    rng = np.random.default_rng(0)
    grads = jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), params)
    moved = jax.tree.map(
        lambda x: x + 1e-3 * rng.standard_normal(x.shape).astype(np.float32),
        params)
    jm, want = JaxModelMonitor(), _Recorder()
    jm.monitor_decoder_gradients(grads, want, 1)
    jm.monitor_decoder_updates(params, want, 1)
    jm.monitor_decoder_updates(moved, want, 2)
    jm.monitor_scalar_parameters(moved, grads, want, 2)

    module = get_model_class(name)(ModelConfig(
        name=name, hidden_width=HIDDEN, mp_num=2), device="cpu").module
    flat = {"/".join(str(k.key) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert sorted(flax_paths(module).values()) == sorted(flat)
    tm, got = ModelMonitor(), _Recorder()
    tgrads = params_from_flax(grads)
    module.load_state_dict(params_from_flax(variables))
    tm.monitor_decoder_gradients(module, tgrads, got, 1)
    tm.monitor_decoder_updates(module, got, 1)
    module.load_state_dict(params_from_flax({**variables, "params": moved}))
    tm.monitor_decoder_updates(module, got, 2)
    tm.monitor_scalar_parameters(module, tgrads, got, 2)
    assert got.scalars and any(k.startswith("gradients/") for k, _, _ in got.scalars)
    _assert_same_records(got.scalars, want.scalars, MONITOR_RTOL)


def test_flax_paths_invert_params_from_flax_for_every_model():
    """For each of the 38 models: the tree of Flax paths that
    ``flax_paths`` gives, put back through ``params_from_flax``, names every
    parameter of the port's module and nothing else."""
    for name in sorted(MODEL_REGISTRY):
        module = get_model_class(name)(ModelConfig(
            name=name, hidden_width=HIDDEN, mp_num=2), device="cpu").module
        tree = {}
        for path in flax_paths(module).values():
            node = tree
            *parents, leaf = path.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = np.zeros(1, np.float32)
        assert set(params_from_flax(tree)) == {
            n for n, _ in module.named_parameters()}, name


def _run_both(steps_per_call, clip=None):
    """``Trainer.run`` of FvgnD in both packages from the same weights, each
    with its monitor and a recording logger (the fused tests' set-up: two
    meshes, batch 2, 2 epochs, the first the pushforward warm-up,
    mini-epochs of 3 steps, noise and flip off)."""
    jds, tds = _train_data()
    jcfg, cfg = _configs()
    for c in (jcfg, cfg):
        c.training.steps_per_call = steps_per_call
        c.training.epochs = 2
        c.training.mini_epoch_size = 6
        c.training.clip_grad_norm = clip
        c.logging.valid_frequency = c.logging.save_frequency = 0
    jm, jtr, jstate, tm = _models(jds, tds, jcfg, cfg)
    _without_random_transforms(jm, tm)
    jtr.logger, jtr.monitor = _Recorder(), JaxModelMonitor()
    tr = trainer.Trainer(cfg, tm, logger=_Recorder(), monitor=ModelMonitor())
    jtr.run(jstate, jds)
    tr.run(tr.init_state(), tds)
    return tr, jtr


@pytest.mark.parametrize("steps_per_call", [1, 4])
def test_run_logs_the_monitor_as_jax_does(steps_per_call):
    """At each of the four mini-epoch boundaries (inside fused calls of 4,
    taken after the call) both packages log the gradient norms of the last
    step before the boundary, the decoder's update from the second boundary
    on and the scalar parameters with their gradients, under the same keys
    and steps, in the same order, within RUN_RTOL (updates UPDATE_RTOL)."""
    tr, jtr = _run_both(steps_per_call)
    if steps_per_call > 1:
        assert tr.train_path(tr_ds := _train_data()[1]) == "indexed", tr_ds
    got, want = tr.logger.monitored(), jtr.logger.monitored()
    assert sorted({s for _, s, _ in got}) == [1, 2, 3, 4]
    keys = {k for k, _, _ in got}
    assert {"updates/face_mlp", "gradients/face_mlp_out0",
            "scalar_params/integrator/face_area_norm/MaskedBatchNorm_0/"
            "BatchNorm_0/scale_grad"} <= keys
    _assert_same_records(got, want, RUN_RTOL, UPDATE_RTOL)


class _CountingMonitor(ModelMonitor):
    def __init__(self):
        super().__init__()
        self.copies = 0

    def copy_gradients(self, module):
        self.copies += 1
        return super().copy_gradients(module)


@pytest.mark.parametrize("steps_per_call", [1, 4])
def test_run_copies_the_gradients_once_a_mini_epoch(steps_per_call):
    """``Trainer.run`` (FvgnD, 2 epochs of 6 steps, 3 steps a mini-epoch)
    copies the monitor's gradients once a mini-epoch, in the step that
    closes it (a fused call's last), and in no other step."""
    jds, tds = _train_data()
    _, cfg = _configs()
    cfg.training.steps_per_call = steps_per_call
    cfg.training.epochs = 2
    cfg.training.mini_epoch_size = 6
    cfg.logging.valid_frequency = cfg.logging.save_frequency = 0
    _, _, _, tm = _models(jds, tds, *_configs())
    monitor = _CountingMonitor()
    tr = trainer.Trainer(cfg, tm, logger=_Recorder(), monitor=monitor)
    tr.run(tr.init_state(), tds)
    assert tr.step_count == 12 and tr.mini_epoch_count == 4
    assert monitor.copies == tr.mini_epoch_count


def test_monitor_reads_the_gradients_before_the_clip():
    """With a clip a million times below the gradient norm, the logged
    gradient norms and scalar gradients at the first boundary (after one
    step, one step a mini-epoch) are those of the same step without a
    clip, bit for bit, and not the clipped ones."""
    runs = {}
    for clip in (None, 1e-6):
        jds, tds = _train_data()
        _, cfg = _configs()
        cfg.training.epochs = 1
        cfg.training.mini_epoch_size = 2       # one step a mini-epoch
        cfg.training.clip_grad_norm = clip
        cfg.logging.valid_frequency = cfg.logging.save_frequency = 0
        _, _, _, tm = _models(jds, tds, *_configs())
        tr = trainer.Trainer(cfg, tm, logger=_Recorder(),
                             monitor=ModelMonitor())
        tr.run(tr.init_state(), tds)
        runs[clip] = [r for r in tr.logger.monitored() if r[1] == 1
                      and (r[0].startswith("gradients/")
                           or r[0].endswith("_grad"))]
    assert runs[None] and runs[1e-6] == runs[None]
    largest = max(v for _, _, v in runs[None])
    assert largest > 1e3 * 1e-6


@pytest.mark.parametrize("mode", ["monitor", "use_monitor_false", "debug"])
def test_train_main_builds_the_monitor_where_jax_does(tmp_path, monkeypatch,
                                                      mode):
    """``train.main`` on the synthetic config (FvgnA, one epoch): with a
    logger and ``logging.use_monitor`` the metrics hold the monitor's
    records at every mini-epoch under the JAX package's names (the
    decoder's five output channels, its update, the BatchNorm'd face area's
    scale and bias with their gradients); with ``use_monitor`` false they
    hold none; with ``--debug`` no logger and no monitor exist."""
    monkeypatch.chdir(tmp_path)
    with open(SYNTHETIC) as f:
        raw = json.load(f)
    raw["training"]["epochs"] = 1
    raw["logging"].update(save_frequency=0, valid_frequency=0,
                          use_monitor=mode != "use_monitor_false")
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(raw))
    argv = ["--config", str(path), "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "ckpt")]
    tr, _ = train.main(argv + (["--debug"] if mode == "debug" else []))
    if mode == "debug":
        assert tr.logger is None and tr.monitor is None
        assert not os.path.exists("runs")
        return
    assert (tr.monitor is not None) == (mode == "monitor")
    metrics = next(os.path.join(dp, "metrics.jsonl") for dp, _, files
                   in os.walk("runs") if "metrics.jsonl" in files)
    with open(metrics) as f:
        rows = [json.loads(line) for line in f]
    keys = {k for r in rows for k in r if k not in ("step", "ts")}
    monitored = {k for k in keys if k.split("/")[0] in (
        "gradients", "updates", "scalar_params")}
    if mode == "use_monitor_false":
        assert not monitored
        return
    bn = "scalar_params/integrator/face_area_norm/MaskedBatchNorm_0/BatchNorm_0/"
    assert monitored == (
        {f"gradients/face_mlp_out{i}" for i in range(5)}
        | {"updates/face_mlp"}
        | {bn + leaf + g for leaf in ("scale", "bias") for g in ("", "_grad")})
    steps = {r["step"] for r in rows if "gradients/face_mlp_out0" in r}
    assert steps == set(range(1, tr.mini_epoch_count + 1))
