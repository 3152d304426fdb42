"""The port's fused train calls (``steps_per_call > 1``) and the data they
read, against the JAX package's: ``get_batch_stack``, ``device_fields`` and
``estimate_device_field_bytes``; the feeds ``prefetch``,
``prefetch_grouped`` and ``prefetch_indexed``; ``train_step_multi`` and
``train_step_indexed`` against ``k`` single steps and against the JAX
package's scan-fused calls; ``Trainer.run`` at ``steps_per_call`` 4; and
the recipe of ``config/e2e/fluxd-r5.json`` (16 steps a call) on the CPU.

Tolerances: the data exactly (the same numpy arrays, copied); the fused
calls against ``k`` single steps bit for bit, noise, flip and dropout on
(the same steps, drawing from the generator in the same order); against
the JAX package in f32 with noise and flip off (FvgnD, hidden 16, one
block, pushforward 2): the first step's losses within F32_LOSS_RTOL (as
``tests/test_torch_train.py``), each later step's within FUSED_LOSS_RTOL
and every parameter within 2 k lr + 1e-6 (AdamW moves a parameter by at
most ~lr a step, and a gradient element near 0 may take either sign in the
two packages, so an element may part by 2 lr a step); the mini-epoch means
of ``Trainer.run`` within FUSED_LOSS_RTOL, its counters and learning rates
exactly.
"""

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from gnn_fluid_dynamics_tpu.data import pipeline as jax_pipeline
from gnn_fluid_dynamics_tpu.data import samplers as jax_samplers
from gnn_fluid_dynamics_tpu.data.synthetic import (make_geometry,
                                                   taylor_green_trajectory)
from gnn_fluid_dynamics_tpu.models import get_model_class as jax_model_class
from gnn_fluid_dynamics_tpu.models.base import ModelConfig as JaxModelConfig
from gnn_fluid_dynamics_tpu.models.base import feature_masks as jax_masks
from gnn_fluid_dynamics_tpu.models.normalizer import \
    StatsAccumulator as JaxStatsAccumulator
from gnn_fluid_dynamics_tpu.training import trainer as jax_trainer
from gnn_fluid_dynamics_tpu.training.config import Config as JaxConfig

from gnn_fluid_dynamics_tpu_torch.data import pipeline, samplers
from gnn_fluid_dynamics_tpu_torch.models.base import ModelConfig
from gnn_fluid_dynamics_tpu_torch.models.registry import get_model_class
from gnn_fluid_dynamics_tpu_torch.training import train, trainer
from gnn_fluid_dynamics_tpu_torch.training.config import Config, load_config
from gnn_fluid_dynamics_tpu_torch.weights import params_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(ROOT, "config", "e2e", "fluxd-r5.json")
HIDDEN, MP, PF, WINDOW = 16, 1, 2, 4
F32_LOSS_RTOL = 1e-5
FUSED_LOSS_RTOL = 1e-4
LR = 1e-4


# ---- data ----------------------------------------------------------------------

def _trajectories(kind, n=5, steps=(8, 9, 10, 11)):
    """``n`` small meshes of two sizes, trajectories of several lengths."""
    out = []
    for i in range(n):
        geom = make_geometry("structured", nx=4 + i % 2, ny=3)
        fields = taylor_green_trajectory(geom, num_timesteps=steps[i % len(steps)],
                                         dt=0.01)
        out.append(kind(mesh_id=f"m{i}", geom=geom, fields=dict(fields)))
    return out


@pytest.fixture(scope="module")
def datasets():
    """The same five trajectories in both packages, window 4."""
    return (jax_pipeline.MeshDataset(_trajectories(jax_pipeline.Trajectory),
                                     data_window=WINDOW, pad_multiple=32),
            pipeline.MeshDataset(_trajectories(pipeline.Trajectory),
                                 data_window=WINDOW, pad_multiple=32,
                                 device="cpu"))


def _fields(graph):
    return {k: np.asarray(getattr(graph, k)) for k in pipeline.FIELD_KEYS
            if getattr(graph, k) is not None}


def test_device_fields_and_batch_stack_match_jax(datasets):
    """``estimate_device_field_bytes``, ``device_fields`` (a combination
    with a repeated mesh and trajectories of different lengths included:
    T is the shortest, padding zeros) and ``get_batch_stack`` equal the JAX
    package's, array for array; the store is cached per combination."""
    jds, tds = datasets
    assert tds.estimate_device_field_bytes() == jds.estimate_device_field_bytes()
    for combo in (("m0", "m1"), ("m0", "m2", "m0"), ("m1", "m3", "m4")):
        want, got = jds.device_fields(combo), tds.device_fields(combo)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert tds.device_fields(combo) is got
    batches = [[("m1", 0), ("m3", 2)], [("m1", 4), ("m3", 1)],
               [("m1", 3), ("m3", 3)]]
    (gj, sj), (gt, st) = jds.get_batch_stack(batches), tds.get_batch_stack(batches)
    assert set(st) == set(sj) and gt.num_graphs == gj.num_graphs == 2
    for k in sj:
        assert st[k].shape == (3, *np.asarray(sj[k]).shape[1:])
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(sj[k]))
        for i, b in enumerate(batches):
            np.testing.assert_array_equal(st[k][i].numpy(),
                                          _fields(tds.get_batch(b))[k])
    with pytest.raises(ValueError, match="one mesh combination"):
        tds.get_batch_stack([batches[0], [("m0", 0), ("m3", 0)]])


def _items(feed):
    """A feed's items as comparable tuples: kind, mesh combination, and
    the numpy arrays it carries (windows, stacks or start steps)."""
    out = []
    for item in feed:
        kind, graph = item[0], item[1]
        if kind == "single":
            out.append((kind, graph.num_cells, _fields(graph)))
        elif kind == "multi":
            out.append((kind, graph.num_cells,
                        {k: np.asarray(v) for k, v in item[2].items()}))
        else:
            out.append((kind, graph.num_cells, np.asarray(item[3]),
                        {k: np.asarray(v) for k, v in item[2].items()}))
    return out


def _assert_items_equal(got, want):
    assert [g[:2] for g in got] == [w[:2] for w in want]
    for g, w in zip(got, want):
        for a, b in zip(g[2:], w[2:]):
            if isinstance(b, dict):
                assert set(a) == set(b)
                for k in b:
                    np.testing.assert_array_equal(a[k], b[k])
            else:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sampler", ["static_chunked", "balanced_chunked",
                                     "multi_mesh"])
@pytest.mark.parametrize("feed", ["prefetch", "prefetch_grouped",
                                  "prefetch_indexed"])
def test_feeds_match_jax(datasets, sampler, feed):
    """For the same sampler batches (batch 2, k = 3) each feed yields the
    JAX package's items in its order: the kinds, each call's group (a run
    cut into groups of k; the grouped feed's tail as single batches, the
    indexed feed's as a shorter group) and the data, equal."""
    jds, tds = datasets
    rj, rt = np.random.default_rng(3), np.random.default_rng(3)
    bj = list(jax_samplers.get_sampler(sampler)(jds, 2, rj))
    bt = list(samplers.get_sampler(sampler)(tds, 2, rt))
    assert bt == bj
    if feed == "prefetch":
        want = _items(("single", g) for g in jax_pipeline.prefetch(iter(bj), jds))
        got = _items(("single", g) for g in pipeline.prefetch(iter(bt), tds))
    elif feed == "prefetch_grouped":
        want = _items(jax_pipeline.prefetch_grouped(iter(bj), jds, 3))
        got = _items(pipeline.prefetch_grouped(iter(bt), tds, 3))
    else:
        want = _items(jax_pipeline.prefetch_indexed(iter(bj), jds, 3))
        got = _items(pipeline.prefetch_indexed(iter(bt), tds, 3))
    assert len(got) > 1
    _assert_items_equal(got, want)


class _Failing:
    """A dataset whose third ``get_batch`` or ``get_batch_stack`` raises."""

    def __init__(self, ds):
        self.ds, self.calls = ds, 0

    def _count(self):
        self.calls += 1
        if self.calls == 3:
            raise RuntimeError("batch 3 is broken")

    def get_batch(self, samples):
        self._count()
        return self.ds.get_batch(samples)

    def get_batch_stack(self, groups):
        self._count()
        return self.ds.get_batch_stack(groups)


@pytest.mark.parametrize("feed", ["prefetch", "prefetch_grouped"])
def test_a_worker_exception_reaches_the_caller(datasets, feed):
    """The worker's exception is raised in the consuming thread after the
    items before it (the JAX package's feeds end the epoch there without a
    word); a consumer that stops early stops the worker."""
    _, tds = datasets
    batches = [[("m0", t)] for t in range(5)]
    before = threading.active_count()
    got = []
    with pytest.raises(RuntimeError, match="batch 3 is broken"):
        if feed == "prefetch":
            for g in pipeline.prefetch(iter(batches), _Failing(tds), size=1):
                got.append(g)
        else:
            for item in pipeline.prefetch_grouped(iter(batches), _Failing(tds),
                                                  k=2, size=1):
                got.append(item)
    assert len(got) == 2
    feed_iter = pipeline.prefetch(iter(batches * 4), tds, size=1)
    next(feed_iter)
    feed_iter.close()
    assert threading.active_count() == before


# ---- the fused calls -----------------------------------------------------------

def _train_data():
    """Two meshes, 9 states each (6 windows of 4 a mesh), in both
    packages; the batches of static_chunked at batch 2 are one
    combination."""
    trajs = {kind: _trajectories(kind, n=2, steps=(9,))
             for kind in (jax_pipeline.Trajectory, pipeline.Trajectory)}
    return (jax_pipeline.MeshDataset(trajs[jax_pipeline.Trajectory],
                                     data_window=WINDOW, pad_multiple=32),
            pipeline.MeshDataset(trajs[pipeline.Trajectory],
                                 data_window=WINDOW, pad_multiple=32,
                                 device="cpu"))


def _configs(noise_std=0.0, dropout=0.0):
    out = []
    for cls in (JaxConfig, Config):
        cfg = cls()
        cfg.model.name = "FvgnD"
        cfg.training.noise_std = noise_std
        cfg.training.dropout_rate = dropout
        cfg.training.pushforward_factor = PF
        cfg.training.pushforward_warmup_epochs = 1
        cfg.training.batch_size = 2
        cfg.training.lr_max = LR
        cfg.dataset.sampler = "static_chunked"
        out.append(cfg)
    return out


def _models(jds, tds, jcfg, cfg):
    """FvgnD at HIDDEN/MP in both packages: statistics from a graph of the
    JAX dataset, the JAX variables from PRNGKey(0) carried over."""
    g = jds.get_batch(jds.sample_map[:1])
    jm = jax_model_class("FvgnD")(JaxModelConfig(
        hidden_width=HIDDEN, mp_num=MP), loss_weights=jcfg.training.loss_weights)
    _, feats = jm.transform_features(g, None, mode="rollout")
    acc = JaxStatsAccumulator(jm.nmap)
    acc.update(feats, jax_masks(g, feats))
    stats = acc.finalize()
    jm.set_stats(stats)
    tm = get_model_class("FvgnD")(
        ModelConfig(name="FvgnD", hidden_width=HIDDEN, mp_num=MP,
                    aggregation="segment",
                    dropout_rate=cfg.training.dropout_rate),
        device="cpu", loss_weights=cfg.training.loss_weights)
    tm.set_stats({k: {s: float(v) for s, v in d.items()}
                  for k, d in stats.items()})
    jtr = jax_trainer.Trainer(jcfg, jm)
    jstate = jtr.init_state(jax.random.PRNGKey(0), g, feats)
    tm.module.load_state_dict(params_from_flax(jstate.variables))
    return jm, jtr, jstate, tm


def _without_random_transforms(jm, tm):
    """Both models' train-mode transform without noise and flip (no key,
    no generator), as the packages' random streams differ."""
    jt, tt = jm.transform_features, tm.transform_features
    jm.transform_features = lambda g, rng, mode="train", noise_std=0.0: jt(
        g, None, mode, noise_std)
    tm.transform_features = (
        lambda g, generator=None, mode="rollout", noise_std=0.0: tt(
            g, None, mode, noise_std))


def _snapshot(state):
    return ({k: v.clone() for k, v in state.module.state_dict().items()},
            _clone(state.optimizer.state_dict()), state.generator.get_state(),
            state.step)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _restore(state, snap):
    state.module.load_state_dict(snap[0])
    state.optimizer.load_state_dict(_clone(snap[1]))
    state.generator.set_state(snap[2])
    state.step = snap[3]


@pytest.mark.parametrize("epoch", [1, 2], ids=["warm_slice", "pushforward"])
def test_fused_calls_equal_single_steps_bit_for_bit(epoch):
    """From one state (after a first step, so AdamW has moments), k = 4
    ``train_step``s, one ``train_step_multi`` and one
    ``train_step_indexed`` on the same batches and learning rates, with
    noise, the edge flip and dropout drawing from the generator: the same
    losses, parameters, moments, BatchNorm statistics and generator state,
    bit for bit. Epoch 1 is the warm-up (the window's last two states),
    epoch 2 the pushforward unroll."""
    jds, tds = _train_data()
    jcfg, cfg = _configs(noise_std=0.01, dropout=0.1)
    _, _, _, tm = _models(jds, tds, jcfg, cfg)
    tr = trainer.Trainer(cfg, tm)
    tr.epoch_count = epoch
    state = tr.init_state()
    batches = list(samplers.get_sampler("static_chunked")(
        tds, 2, np.random.default_rng(0)))[:5]
    tr.train_step(state, tds.get_batch(batches[0]), LR)
    batches, lrs = batches[1:], [LR, LR, 0.5 * LR, 0.25 * LR]
    snap = _snapshot(state)

    runs = {}
    per_step = [tr.train_step(state, tds.get_batch(b), lr)
                for b, lr in zip(batches, lrs)]
    runs["single"] = (trainer._stack(per_step), _snapshot(state))
    _restore(state, snap)
    g, stack = tds.get_batch_stack(batches)
    runs["multi"] = (tr.train_step_multi(state, g, stack, lrs), _snapshot(state))
    _restore(state, snap)
    combo = tuple(m for m, _ in batches[0])
    ts = np.asarray([[t for _, t in b] for b in batches], np.int32)
    runs["indexed"] = (tr.train_step_indexed(state, tds._batched_static(combo),
                                             tds.device_fields(combo), ts,
                                             lrs, WINDOW), _snapshot(state))
    losses, (module, opt, gen, step) = runs["single"]
    assert step == snap[3] + 4 and all(v.shape == (4,) for v in losses.values())
    assert not torch.equal(gen, snap[2])
    for name in ("multi", "indexed"):
        l2, (m2, o2, g2, s2) = runs[name]
        assert s2 == step and torch.equal(g2, gen), name
        for k in losses:
            assert torch.equal(l2[k], losses[k]), (name, k)
        for k in module:
            assert torch.equal(m2[k], module[k]), (name, k)
        for i, st in opt["state"].items():
            for key, v in st.items():
                assert torch.equal(o2["state"][i][key], v), (name, i, key)


def test_gather_windows_lays_out_as_get_batch():
    """The indexed call's on-device gather gives each step the windows
    ``get_batch`` assembles on the host for the same samples, exactly; a
    start step past the store raises."""
    _, tds = _train_data()
    combo = ("m0", "m1")
    dev = tds.device_fields(combo)
    for ts in ([0, 5], [3, 1], [5, 0]):
        got = trainer.gather_windows(dev, torch.tensor(ts), WINDOW)
        want = _fields(tds.get_batch(list(zip(combo, ts))))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    _, cfg = _configs()
    tr = trainer.Trainer(cfg, get_model_class("FvgnD")(
        ModelConfig(name="FvgnD", hidden_width=HIDDEN, mp_num=MP),
        device="cpu"))
    with pytest.raises(ValueError, match="window of 4"):
        tr.train_step_indexed(tr.init_state(), tds._batched_static(combo), dev,
                              np.asarray([[6, 0]], np.int32), [LR], WINDOW)


def _params_close(jparams, tm, bound):
    want = params_from_flax({"params": jax.tree.map(np.asarray, jparams)})
    for name, p in tm.module.named_parameters():
        err = float((p.detach() - want[name]).abs().max())
        assert err <= bound, (name, err, bound)


@pytest.mark.parametrize("kind", ["multi", "indexed"])
def test_fused_calls_match_jax(kind):
    """One fused call of k = 4 pushforward steps in each package (f32,
    noise and flip off): each step's losses and the parameters after it
    (see the module's docstring for the tolerances)."""
    jds, tds = _train_data()
    jcfg, cfg = _configs()
    jm, jtr, jstate, tm = _models(jds, tds, jcfg, cfg)
    _without_random_transforms(jm, tm)
    tr = trainer.Trainer(cfg, tm)
    jtr.epoch_count = tr.epoch_count = 2
    state = tr.init_state()
    batches = list(samplers.get_sampler("static_chunked")(
        tds, 2, np.random.default_rng(0)))[:4]
    lrs = [LR] * 4
    combo = tuple(m for m, _ in batches[0])
    if kind == "multi":
        jstate, lj = jtr.train_step_multi(jstate, *jds.get_batch_stack(batches),
                                          lrs)
        lt = tr.train_step_multi(state, *tds.get_batch_stack(batches), lrs)
    else:
        ts = np.asarray([[t for _, t in b] for b in batches], np.int32)
        jstate, lj = jtr.train_step_indexed(
            jstate, jds._batched_static(combo), jds.device_fields(combo), ts,
            lrs, WINDOW)
        lt = tr.train_step_indexed(state, tds._batched_static(combo),
                                   tds.device_fields(combo), ts, lrs, WINDOW)
    lj = jax.device_get(lj)
    assert set(lt) == set(lj)
    for k in lj:
        want = np.asarray(lj[k], np.float64)
        rel = np.abs(lt[k].numpy() - want) / max(np.abs(want).max(), 1e-30)
        assert rel[0] <= F32_LOSS_RTOL and rel.max() <= FUSED_LOSS_RTOL, (k, rel)
    _params_close(jstate.params, tm, 2 * 4 * LR + 1e-6)


class _Recorder:
    """A logger that keeps what the trainer logs, by prefix."""

    def __init__(self):
        self.rows = []

    def save_loss(self, values, step, prefix):
        self.rows.append((prefix, step, dict(values)))

    def logged(self, prefix, key):
        return [(s, v[key]) for p, s, v in self.rows
                if p == prefix and key in v]


def test_run_at_four_steps_a_call_matches_jax():
    """``Trainer.run`` at ``steps_per_call`` 4 (static_chunked, batch 2:
    per epoch one call of 4 steps and one of 2; 2 epochs, the first the
    pushforward warm-up; a mini-epoch of 3 steps, so boundaries fall inside
    calls) in both packages from the same weights: both take the indexed
    path; the same counters, learning rates and mini-epochs logged (one a
    boundary crossed), their mean losses within FUSED_LOSS_RTOL."""
    jds, tds = _train_data()
    jcfg, cfg = _configs()
    for c in (jcfg, cfg):
        c.training.steps_per_call = 4
        c.training.epochs = 2
        c.training.mini_epoch_size = 6
        c.logging.valid_frequency = c.logging.save_frequency = 0
    jm, jtr, jstate, tm = _models(jds, tds, jcfg, cfg)
    _without_random_transforms(jm, tm)
    jtr.logger, rec = _Recorder(), _Recorder()
    tr = trainer.Trainer(cfg, tm, logger=rec)
    calls = []
    fused = tr.train_step_indexed

    def counted(state, graph, dev, ts, lrs, window, **kw):
        calls.append(len(lrs))
        return fused(state, graph, dev, ts, lrs, window, **kw)

    tr.train_step_indexed = counted
    assert tr.train_path(tds) == "indexed"
    jtr.run(jstate, jds)
    state = tr.run(tr.init_state(), tds)
    assert calls == [4, 2, 4, 2]
    counters = ("epoch_count", "mini_epoch_count", "step_count", "sample_count")
    assert [getattr(tr, c) for c in counters] == [
        getattr(jtr, c) for c in counters] == [2, 4, 12, 24]
    assert state.step == 12
    assert (rec.logged("train", "learning_rate")
            == jtr.logger.logged("train", "learning_rate"))
    for key in ("total_log_loss", "cell_velocity_change_loss"):
        got, want = rec.logged("train", key), jtr.logger.logged("train", key)
        assert [s for s, _ in got] == [s for s, _ in want] == [1, 2, 3, 4]
        for (_, a), (_, b) in zip(got, want):
            assert abs(a - b) <= FUSED_LOSS_RTOL * abs(b), (key, a, b)


def test_fluxd_r5_recipe_trains(tmp_path, monkeypatch):
    """``config/e2e/fluxd-r5.json``'s training section (AdamW, clip 10, its
    loss weights, noise_std_norm 0.045, pushforward 2, 16 steps a call,
    static_chunked, batch 4) through ``train.main`` on the CPU, cut to
    synthetic data (four meshes, 20 windows each: calls of 16 and 4), one
    epoch, FluxD at hidden 16 and one block: the indexed path, the
    counters, finite mini-epoch losses."""
    monkeypatch.chdir(tmp_path)
    with open(RECIPE) as f:
        raw = json.load(f)
    raw["dataset"].update(module="synthetic", stats_fpath=None)
    raw["model"].update(hidden_width=HIDDEN, mp_num=MP)
    raw["training"].update(data_sim_limit=4, data_timestep_range=[0, 20],
                           epochs=1, mini_epoch_size=32)
    raw["rollout"].update(data_sim_limit=2, data_timestep_range=[0, 3])
    raw["logging"].update(save_frequency=0, valid_frequency=0)
    path = tmp_path / "fluxd-r5-small.json"
    path.write_text(json.dumps(raw))
    cfg = load_config(str(path))
    t = cfg.training
    assert (t.steps_per_call, t.batch_size, t.pushforward_factor,
            cfg.dataset.sampler) == (16, 4, 2, "static_chunked")
    calls = []
    fused = trainer.Trainer.train_step_indexed

    def counted(self, state, graph, dev, ts, lrs, window, **kw):
        calls.append(len(lrs))
        return fused(self, state, graph, dev, ts, lrs, window, **kw)

    monkeypatch.setattr(trainer.Trainer, "train_step_indexed", counted)
    tr, state = train.main(["--config", str(path), "--device", "cpu",
                            "--ckpt-dir", str(tmp_path / "ckpt")])
    assert calls == [16, 4]
    assert (tr.epoch_count, tr.step_count, tr.mini_epoch_count,
            tr.sample_count, state.step) == (1, 20, 2, 80, 20)
    run_dir = next(os.path.join(dp, "metrics.jsonl")
                   for dp, _, files in os.walk("runs") if "metrics.jsonl" in files)
    with open(run_dir) as f:
        losses = [r["train/total_log_loss"] for r in map(json.loads, f)
                  if "train/total_log_loss" in r]
    assert len(losses) == 2 and np.isfinite(losses).all()
