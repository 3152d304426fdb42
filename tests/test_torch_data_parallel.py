"""The port's data-parallel training (``parallel/data_parallel.py``,
``Trainer.dp_train_step``, ``dp_train_step_indexed``, the data-parallel
loop of ``Trainer.run`` and ``train.main`` under a launch of several ranks)
on the CPU with gloo, against the single process and against the JAX
package's ``make_dp_train_step`` and ``Trainer.run`` on a 2-device CPU mesh.

One rank runs in the test process (a gloo group of one, its rendezvous a
file under ``tmp_path``). Two ranks run in two processes started once for
the module (``torch.multiprocessing``, one intra-op thread each, a file
store under the module's temporary directory, never a fixed port): they run
every scenario of ``tests/torch_dp_ranks.py`` and save what they found,
which the tests here read.

Tolerances: the DP step against the single step, one rank or two ranks on
one batch, two ranks on two batches against rank 0's own step from the mean
of both gradients, and the indexed call against its steps, bit for bit;
against the JAX package's DP step (FvgnD and FluxD, hidden 16, one block,
f32, noise and flip off, two steps from the same converted weights, rank
r on mesh r): each step's mean losses within FUSED_LOSS_RTOL (a single
process's first step on mesh m1 alone parts from the JAX package's by
2.9e-5 in its continuity loss, by 3.2e-6 on m0); AdamW's moments, which
carry the averaged gradients, within MOMENT_RTOL of optax's ``mu`` and
``nu`` (the largest error of a tensor over its largest magnitude; 3.4e-5
seen, where the gradients of rank 0's mesh alone part by 2.4e-2 or more);
every parameter within 2 k lr + 1e-6
(k = 2 steps: an AdamW step moves an element by about lr whatever its
gradient, so this bound holds any two runs, and the moments are what see
the gradients); the BatchNorm running statistics within BATCH_STATS_RTOL
(means over two ranks of f32 batch statistics); ``Trainer.run``'s counters
and learning rates exactly, its mini-epoch losses within FUSED_LOSS_RTOL.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
from test_torch_fused_steps import (FUSED_LOSS_RTOL, LR,
                                    _configs, _train_data, _trajectories)
from torch_dp_ranks import rank_main

from gnn_fluid_dynamics_tpu.data import pipeline as jax_pipeline
from gnn_fluid_dynamics_tpu.models import get_model_class as jax_model_class
from gnn_fluid_dynamics_tpu.models.base import ModelConfig as JaxModelConfig
from gnn_fluid_dynamics_tpu.models.base import feature_masks as jax_masks
from gnn_fluid_dynamics_tpu.models.normalizer import \
    StatsAccumulator as JaxStatsAccumulator
from gnn_fluid_dynamics_tpu.parallel.data_parallel import (make_device_mesh,
                                                           make_dp_train_step,
                                                           replicate,
                                                           shard_batch)
from gnn_fluid_dynamics_tpu.training import trainer as jax_trainer

from gnn_fluid_dynamics_tpu_torch.data import samplers
from gnn_fluid_dynamics_tpu_torch.models.base import ModelConfig
from gnn_fluid_dynamics_tpu_torch.models.registry import get_model_class
from gnn_fluid_dynamics_tpu_torch.parallel import data_parallel
from gnn_fluid_dynamics_tpu_torch.training import trainer
from gnn_fluid_dynamics_tpu_torch.weights import (optimizer_state_from_optax,
                                                  params_from_flax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTHETIC = os.path.join(ROOT, "config", "train_synthetic.json")
HIDDEN, MP, PF = 16, 1, 2
BATCH_STATS_RTOL = 1e-5
MOMENT_RTOL = 1e-4
# (model, epoch): epoch 1 the pushforward warm-up's window slice, epoch 2
# the unroll
JAX_CASES = {"FvgnD-warm": ("FvgnD", 1), "FvgnD-pushforward": ("FvgnD", 2),
             "FluxD-warm": ("FluxD", 1), "FluxD-pushforward": ("FluxD", 2)}
# AdamW's decay moves a weight by lr * 1e-4 of itself a step: at 1e-2 that is
# above f32's resolution, at LR below it
DECAY_LR = 1e-2


# ---- the models and data both sides use ----------------------------------------

def _jax_model(name, jds, jcfg):
    """The JAX model ``name`` at HIDDEN/MP (FluxD with its pushforward
    flag) with statistics from the dataset's first sample, and its
    variables from PRNGKey(0)."""
    g = jds.get_batch(jds.sample_map[:1])
    jm = jax_model_class(name)(
        JaxModelConfig(hidden_width=HIDDEN, mp_num=MP,
                       pushforward=True if name == "FluxD" else None),
        loss_weights=jcfg.training.loss_weights)
    _, feats = jm.transform_features(g, None, mode="rollout")
    acc = JaxStatsAccumulator(jm.nmap)
    acc.update(feats, jax_masks(g, feats))
    stats = acc.finalize()
    jm.set_stats(stats)
    variables = jax.tree.map(np.asarray, dict(
        jm.init(jax.random.PRNGKey(0), g, feats)))
    return jm, variables, {k: {s: float(v) for s, v in d.items()}
                           for k, d in stats.items()}


def _spec(name, variables, stats, cfg):
    """What a rank needs to build the port's model ``name`` with these
    weights and statistics."""
    return {"name": name, "hidden": HIDDEN, "mp": MP,
            "pushforward": True if name == "FluxD" else None,
            "loss_weights": cfg.training.loss_weights, "stats": stats,
            "state_dict": params_from_flax(variables)}


def _batches(tds, n=4):
    """The first ``n`` batches of one sample, taken from the two meshes in
    turns, so that two ranks stepping together see different meshes (one
    mesh's neighbouring states give near-equal gradients)."""
    drawn = list(samplers.get_sampler("static_chunked")(
        tds, 1, np.random.default_rng(0)))
    by_mesh = [[b for b in drawn if b[0][0] == m] for m in ("m0", "m1")]
    return [b for pair in zip(*by_mesh) for b in pair][:n]


@pytest.fixture(scope="module")
def setup():
    """The two meshes of the fused tests in both packages, the configs
    (multi_gpu on), and FvgnD, FluxD and ConservativeA in both packages
    from the same weights."""
    jds, tds = _train_data()
    jcfg, cfg = _configs()
    for c in (jcfg, cfg):
        c.settings.multi_gpu = True
    models = {name: _jax_model(name, jds, jcfg)
              for name in ("FvgnD", "FluxD", "ConservativeA")}
    return jds, tds, jcfg, cfg, models


@pytest.fixture(scope="module")
def two_ranks(setup, tmp_path_factory):
    """Two ranks, started once: every scenario of ``torch_dp_ranks``;
    returns ``load(scenario, rank)``."""
    _, tds, _, cfg, models = setup
    work = tmp_path_factory.mktemp("dp_ranks")
    noisy = _configs(noise_std=0.01, dropout=0.1)[1]
    noisy.settings.multi_gpu = True
    refused = {"no_multi_gpu": _configs()[1],
               "num_devices": _configs()[1]}
    refused["num_devices"].settings.multi_gpu = True
    refused["num_devices"].settings.num_devices = 4
    run_cfg = _run_config()[1]
    inputs = {
        "trajectories": [(t.mesh_id, t.geom, t.fields)
                         for t in _trajectories(jax_pipeline.Trajectory,
                                                n=2, steps=(9,))],
        "models": {n: _spec(n, v, s, cfg) for n, (_, v, s) in models.items()},
        "config": cfg, "noisy_config": noisy, "run_config": run_cfg,
        "refused": refused, "batches": _batches(tds), "lr": LR,
        "decay_lr": DECAY_LR,
        "jax_cases": JAX_CASES}
    torch.save(inputs, work / "inputs.pt")
    for name, epochs in (("main.json", 1), ("resume.json", 2)):
        (work / name).write_text(json.dumps(_main_config(epochs)))
    mp.spawn(rank_main, args=(2, str(work)), nprocs=2, join=True)

    def load(scenario, rank):
        return torch.load(work / f"{scenario}_rank{rank}.pt",
                          weights_only=False)
    yield load
    shutil.rmtree(work, ignore_errors=True)


@pytest.fixture
def one_rank(tmp_path):
    """A gloo group of one rank in this process, destroyed after the
    test."""
    data_parallel.init_process_group(
        "cpu", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1)
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


def _port_model(setup, name="FvgnD", **kw):
    _, _, _, cfg, models = setup
    _, variables, stats = models[name]
    m = get_model_class(name)(
        ModelConfig(name=name, hidden_width=HIDDEN, mp_num=MP,
                    aggregation="segment",
                    pushforward=True if name == "FluxD" else None, **kw),
        device="cpu", loss_weights=cfg.training.loss_weights)
    m.set_stats(stats)
    m.module.load_state_dict(params_from_flax(variables))
    return m


def _no_augment(m):
    tt = m.transform_features
    m.transform_features = (
        lambda g, generator=None, mode="rollout", noise_std=0.0: tt(
            g, None, mode, noise_std))
    return m


def _single_step(setup, name, batch, epoch=2, lr=LR):
    """One single-process step of the port's ``name`` from the converted
    weights on ``batch`` at ``lr``, no noise or flip: the losses and the
    state."""
    tds = setup[1]
    single_cfg = _configs()[1]
    tr = trainer.Trainer(single_cfg, _no_augment(_port_model(setup, name)))
    tr.epoch_count = epoch
    state = tr.init_state()
    losses = tr.train_step(state, tds.get_batch(batch), lr)
    return losses, state.module.state_dict()


# ---- one rank --------------------------------------------------------------------

@pytest.mark.parametrize("epoch", [1, 2], ids=["warm_slice", "pushforward"])
def test_one_rank_equals_the_single_process_trainer(setup, one_rank, epoch):
    """A group of one rank: four ``dp_train_step``s with noise, the edge
    flip and dropout drawing from the generator equal four ``train_step``s
    of the single process from the same weights, bit for bit (losses,
    parameters, AdamW's moments, BatchNorm statistics, generator), rank 0
    being seeded as the single process is; and ``multi_gpu`` with one rank
    takes the single path."""
    _, tds, _, _, _ = setup
    noisy = _configs(noise_std=0.01, dropout=0.1)[1]
    single_cfg = _configs(noise_std=0.01, dropout=0.1)[1]
    noisy.settings.multi_gpu = True
    batches = _batches(tds)
    out = {}
    for kind, cfg in (("dp", noisy), ("single", single_cfg)):
        tr = trainer.Trainer(cfg, _port_model(setup, dropout_rate=0.1))
        tr.epoch_count = epoch
        state = tr.init_state()
        step = tr.dp_train_step if kind == "dp" else tr.train_step
        losses = [step(state, tds.get_batch(b), LR) for b in batches]
        out[kind] = (losses, state.module.state_dict(),
                     state.optimizer.state_dict(), state.generator.get_state())
        if kind == "dp":
            assert not tr.data_parallel and tr.train_path(tds) == "single"
    (l1, m1, o1, g1), (l2, m2, o2, g2) = out["dp"], out["single"]
    for a, b in zip(l1, l2):
        assert all(torch.equal(a[k], b[k]) for k in b)
    assert all(torch.equal(m1[k], m2[k]) for k in m2)
    assert any("running_mean" in k for k in m2)
    for i, st in o2["state"].items():
        for key, v in st.items():
            assert torch.equal(o1["state"][i][key], v), (i, key)
    assert torch.equal(g1, g2)


# ---- two ranks -------------------------------------------------------------------

def test_two_ranks_refuse_a_launch_the_config_does_not_ask_for(two_ranks):
    """Under two ranks, a config without ``settings.multi_gpu`` raises (two
    copies of one run), and so does one whose ``num_devices`` is 4."""
    for rank in (0, 1):
        msgs = two_ranks("refusals", rank)
        assert "without settings.multi_gpu" in msgs["no_multi_gpu"]
        assert "num_devices = 4" in msgs["num_devices"]


def test_two_ranks_on_one_batch_equal_one_single_step(setup, two_ranks):
    """Both ranks on the same batch, no augmentation: the mean of two equal
    gradients is that gradient, so the DP step equals one single-process
    pushforward step, losses and state bit for bit, on both ranks."""
    losses, want = _single_step(setup, "FvgnD", _batches(setup[1])[0])
    for rank in (0, 1):
        got = two_ranks("same_batch", rank)
        assert all(torch.equal(got["losses"][k], losses[k]) for k in losses)
        assert all(torch.equal(got["state"][k], want[k]) for k in want)


def test_two_ranks_on_two_batches_take_the_mean_of_their_gradients(two_ranks):
    """Each rank on its own batch, no augmentation: on rank 0 the DP step
    equals, bit for bit (losses, parameters and buffers, AdamW's moments),
    the step that rank 0 takes alone from the mean of both batches'
    gradients and BatchNorm statistics, then the clip and AdamW (the sum of
    two f32 values does not depend on their order); and it differs in each
    from the step on rank 0's batch alone, so a missing or misplaced
    reduction shows."""
    got = two_ranks("two_batches", 0)
    assert all(got["mean"].values()), got
    assert not any(got["rank0_alone"].values()), got


def _jax_dp_steps(setup, name, epoch):
    """Two steps of the JAX package's ``make_dp_train_step`` on a 2-device
    CPU mesh, device d on ``batches[2 s + d]`` at step s, no noise or flip:
    each step's mean losses and the variables after them."""
    jds, _, jcfg, _, models = setup
    jm, variables, _ = models[name]
    optimizer = jax_trainer.select_optimizer(jcfg)
    jtr = jax_trainer.Trainer(jcfg, jm, optimizer=optimizer)
    g = jds.get_batch(jds.sample_map[:1])
    state = jtr.init_state(jax.random.PRNGKey(0), g,
                           jm.transform_features(g, None, mode="rollout")[1])
    state = state.replace(params=variables["params"],
                          batch_stats=variables.get("batch_stats", {}),
                          opt_state=optimizer.init(variables["params"]))

    class NoAugment:
        def __getattr__(self, k):
            return getattr(jm, k)

        def transform_features(self, graph, rng, mode="train", noise_std=0.0):
            return jm.transform_features(graph, None, mode="train")

    mesh = make_device_mesh(2)
    step = make_dp_train_step(NoAugment(), optimizer, mesh, noise_std=0.0,
                              pushforward_factor=PF, with_pf=epoch > 1)
    state = replicate(state, mesh)
    batches = _batches(setup[1])
    losses = []
    for s in range(2):
        graphs = shard_batch([jds.get_batch(batches[2 * s + d])
                              for d in range(2)], mesh)
        state, lj = step(state, graphs, LR)
        losses.append(jax.device_get(lj))
    state = jax.device_get(state)
    return losses, {"params": state.params, "batch_stats": state.batch_stats,
                    "opt_state": _as_tree(state.opt_state)}


def _as_tree(x):
    """An optax state as a checkpoint restored without a template holds it:
    named tuples as mappings, tuples as lists, arrays in numpy."""
    if hasattr(x, "_asdict"):
        return {k: _as_tree(v) for k, v in x._asdict().items()}
    if isinstance(x, (list, tuple)):
        return [_as_tree(v) for v in x]
    if isinstance(x, dict) or hasattr(x, "items"):
        return {k: _as_tree(v) for k, v in x.items()}
    return np.asarray(x)


def _gap(got, want):
    """max |got - want| / max |want| of one moment's tensor (0 where both
    are 0)."""
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    return err / scale if scale else (0.0 if err == 0 else float("inf"))


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_two_ranks_match_jax_dp_step(setup, two_ranks, case):
    """Two ranks on different batches, two steps, against the JAX
    package's DP step on two devices from the same weights: each step's
    mean losses, AdamW's moments against optax's (through
    ``weights.optimizer_state_from_optax``), the parameters and (FvgnD's
    ``FaceAreaNorm``) the averaged BatchNorm statistics, within the module's
    tolerances; rank 1 holds rank 0's state bit for bit."""
    name, epoch = JAX_CASES[case]
    want_losses, variables = _jax_dp_steps(setup, name, epoch)
    opt_state = variables.pop("opt_state")
    want = params_from_flax(variables)
    got = [two_ranks("against_jax", rank)[case] for rank in (0, 1)]
    assert all(torch.equal(got[1]["state"][k], v)
               for k, v in got[0]["state"].items())
    # AdamW's moments carry the averaged gradients: optax's mu and nu
    module = _port_model(setup, name).module
    moments = optimizer_state_from_optax(
        opt_state, trainer.select_optimizer(setup[3], module.parameters()),
        module)["state"]
    names = [n for n, _ in module.named_parameters()]
    for i, st in moments.items():
        for key in ("exp_avg", "exp_avg_sq"):
            gap = _gap(got[0]["moments"][i][key], st[key])
            assert gap <= MOMENT_RTOL, (case, names[i], key, gap)
    for s, (lt, lj) in enumerate(zip(got[0]["losses"], want_losses)):
        assert set(lt) == set(lj)
        for k in lj:
            ref = float(lj[k])
            assert abs(float(lt[k]) - ref) <= FUSED_LOSS_RTOL * abs(ref), (
                case, s, k)
    stats = [k for k in want if "running_" in k]
    assert bool(stats) == (name == "FvgnD")
    for k, v in want.items():
        err = float((got[0]["state"][k] - v).abs().max())
        if k in stats:
            assert err <= BATCH_STATS_RTOL * float(v.abs().max()), (k, err)
            assert not torch.equal(v, params_from_flax(
                setup[4][name][1])[k]), k            # the statistics moved
        else:
            assert err <= 2 * 2 * LR + 1e-6, (k, err)


def test_indexed_dp_call_equals_k_dp_steps(two_ranks):
    """On each rank, from one state, ``dp_train_step_indexed`` of 3
    pushforward steps on the rank's own mesh (its store and start steps)
    equals 3 ``dp_train_step``s on the same windows, with noise, flip and
    dropout drawing: losses, parameters, moments, generator and step, bit
    for bit."""
    for rank in (0, 1):
        got = two_ranks("indexed", rank)
        assert all(got.values()), (rank, got)


def _run_config():
    """``Trainer.run``'s config in both packages: global batch 2, 2 epochs
    (the first the pushforward warm-up), mini-epochs of 2 steps, a save
    every mini-epoch and no validation, ``balanced_chunked``."""
    out = _configs()
    for c in out:
        c.settings.multi_gpu = True
        c.settings.num_devices = 2
        c.training.epochs = 2
        c.training.mini_epoch_size = 4
        c.logging.valid_frequency = 0
        c.logging.save_frequency = 1
        # its draws in a fixed order, so that this process's JAX run and
        # rank 0's sampler draw the same batches (static_chunked's order
        # follows a set's, which each process hashes its own way)
        c.dataset.sampler = "balanced_chunked"
    return out


class _Recorder:
    def __init__(self):
        self.rows = []

    def save_loss(self, values, step, prefix):
        self.rows.append((prefix, step, dict(values)))


def test_run_on_two_ranks_keeps_jax_counters(setup, two_ranks):
    """``Trainer.run`` with ``multi_gpu`` on two ranks against the JAX
    package's with ``num_devices`` 2, same data and weights: the data-
    parallel path, one graph a rank a step, the same epoch, mini-epoch,
    step and sample counts and the same learning rates, mini-epoch losses
    within FUSED_LOSS_RTOL; each epoch's global batches rank 0's sampler's
    on both ranks (``static_chunked`` orders its draws by a set, hashed
    differently in each process), rank r taking sample r of each; the
    ranks' states equal bit for bit; rank 0 alone logs (the monitor
    included) and checkpoints."""
    jds, _, _, _, models = setup
    jcfg = _run_config()[0]
    jm, variables, _ = models["FvgnD"]
    jtr = jax_trainer.Trainer(jcfg, jm)
    assert jtr.dp_mesh is not None and jtr.dp_mesh.devices.size == 2
    g = jds.get_batch(jds.sample_map[:1])
    jstate = jtr.init_state(jax.random.PRNGKey(0), g,
                            jm.transform_features(g, None, mode="rollout")[1])
    jstate = jstate.replace(params=variables["params"],
                            batch_stats=variables["batch_stats"],
                            opt_state=jtr.optimizer.init(variables["params"]))
    jt = jm.transform_features
    jm.transform_features = lambda g, rng, mode="train", noise_std=0.0: jt(
        g, None, mode, noise_std)
    jtr.logger = _Recorder()
    try:
        jtr.run(jstate, jds)
    finally:
        jm.transform_features = jt
    r0, r1 = two_ranks("run", 0), two_ranks("run", 1)
    counters = (jtr.epoch_count, jtr.mini_epoch_count, jtr.step_count,
                jtr.sample_count)
    assert r0["counters"][:4] == r1["counters"][:4] == counters
    assert r0["counters"][4] == jtr.step_count
    assert r0["path"] == "data_parallel"
    assert set(r0["graphs_per_step"]) == {1}
    # each epoch: the global batches are rank 0's sampler's, on both ranks,
    # and rank r trains on sample r of each
    for e in range(2):
        shared, own = r0["epochs"][2 * e], r0["epochs"][2 * e + 1]
        assert shared["shared"] == shared["sampled"]
        assert r1["epochs"][2 * e]["shared"] == shared["sampled"]
        for rank, r in enumerate((r0, r1)):
            assert r["epochs"][2 * e + 1]["own"] == [
                b[rank:rank + 1] for b in shared["sampled"]]
    assert all(torch.equal(r1["state"][k], v) for k, v in r0["state"].items())
    assert r1["rows"] == [] and r1["saved"] == 0
    assert r0["saved"] == jtr.mini_epoch_count

    def logged(rows, key):
        return [(s, v[key]) for p, s, v in rows
                if p == "train" and isinstance(v, dict) and key in v]
    assert (logged(r0["rows"], "learning_rate")
            == logged(jtr.logger.rows, "learning_rate"))
    assert (logged(r0["rows"], "sample_count")
            == logged(jtr.logger.rows, "sample_count"))
    got = logged(r0["rows"], "total_log_loss")
    want = logged(jtr.logger.rows, "total_log_loss")
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert abs(a - b) <= FUSED_LOSS_RTOL * abs(b), (a, b)
    # data-parallel, the monitor logs the update and the parameters alone
    keys = {p for p, _, _ in r0["rows"]}
    assert "updates/face_mlp" in keys and not any(
        k.startswith("gradients/") or k.endswith("_grad") for k in keys)


def test_unreached_parameter_decays_under_dp_as_alone(setup, two_ranks):
    """ConservativeA's last cell MLP, which its loss does not reach: after
    one DP step of two ranks on one batch (at DECAY_LR) it has AdamW's
    decay, as after a single-process step, bit for bit, and it moved."""
    _, want = _single_step(setup, "ConservativeA", _batches(setup[1])[0],
                           epoch=1, lr=DECAY_LR)
    got = two_ranks("unreached", 0)["state"]
    init = params_from_flax(setup[4]["ConservativeA"][1])
    unreached = [k for k in want if ".cell_mlp." in k
                 and k.startswith(f"blocks.{MP - 1}.")]
    assert unreached
    for k in unreached:
        assert torch.equal(got[k], want[k]), k
        # a weight decays; a bias at 0 stays there
        assert torch.equal(got[k], init[k]) == (not init[k].any()), k


def _main_config(epochs):
    """``config/train_synthetic.json`` (FvgnA) with ``multi_gpu``, global
    batch 2, ``epochs`` epochs, a mini-epoch of 4 steps, validation and a
    checkpoint every mini-epoch."""
    with open(SYNTHETIC) as f:
        raw = json.load(f)
    raw["settings"]["multi_gpu"] = True
    raw["training"].update(epochs=epochs, mini_epoch_size=8)
    raw["rollout"].update(data_timestep_range=[0, 4])
    raw["logging"].update(save_frequency=1)
    return raw


def test_train_main_under_two_ranks_then_resume(two_ranks):
    """``train.main`` under a two-rank launch (torchrun's RANK, WORLD_SIZE,
    LOCAL_RANK; a file store): one epoch of 20 global steps of 2 samples
    (5 mini-epochs), validation on rank 0 alone (before and every 2
    mini-epochs), rank 0 alone logs, monitors and checkpoints; then
    ``--resume latest`` (the checkpoint of the epoch's last mini-epoch) for
    the second epoch: the counters go on from it, the replicas stay equal,
    and rank 1's generator, reseeded from the seed and the step, differs from rank 0's."""
    r0, r1 = two_ranks("train_main", 0), two_ranks("train_main", 1)
    first = r0["first"]
    assert first["counters"] == r1["first"]["counters"] == (1, 5, 20, 40, 20)
    assert first["validations"] == [0, 2, 4]
    assert r1["first"]["validations"] == []
    for run in ("first", "resumed"):
        assert r0[run]["duties"] == (True, True, True)
        assert r1[run]["duties"] == (False, False, False)
    res = r0["resumed"]
    assert res["counters"] == r1["resumed"]["counters"] == (2, 10, 40, 80, 40)
    for run in ("first", "resumed"):
        assert all(torch.equal(r1[run]["state"][k], v)
                   for k, v in r0[run]["state"].items())
    assert not torch.equal(r0["resumed"]["generator"],
                           r1["resumed"]["generator"])
    assert r0["resumed"]["validations"] == [5, 6, 8, 10]
    assert r1["resumed"]["validations"] == []
