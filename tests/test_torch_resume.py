"""Resuming a run of the JAX package in the port: checkpoint-12 of the
trained FluxD (``checkpoints/e2e/fluxd/checkpoint-12``: AdamW behind
``clip_by_global_norm(10)``, 52,224 steps) through
``scripts/torch_convert_flax_checkpoint.py``, whose ``state.pt`` now holds
the optimizer's state (``weights.optimizer_state_from_optax``).

Tolerances: the moments exactly (a copy, kernels transposed); one update
from the restored state, optax's against the port's ``optimizer_step``,
within 1e-6 of each tensor's largest magnitude (f32: the two clip, decay
and divide in their own order, a few ulp apart). That holds because the
port takes optax's hyperparameters as ``inject_hyperparams`` keeps them, in
f32: with 0.999 in f64, 1 - b2 is 1e-3 where optax's is 0.99998713e-3,
and a second moment whose new gradient term is half of it parts by ~7e-6.
"""

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
import copy
import json
import importlib.util
import pathlib
import shutil

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnn_fluid_dynamics_tpu.training import trainer as jax_trainer
from gnn_fluid_dynamics_tpu.training.config import Config as JaxConfig

from gnn_fluid_dynamics_tpu_torch.data.pipeline import MeshDataset, Trajectory
from gnn_fluid_dynamics_tpu_torch.training import train
from gnn_fluid_dynamics_tpu_torch.training.checkpoint import (
    Checkpointer, restore_train_state)
from gnn_fluid_dynamics_tpu_torch.training.config import Config
from gnn_fluid_dynamics_tpu_torch.training.model_loading import (
    backward_compatibility)
from gnn_fluid_dynamics_tpu_torch.training.trainer import (Trainer,
                                                           optimizer_step,
                                                           select_optimizer)
from gnn_fluid_dynamics_tpu_torch.weights import (optimizer_state_from_optax,
                                                  params_from_flax)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CKPT = ROOT / "checkpoints/e2e/fluxd/checkpoint-12"
DATA = ROOT / "rollouts/e2e/rollout-cyl/data0.h5"
CONVERTER = ROOT / "scripts/torch_convert_flax_checkpoint.py"
DT = 0.00817                  # test_torch_rollout_run's fit of mesh_0's dt
STEP = 52224
UPDATE_RTOL = 1e-6
GRAD_STD = 0.01               # global norm ~15: clip_by_global_norm(10) acts
FIELDS = {"cell_velocity": "cell/velocity_gt",
          "cell_pressure": "cell/pressure_gt",
          "face_velocity": "face/velocity_gt",
          "face_pressure": "face/pressure_gt", "face_flux": "face/flux_gt"}


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """checkpoint-12 through the converter: (its directory, the port's
    state tree as read back, the orbax tree, meta)."""
    spec = importlib.util.spec_from_file_location("torch_convert", CONVERTER)
    converter = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(converter)
    out = tmp_path_factory.mktemp("ckpt") / "checkpoint-12"
    _, tree = converter.convert(str(CKPT), str(out))
    state, meta = Checkpointer(str(out.parent)).load(str(out))
    return out, state, tree, meta


def _port(meta, state):
    """The port's FluxD of checkpoint-12's config on the CPU, its weights,
    statistics and optimizer state restored."""
    config = Config.from_dict(meta["config"])
    model = train.build_model(config, "cpu")
    model.set_stats(meta["stats"])
    model.module.load_state_dict(state["module"])
    optimizer = select_optimizer(config, model.module.parameters())
    # a copy: load_state_dict keeps the tensors it is given, and the tests
    # update them in place
    optimizer.load_state_dict(copy.deepcopy(state["optimizer"]))
    return config, model, optimizer


@pytest.fixture(scope="module")
def port(converted):
    """``_port`` of the converted checkpoint, for the tests that only read
    it."""
    _, state, _, meta = converted
    return _port(meta, state)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_converter_carries_the_moments_and_the_step(converted, port):
    """Every parameter's ``exp_avg`` and ``exp_avg_sq`` are optax's ``mu``
    and ``nu`` exactly (all 267 parameters), and its ``step`` is the count,
    52,224, a float32 tensor."""
    _, state, tree, meta = converted
    assert meta["step"] == STEP == state["step"]
    _, model, optimizer = port
    adam = tree["opt_state"][1]["inner_state"][0]
    mu = params_from_flax(backward_compatibility(adam["mu"]))
    nu = params_from_flax(backward_compatibility(adam["nu"]))
    params = list(model.module.named_parameters())
    assert len(params) == len(mu) == len(nu) == len(optimizer.state)
    for name, p in params:
        s = optimizer.state[p]
        assert s["step"].dtype == torch.float32 and s["step"].item() == STEP
        torch.testing.assert_close(s["exp_avg"], mu[name], rtol=0, atol=0)
        torch.testing.assert_close(s["exp_avg_sq"], nu[name], rtol=0, atol=0)
    assert int(np.asarray(adam["count"])) == STEP


def test_one_update_matches_optax(converted):
    """One update from checkpoint-12's state with the same seeded gradient
    (global norm above the clip): optax's chain (the restored state, its
    learning rate set by ``_set_lr``) and the port's ``optimizer_step`` give
    parameters and moments within UPDATE_RTOL of each tensor's largest
    magnitude, and the step 52,225."""
    _, state, tree, meta = converted
    config, model, optimizer = _port(meta, state)
    lr = 7.5e-5
    jcfg = JaxConfig.from_dict(meta["config"])
    opt = jax_trainer.select_optimizer(jcfg)
    params = jax.tree.map(jnp.asarray, tree["params"])
    template = opt.init(params)
    leaves = jax.tree.leaves(tree["opt_state"])
    assert [np.shape(x) for x in leaves] == [
        np.shape(x) for x in jax.tree.leaves(template)]
    opt_state = jax.tree.unflatten(jax.tree.structure(template),
                                   [jnp.asarray(x) for x in leaves])
    rng = np.random.default_rng(0)
    grads = jax.tree.map(
        lambda x: (GRAD_STD * rng.normal(size=np.shape(x))).astype(np.float32),
        tree["params"])
    updates, new_state = opt.update(jax.tree.map(jnp.asarray, grads),
                                    jax_trainer._set_lr(opt_state, lr), params)
    new_params = optax.apply_updates(params, updates)

    named = dict(model.module.named_parameters())
    for name, g in params_from_flax(backward_compatibility(grads)).items():
        named[name].grad = g
    norm = optimizer_step(optimizer, lr, config.training.clip_grad_norm)
    assert norm.item() > config.training.clip_grad_norm

    want_params = params_from_flax(backward_compatibility(
        jax.tree.map(np.asarray, new_params)))
    new_tree = jax.tree.unflatten(jax.tree.structure(tree["opt_state"]),
                                  [np.asarray(x) for x in
                                   jax.tree.leaves(new_state)])
    want = optimizer_state_from_optax(new_tree, optimizer, model.module)
    got = optimizer.state_dict()["state"]
    for i, (name, p) in enumerate(model.module.named_parameters()):
        assert _rel(p.detach(), want_params[name]) <= UPDATE_RTOL, name
        for key in ("exp_avg", "exp_avg_sq"):
            assert _rel(got[i][key], want["state"][i][key]) <= UPDATE_RTOL, (
                name, key)
        assert got[i]["step"].item() == want["state"][i]["step"].item() == (
            STEP + 1)


def test_resume_takes_a_train_step_on_mesh0(converted, capsys):
    """``restore_train_state`` takes the converted tree (the generator from
    ``settings.random_seed``, as it prints), and the restored state takes
    one pushforward train step (epoch 12, past the 6 warm-up epochs) on
    mesh_0 of the rollout data: finite losses, every parameter moved, and
    the optimizer's step 52,225."""
    _, tree, _, meta = converted
    config, model, _ = _port(meta, tree)
    config.training.noise_std = meta["config"]["training"]["noise_std"]
    trainer = Trainer(config, model)
    trainer.epoch_count = meta["epoch"]
    state = restore_train_state(tree, trainer.init_state())
    assert "generator starts from settings.random_seed" in capsys.readouterr().out
    assert state.step == STEP
    with h5py.File(DATA, "r") as f:
        g = f["mesh_0"]
        geom = {k: g["geom"][k][()] for k in g["geom"].keys()}
        fields = {k: g[path][:4] for k, path in FIELDS.items()}
    ds = MeshDataset([Trajectory(mesh_id="mesh_0", geom=geom, fields=fields,
                                 dt=DT)], data_window=4, device="cpu")
    before = {k: v.detach().clone()
              for k, v in state.module.named_parameters()}
    losses = trainer.train_step(state, ds.get_item(0),
                                config.training.lr_min)
    assert all(torch.isfinite(v) for v in losses.values()), losses
    assert state.step == STEP + 1
    for name, p in state.module.named_parameters():
        assert not torch.equal(p.detach(), before[name]), name
        assert state.optimizer.state[p]["step"].item() == STEP + 1


@pytest.mark.parametrize("key", ["b1", "b2", "eps", "eps_root",
                                 "weight_decay"])
def test_a_hyperparameter_mismatch_raises(converted, port, key):
    """optax's state with one hyperparameter other than the port's AdamW
    takes (0.9, 0.999, 1e-8, 0, 1e-4) raises, naming it."""
    tree = converted[2]
    _, model, optimizer = port
    opt_state = copy.deepcopy(tree["opt_state"])
    hyper = opt_state[1]["hyperparams"]
    hyper[key] = np.float32(hyper[key] * 0.5 + 1e-3)
    with pytest.raises(ValueError, match=key):
        optimizer_state_from_optax(opt_state, optimizer, model.module)


def test_adam_against_an_adamw_state_raises(converted):
    """torch's Adam (no weight decay) cannot take optax's AdamW state."""
    _, state, tree, meta = converted
    config = Config.from_dict(meta["config"])
    config.training.optimizer_name = "Adam"
    model = train.build_model(config, "cpu")
    optimizer = select_optimizer(config, model.module.parameters())
    with pytest.raises(ValueError, match="weight_decay"):
        optimizer_state_from_optax(tree["opt_state"], optimizer, model.module)


def test_train_main_resumes_a_converted_checkpoint(converted, tmp_path,
                                                   monkeypatch, capsys):
    """``train.main --resume`` on a copy of the converted checkpoint whose
    config trains on synthetic data (two meshes, 2 windows of 4 each: the
    config's balanced_chunked sampler makes 2 batches of 4, a mesh
    repeated, in an epoch; a mini-epoch a step) up to epoch 13 (a resume
    takes the checkpoint's config where the command's leaves a default, so
    the data is changed in both): the JAX run's counters from
    ``meta.json`` carried on (epoch 12 -> 13, step 52,224 -> 52,226,
    mini-epoch 12 -> 14), the optimizer's step with them, the generator
    seeded as it prints."""
    out, _, _, meta = converted
    monkeypatch.chdir(tmp_path)
    raw = copy.deepcopy(meta["config"])
    raw["dataset"].update(module="synthetic", name="TaylorGreen",
                          stats_fpath=None)
    raw["training"].update(data_sim_limit=2, data_timestep_range=[0, 2],
                           epochs=meta["epoch"] + 1, mini_epoch_size=4)
    raw["rollout"].update(data_sim_limit=2, data_timestep_range=[0, 3],
                          snapshot_indices=[])
    raw["logging"].update(save_frequency=0, valid_frequency=0,
                          use_wandb=False, is_debug=True)
    ckpt = tmp_path / "checkpoint-12"
    shutil.copytree(out, ckpt)
    (ckpt / "meta.json").write_text(json.dumps({**meta, "config": raw}))
    path = tmp_path / "resume.json"
    path.write_text(json.dumps(raw))
    tr, state = train.main(["--config", str(path), "--device", "cpu",
                            "--ckpt-dir", str(tmp_path / "ckpt"),
                            "--resume", str(ckpt)])
    assert "generator starts from settings.random_seed" in capsys.readouterr().out
    assert (tr.epoch_count, tr.step_count, state.step) == (
        meta["epoch"] + 1, STEP + 2, STEP + 2)
    assert tr.mini_epoch_count == meta["mini_epoch"] + 2
    for p in state.module.parameters():
        assert state.optimizer.state[p]["step"].item() == STEP + 2
