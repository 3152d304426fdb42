"""The port's Conservative family in training, against the JAX package's
(the other half of ``tests/test_torch_conservative.py``, split from it so
that each file takes about half the time):

* Each of the ten through ``train.main`` (one epoch of the synthetic
  config): finite losses, every parameter moved (AdamW's weight decay
  moves the last block's cell MLP of A, D and E, which no output reads, as
  optax's does: 1e-6 against optax over three steps).
"""

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_conservative import ROOT, VARIANTS

from gnn_fluid_dynamics_tpu_torch.models.base import ModelConfig
from gnn_fluid_dynamics_tpu_torch.models.registry import get_model_class
from gnn_fluid_dynamics_tpu_torch.training import train as train_cli
from gnn_fluid_dynamics_tpu_torch.training.checkpoint import Checkpointer


@pytest.mark.parametrize("name", VARIANTS)
def test_trainer_run_trains_each_variant(tmp_path, monkeypatch, name):
    """``train.main`` on ``config/train_synthetic.json`` cut to one epoch
    (noise, the edge flip, each variant's loss, validation and a
    checkpoint): finite train and validation losses, and every parameter
    moved from its seeded value."""
    monkeypatch.chdir(tmp_path)
    with open(ROOT / "config" / "train_synthetic.json") as f:
        raw = json.load(f)
    raw["model"]["name"] = name
    raw["logging"]["name"] = f"{name}-tg"
    raw["training"].update(epochs=1, data_timestep_range=[0, 8],
                           mini_epoch_size=4)
    raw["rollout"]["data_timestep_range"] = [0, 4]
    cfg = tmp_path / f"{name}.json"
    cfg.write_text(json.dumps(raw))
    init = get_model_class(name)(ModelConfig(
        name=name, hidden_width=raw["model"]["hidden_width"],
        mp_num=raw["model"]["mp_num"]), device="cpu",
        seed=raw["settings"]["random_seed"]).module.state_dict()
    tr, state = train_cli.main(["--config", str(cfg), "--device", "cpu",
                                "--ckpt-dir", str(tmp_path / "ckpt")])
    assert state.step > 0
    run_dir = next(os.path.join(dp, d) for dp, ds, _ in os.walk("runs")
                   for d in ds if d.startswith(f"{name}-tg("))
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train_losses = [r["train/total_log_loss"] for r in rows
                    if "train/total_log_loss" in r]
    valid = [v for r in rows for k, v in r.items() if k.startswith("valid/")]
    assert train_losses and np.isfinite(train_losses).all()
    assert valid and np.isfinite(valid).all()
    trained = state.module.state_dict()
    assert sorted(trained) == sorted(init)
    still = [k for k, v in trained.items() if "running_" not in k
             and torch.equal(v, init[k])]
    # A, D and E's heads read the edge latents only, so the last block's
    # cell MLP reaches no output: weight decay moves its weights, and its
    # zero-initialized biases stay 0 (as in optax)
    last = f"blocks.{raw['model']['mp_num'] - 1}.cell_mlp."
    dead = ([k for k in init if k.startswith(last) and k.endswith("bias")]
            if name in ("ConservativeA", "ConservativeD", "ConservativeE")
            else [])
    assert sorted(still) == sorted(dead)
    assert all(not init[k].any() for k in dead)
    assert Checkpointer(str(tmp_path / "ckpt")).resolve("latest") is not None


def test_adamw_decays_a_parameter_the_loss_does_not_reach():
    """ConservativeA's last cell MLP reaches no output, so its gradient is
    None in the port and 0 in the JAX package; optax's AdamW still decays
    it, and so must the port's update: three steps of
    ``optimizer_step`` against optax's ``adamw`` on zero gradients
    (clipping at 10, the live parameter's gradients beside it)."""
    import optax
    from gnn_fluid_dynamics_tpu.training import trainer as jax_trainer
    from gnn_fluid_dynamics_tpu.training.config import Config as JaxConfig

    from gnn_fluid_dynamics_tpu_torch.training import trainer
    from gnn_fluid_dynamics_tpu_torch.training.config import Config
    rng = np.random.default_rng(0)
    params = {"live": rng.normal(size=(4, 3)).astype(np.float32),
              "dead": rng.normal(size=(5,)).astype(np.float32)}
    grads = [rng.normal(size=(4, 3)).astype(np.float32) * s
             for s in (0.5, 40.0, 2.0)]
    jcfg, tcfg = JaxConfig(), Config()
    for c in (jcfg, tcfg):
        c.training.optimizer_name, c.training.clip_grad_norm = "AdamW", 10.0
    opt = jax_trainer.select_optimizer(jcfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    topt = trainer.select_optimizer(tcfg, list(tp.values()))
    for g, lr in zip(grads, (1e-2, 5e-3, 2e-3)):
        state = jax_trainer._set_lr(state, lr)
        upd, state = opt.update({"live": jnp.asarray(g),
                                 "dead": jnp.zeros(5, jnp.float32)}, state, jp)
        jp = optax.apply_updates(jp, upd)
        topt.zero_grad(set_to_none=True)
        tp["live"].grad = torch.from_numpy(g.copy())
        trainer.optimizer_step(topt, lr, 10.0)
    for k in jp:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    assert not np.array_equal(tp["dead"].detach().numpy(), params["dead"])
