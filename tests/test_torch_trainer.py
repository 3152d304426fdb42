"""The port's training runtime against the JAX package's: the optimizers with
clipping, the learning-rate schedules, the samplers, the pushforward
retarget and its warmup window; and the port's trainer loop end to end on
the CPU (``train.main`` on ``config/train_synthetic.json``), its checkpoints
and resume, and its refusal to run without a card unless asked.

Tolerances: the optimizers' parameters within 1e-6 after three steps (f32,
the same update up to rounding); schedules and samplers exactly (the same
Python and numpy code on the same numbers); the pushforward features within
1e-5 relative (two f32 rollout steps, as in the FvgnF rollout tests).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnn_fluid_dynamics_tpu.data import samplers as jax_samplers
from gnn_fluid_dynamics_tpu.data.pipeline import MeshDataset as JaxDataset
from gnn_fluid_dynamics_tpu.data.pipeline import Trajectory as JaxTrajectory
from gnn_fluid_dynamics_tpu.data.pipeline import \
    train_batches as jax_train_batches
from gnn_fluid_dynamics_tpu.data.synthetic import (make_geometry,
                                                   taylor_green_trajectory)
from gnn_fluid_dynamics_tpu.models import get_model_class as jax_model_class
from gnn_fluid_dynamics_tpu.models.base import ModelConfig as JaxModelConfig
from gnn_fluid_dynamics_tpu.models.base import feature_masks as jax_masks
from gnn_fluid_dynamics_tpu.models.normalizer import \
    StatsAccumulator as JaxStatsAccumulator
from gnn_fluid_dynamics_tpu.training import lr_schedule as jax_lr
from gnn_fluid_dynamics_tpu.training import trainer as jax_trainer
from gnn_fluid_dynamics_tpu.training.config import Config as JaxConfig

from gnn_fluid_dynamics_tpu_torch.data import samplers
from gnn_fluid_dynamics_tpu_torch.data.pipeline import (MeshDataset,
                                                        Trajectory,
                                                        train_batches)
from gnn_fluid_dynamics_tpu_torch.models.base import ModelConfig
from gnn_fluid_dynamics_tpu_torch.models.registry import get_model_class
from gnn_fluid_dynamics_tpu_torch.training import lr_schedule, train, trainer
from gnn_fluid_dynamics_tpu_torch.training.checkpoint import Checkpointer
from gnn_fluid_dynamics_tpu_torch.training.config import Config, load_config
from gnn_fluid_dynamics_tpu_torch.weights import params_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTHETIC = os.path.join(ROOT, "config", "train_synthetic.json")


# ---- optimizers ----------------------------------------------------------------

def _optimizer_runs(name, clip):
    """Three steps of the JAX package's ``select_optimizer`` (optax, with
    the learning rate injected per step) and of the port's
    ``select_optimizer`` + ``optimizer_step`` on the same parameters and
    gradients; the second step's gradients are scaled so that their global
    norm is far above ``clip``."""
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * s).astype(np.float32)
              for k, v in params.items()} for s in (0.5, 40.0, 2.0)]
    lrs = (1e-2, 5e-3, 2e-3)

    jcfg, tcfg = JaxConfig(), Config()
    for c in (jcfg, tcfg):
        c.training.optimizer_name = name
        c.training.clip_grad_norm = clip
    opt = jax_trainer.select_optimizer(jcfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    for g, lr in zip(grads, lrs):
        state = jax_trainer._set_lr(state, lr)
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state, jp)
        jp = optax.apply_updates(jp, upd)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    topt = trainer.select_optimizer(tcfg, list(tp.values()))
    norms = []
    for g, lr in zip(grads, lrs):
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        norms.append(float(trainer.optimizer_step(topt, lr, clip)))
    return jp, tp, norms


def test_adamw_with_clipping_matches_optax():
    """``optax.chain(clip_by_global_norm(10), adamw)`` (weight decay 1e-4):
    one of the three steps is clipped, and the parameters agree within
    1e-6."""
    jp, tp, norms = _optimizer_runs("AdamW", 10.0)
    assert sum(n > 10.0 for n in norms) == 1, norms
    for k in jp:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6)


def test_adam_without_clipping_matches_optax():
    jp, tp, _ = _optimizer_runs("Adam", None)
    for k in jp:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6)


def test_clip_by_global_norm_scales_as_optax():
    """Scaled by max_norm / max(norm, max_norm): unchanged below the norm,
    to the norm exactly (to f32 rounding) above it."""
    small = [torch.full((3,), 0.1), torch.full((2,), 0.2)]
    before = [g.clone() for g in small]
    trainer.clip_by_global_norm_(small, 10.0)
    for a, b in zip(small, before):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    big = [torch.full((3,), 30.0), torch.full((4,), 40.0)]
    norm = trainer.clip_by_global_norm_(big, 10.0)
    np.testing.assert_allclose(norm.item(), np.sqrt(3 * 900 + 4 * 1600),
                               rtol=1e-6)
    np.testing.assert_allclose(
        torch.nn.utils.get_total_norm(big).item(), 10.0, rtol=1e-6)


# ---- schedules and samplers ----------------------------------------------------

class _Sched:
    lr_max = 1e-3
    lr_min = 1e-6
    lr_wu = 0.1
    lr_wu_gamma = 0.04
    lr_ms1 = 0.3
    lr_ms1_gamma = 0.5
    lr_ms2 = 0.6
    lr_ms2_gamma = 0.1
    lr_ms3 = 0.98


@pytest.mark.parametrize("name", sorted(jax_lr.SCHEDULES))
def test_schedule_matches_jax(name):
    """Every mini-epoch of a 40-mini-epoch run, and past its end."""
    assert sorted(lr_schedule.SCHEDULES) == sorted(jax_lr.SCHEDULES)
    want = jax_lr.get_schedule(name, _Sched, 40)
    got = lr_schedule.get_schedule(name, _Sched, 40)
    assert [got(t) for t in range(45)] == [want(t) for t in range(45)]


def _trajectories(kind):
    """Five small meshes of two sizes, trajectories of 6 to 9 steps."""
    out = []
    for i in range(5):
        geom = make_geometry("structured", nx=4 + i % 2, ny=3)
        fields = taylor_green_trajectory(geom, num_timesteps=6 + i % 4,
                                         dt=0.01)
        out.append(kind(mesh_id=f"m{i}", geom=geom, fields=dict(fields)))
    return out


@pytest.fixture(scope="module")
def datasets():
    return (JaxDataset(_trajectories(JaxTrajectory), pad_multiple=32),
            MeshDataset(_trajectories(Trajectory), pad_multiple=32,
                        device="cpu"))


@pytest.mark.parametrize("name", sorted(jax_samplers.SAMPLERS) + [
    "train_batches", "rollout_order"])
def test_sampler_matches_jax(datasets, name):
    """The same batches in the same order for the same
    ``np.random.default_rng`` seed, over two epochs drawn from one
    generator (so each draws as many numbers as the JAX sampler)."""
    jds, tds = datasets
    assert tds.sample_map == jds.sample_map
    if name == "rollout_order":
        assert samplers.rollout_order(tds) == jax_samplers.rollout_order(jds)
        return
    if name == "train_batches":
        jfn, tfn = jax_train_batches, train_batches
    else:
        jfn, tfn = jax_samplers.get_sampler(name), samplers.get_sampler(name)
    rj, rt = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(2):
        want = [list(b) for b in jfn(jds, 2, rj)]
        got = [list(b) for b in tfn(tds, 2, rt)]
        assert got == want and len(got) > 0


# ---- pushforward ---------------------------------------------------------------

def _pushforward_models():
    """FvgnA with ``pushforward=True`` on a window-4 graph (pushforward
    factor 2), hidden 16, one block, statistics from the graph; the JAX
    model's variables carried over."""
    geom = make_geometry("structured", nx=6, ny=4)
    fields = taylor_green_trajectory(geom, num_timesteps=8, dt=0.01)
    jds = JaxDataset([JaxTrajectory(mesh_id="m", geom=geom,
                                    fields=dict(fields))],
                     stride=1, data_window=4, pad_multiple=32)
    tds = MeshDataset([Trajectory(mesh_id="m", geom=geom,
                                  fields=dict(fields))],
                      stride=1, data_window=4, pad_multiple=32, device="cpu")
    gj, gt = jds.get_batch(jds.sample_map[:1]), tds.get_batch(tds.sample_map[:1])
    jm = jax_model_class("FvgnA")(JaxModelConfig(
        hidden_width=16, mp_num=1, pushforward=True))
    _, feats = jm.transform_features(gj, None, mode="rollout")
    acc = JaxStatsAccumulator(jm.nmap)
    acc.update(feats, jax_masks(gj, feats))
    stats = acc.finalize()
    jm.set_stats(stats)
    variables = jm.init(jax.random.PRNGKey(0), gj, feats)
    tm = get_model_class("FvgnA")(
        ModelConfig(name="FvgnA", hidden_width=16, mp_num=1,
                    aggregation="segment", pushforward=True), device="cpu")
    tm.set_stats(stats)
    tm.module.load_state_dict(params_from_flax(variables))
    return jm, variables, gj, tm, gt


def test_pushforward_retarget_matches_jax():
    """Two no-grad rollout steps from the window's start, then cell_y
    retargeted at the window's final state: cell_x, cell_y and face_x
    within 1e-5 relative of the JAX package's; the unroll moves the state
    and cell_y is v_final minus the pushed state."""
    jm, variables, gj, tm, gt = _pushforward_models()
    assert tm.pushforward_use
    _, fj = jm.transform_features(gj, None, mode="train")
    _, ft = tm.transform_features(gt, None, mode="train")
    torch.testing.assert_close(
        ft["cell_y"], gt.cell_velocity[:, -1] - gt.cell_velocity[:, -2],
        rtol=0, atol=0)
    fj2 = jax_trainer.pushforward_retarget(jm, variables, gj, dict(fj), 2)
    ft2 = trainer.pushforward_retarget(tm, gt, dict(ft), 2)
    for k in ("cell_x", "cell_y", "face_x"):
        want = np.asarray(fj2[k])
        got = ft2[k].numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), k
    assert float((ft2["cell_x"] - ft["cell_x"]).abs().max()) > 0
    torch.testing.assert_close(
        ft2["cell_y"], gt.cell_velocity[:, -1, 0:2] - ft2["cell_x"][:, 0:2],
        rtol=0, atol=0)


def test_warmup_window_matches_jax():
    """The window's last two steps of every time-windowed field, the rest of
    the graph untouched, a two-step window passed through as it is."""
    _, _, gj, _, gt = _pushforward_models()
    wj, wt = jax_trainer.warmup_window(gj), trainer.warmup_window(gt)
    for k in trainer._WINDOW_FIELDS:
        assert getattr(wt, k).shape[1] == 2
        np.testing.assert_array_equal(getattr(wt, k).numpy(),
                                      np.asarray(getattr(wj, k)))
    assert wt.cell_pos is gt.cell_pos
    assert trainer.warmup_window(wt) is wt


# ---- the trainer loop on the CPU ----------------------------------------------

def _config_file(tmp_path, name):
    """``config/train_synthetic.json`` with the model ``name``."""
    with open(SYNTHETIC) as f:
        raw = json.load(f)
    raw["model"]["name"] = name
    raw["logging"]["name"] = f"{name}-tg"
    raw["rollout"]["snapshot_indices"] = [1, 3]
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(raw))
    return str(path)


def _train_losses(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r["train/total_log_loss"] for r in rows
            if "train/total_log_loss" in r]


@pytest.mark.parametrize("name", ["FvgnA", "FluxD"])
def test_trainer_runs_checkpoints_and_resumes(tmp_path, monkeypatch, name):
    """``train.main`` on the synthetic config (2 epochs of 20 steps, a
    mini-epoch of 4, validation and a checkpoint every 2 mini-epochs) on
    the CPU: the loss falls from the first mini-epoch to the last, the
    checkpoints written are kept as latest and best say, every validation
    writes its snapshots, and ``--resume latest`` restores a state whose next two steps on one batch give the
    uninterrupted run's losses bit for bit (weights, optimizer moments and
    the generator's noise and flips all restored)."""
    monkeypatch.chdir(tmp_path)
    cfg = _config_file(tmp_path, name)
    ckpt = str(tmp_path / "ckpt")
    tr, state = train.main(["--config", cfg, "--device", "cpu",
                            "--ckpt-dir", ckpt])
    assert (tr.epoch_count, tr.mini_epoch_count, tr.step_count) == (2, 10, 40)
    assert state.step == 40

    run_dirs = [os.path.join(dp, d) for dp, ds, _ in os.walk("runs")
                for d in ds if d.startswith(f"{name}-tg(")]
    assert len(run_dirs) == 1
    mini = _train_losses(run_dirs[0])
    assert len(mini) == 10 and np.isfinite(mini).all()
    assert mini[-1] < mini[0], mini
    snaps = sorted(os.listdir(os.path.join(run_dirs[0], "snapshots")))
    assert snaps == sorted(f"step{me}_t{t}.npz" for me in (0, 2, 4, 6, 8, 10)
                           for t in (1, 3))
    snap = np.load(os.path.join(run_dirs[0], "snapshots", "step10_t3.npz"))
    assert snap["mesh_0/field_data"].shape[1] == 2

    ck = Checkpointer(ckpt)
    latest, best = ck.resolve("latest"), ck.resolve("best")
    assert latest.endswith("checkpoint-10") and best is not None
    kept = sorted(e for e in os.listdir(ckpt) if e.startswith("checkpoint-"))
    assert kept == sorted({os.path.basename(latest), os.path.basename(best)})
    tree, meta = ck.load("latest")
    assert set(meta) == {"epoch", "mini_epoch", "step", "sample_count",
                         "config", "train_losses", "valid_losses", "stats"}
    assert meta["mini_epoch"] == 10 and tree["step"] == 40

    tr2, state2 = train.main(["--config", cfg, "--device", "cpu",
                              "--ckpt-dir", ckpt, "--resume", "latest"])
    assert (tr2.epoch_count, tr2.step_count, state2.step) == (2, 40, 40)
    batch = train.build_datasets(load_config(cfg), type(tr.model),
                                 splits=("train",), device="cpu")[0]
    graph = batch.get_batch(batch.sample_map[:2])
    for lr in (1e-3, 5e-4):
        a = tr.train_step(state, graph, lr)["total_log_loss"].item()
        b = tr2.train_step(state2, graph, lr)["total_log_loss"].item()
        assert a == b


def test_epoch_limit_saves_the_tail_and_exits_resumable(tmp_path, monkeypatch):
    """``GFD_EPOCH_LIMIT=1`` stops after the first of two epochs, saves the
    tail as a checkpoint and exits with 3; the resumed run trains the
    second epoch and ends where the uninterrupted one does."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("GFD_EPOCH_LIMIT", "1")
    cfg = _config_file(tmp_path, "FvgnA")
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(SystemExit) as exc:
        train.main(["--config", cfg, "--device", "cpu", "--ckpt-dir", ckpt])
    assert exc.value.code == 3
    assert Checkpointer(ckpt).load("latest")[1]["epoch"] == 1
    tr, state = train.main(["--config", cfg, "--device", "cpu",
                            "--ckpt-dir", ckpt, "--resume", "latest"])
    assert (tr.epoch_count, tr.step_count, state.step) == (2, 40, 40)


def test_warm_start_takes_a_checkpoints_weights(tmp_path, monkeypatch):
    """``model.fpath`` pointing at a checkpoint of this package: its weights
    are taken and, without ``warm_start_reset``, its counters too."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("GFD_EPOCH_LIMIT", "1")
    cfg = _config_file(tmp_path, "FvgnA")
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(SystemExit):
        train.main(["--config", cfg, "--device", "cpu", "--ckpt-dir", ckpt])
    tree, meta = Checkpointer(ckpt).load("latest")
    with open(cfg) as f:
        raw = json.load(f)
    raw["model"]["fpath"] = os.path.join(ckpt, "latest")
    raw["training"]["epochs"] = 1
    warm = tmp_path / "warm.json"
    warm.write_text(json.dumps(raw))
    monkeypatch.delenv("GFD_EPOCH_LIMIT")
    tr, state = train.main(["--config", str(warm), "--device", "cpu",
                            "--ckpt-dir", str(tmp_path / "ckpt2")])
    assert tr.step_count == meta["step"] == 20
    for k, v in state.module.state_dict().items():
        torch.testing.assert_close(v, tree["module"][k], rtol=0, atol=0)


def test_train_main_needs_a_card_unless_asked_for_the_cpu(tmp_path,
                                                         monkeypatch):
    """No ``--device``: the card, which is absent here, so it raises before
    any work instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--config", SYNTHETIC])
    assert not os.path.exists(tmp_path / "runs")


def test_unported_training_options_raise(tmp_path):
    cfg = load_config(SYNTHETIC)
    model = train.build_model(cfg, "cpu")
    cfg.training.steps_per_call = 4
    with pytest.raises(NotImplementedError, match="item 3"):
        trainer.Trainer(cfg, model)
    cfg = load_config(SYNTHETIC)
    cfg.dataset.module = "openfoam"
    cfg.dataset.lazy = True
    with pytest.raises(NotImplementedError, match="item 4"):
        train.build_datasets(cfg, type(model), device="cpu")
