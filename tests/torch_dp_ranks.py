"""The rank side of ``tests/test_torch_data_parallel.py``: each function
here runs in a process of its own, started by ``torch.multiprocessing``,
one per rank, on the CPU with gloo and one intra-op thread. It imports
torch and the port only. The test process writes what the ranks need
(``inputs.pt``: trajectories, configs, weights, statistics) into a
directory, and each rank writes what it found there (``<scenario>_rank<r>.pt``)
for the test process to hold against the JAX package.
"""

import copy
import os

import numpy as np
import torch

from gnn_fluid_dynamics_tpu_torch.data import pipeline
from gnn_fluid_dynamics_tpu_torch.models.base import ModelConfig
from gnn_fluid_dynamics_tpu_torch.models.registry import get_model_class
from gnn_fluid_dynamics_tpu_torch.parallel import data_parallel
from gnn_fluid_dynamics_tpu_torch.training import train, trainer

WINDOW = 4


def dataset(trajs):
    """The port's dataset of ``(mesh_id, geom, fields)`` triples, window
    WINDOW, as the test process builds its own."""
    return pipeline.MeshDataset(
        [pipeline.Trajectory(mesh_id=m, geom=g, fields=dict(f))
         for m, g, f in trajs],
        data_window=WINDOW, pad_multiple=32, device="cpu")


def build_model(spec, augment: bool = True):
    """The port's model of ``spec`` (name, blocks, pushforward, dropout,
    loss weights, statistics, state dict) on the CPU; without ``augment``
    its train-mode transform draws no noise and no flip."""
    m = get_model_class(spec["name"])(
        ModelConfig(name=spec["name"], hidden_width=spec["hidden"],
                    mp_num=spec["mp"], aggregation="segment",
                    pushforward=spec.get("pushforward"),
                    dropout_rate=spec.get("dropout", 0.0)),
        device="cpu", loss_weights=spec["loss_weights"])
    m.set_stats(spec["stats"])
    m.module.load_state_dict(spec["state_dict"])
    if not augment:
        tt = m.transform_features
        m.transform_features = (
            lambda g, generator=None, mode="rollout", noise_std=0.0: tt(
                g, None, mode, noise_std))
    return m


def snapshot(state):
    """Copies of the state's module, optimizer, generator and step."""
    return (copy.deepcopy(state.module.state_dict()),
            copy.deepcopy(state.optimizer.state_dict()),
            state.generator.get_state(), state.step)


def restore(state, snap):
    state.module.load_state_dict(snap[0])
    state.optimizer.load_state_dict(copy.deepcopy(snap[1]))
    state.generator.set_state(snap[2])
    state.step = snap[3]


def _flat_state(state):
    return torch.cat([v.reshape(-1).float() for v in
                      state.module.state_dict().values()])


def refusals(inputs, rank):
    """A launch of two ranks refuses a config without ``multi_gpu`` and
    one whose ``num_devices`` is not 2: the messages."""
    spec = inputs["models"]["FvgnD"]
    out = {}
    for key, cfg in inputs["refused"].items():
        try:
            trainer.Trainer(cfg, build_model(spec))
            out[key] = None
        except ValueError as e:
            out[key] = str(e)
    return out


def same_batch(inputs, rank):
    """Both ranks one DP pushforward step on the same batch, no noise or
    flip: the losses and the state after it."""
    ds = dataset(inputs["trajectories"])
    tr = trainer.Trainer(inputs["config"], build_model(
        inputs["models"]["FvgnD"], augment=False))
    tr.epoch_count = 2
    state = tr.init_state()
    losses = tr.dp_train_step(state, ds.get_batch(inputs["batches"][0]),
                              inputs["lr"])
    return {"losses": losses, "state": state.module.state_dict()}


def against_jax(inputs, rank):
    """For each case (model, epoch): two DP steps, rank r on its own
    batches (``batches[r]``, then ``batches[2 + r]``), no noise or flip;
    the mean losses of each step and the state after them, the replicas
    held equal across the ranks."""
    ds = dataset(inputs["trajectories"])
    out = {}
    for case, (name, epoch) in inputs["jax_cases"].items():
        tr = trainer.Trainer(inputs["config"], build_model(
            inputs["models"][name], augment=False))
        tr.epoch_count = epoch
        state = tr.init_state()
        losses = [tr.dp_train_step(state, ds.get_batch(
            inputs["batches"][2 * s + rank]), inputs["lr"]) for s in range(2)]
        data_parallel.assert_replicated(_flat_state(state), case)
        out[case] = {"losses": losses, "state": state.module.state_dict(),
                     "moments": state.optimizer.state_dict()["state"]}
    return out


def two_batches(inputs, rank):
    """Each rank one DP pushforward step of FvgnD on its own batch
    (``batches[rank]``), no noise or flip. Rank 0 then takes the same step
    in its own process from the same state, once from the mean of both
    batches' gradients and BatchNorm statistics (clip and AdamW after it)
    and once from its own batch alone: whether the DP step equals the first
    bit for bit and differs from the second (losses, parameters and
    buffers, AdamW's moments)."""
    ds = dataset(inputs["trajectories"])
    tr = trainer.Trainer(inputs["config"], build_model(
        inputs["models"]["FvgnD"], augment=False))
    tr.epoch_count = 2
    state = tr.init_state()
    snap = snapshot(state)
    graphs = [ds.get_batch(inputs["batches"][r]) for r in range(2)]
    got = (tr.dp_train_step(state, graphs[rank], inputs["lr"]),
           *snapshot(state)[:2])
    if rank != 0:
        return {}

    def step_from(ranks):
        parts = []
        for r in ranks:
            restore(state, snap)
            losses = tr._forward_backward(state, graphs[r])
            parts.append((losses, [g.clone() for g in
                                   trainer.gradients(state.optimizer)],
                          [b.clone() for b in
                           data_parallel.batch_statistics(state.module)]))
        restore(state, snap)
        for t, *xs in zip(trainer.gradients(state.optimizer)
                          + data_parallel.batch_statistics(state.module),
                          *[grads + stats for _, grads, stats in parts]):
            with torch.no_grad():
                t.copy_(sum(xs) / len(xs))
        trainer.optimizer_step(state.optimizer, inputs["lr"],
                               inputs["config"].training.clip_grad_norm)
        losses = {k: sum(p[0][k].float() for p in parts) / len(parts)
                  for k in parts[0][0]}
        return (losses, *snapshot(state)[:2])

    def equal(a, b):
        (la, ma, oa), (lb, mb, ob) = a, b
        return {"losses": all(torch.equal(la[k], lb[k]) for k in lb),
                "state": all(torch.equal(ma[k], mb[k]) for k in mb),
                "moments": all(torch.equal(oa["state"][i][k], v)
                               for i, st in ob["state"].items()
                               for k, v in st.items())}
    return {"mean": equal(got, step_from((0, 1))),
            "rank0_alone": equal(got, step_from((0,)))}


def indexed(inputs, rank):
    """From one state (after a first step), ``dp_train_step_indexed`` of
    k = 3 pushforward steps on this rank's own mesh (its own store and
    start steps) against 3 ``dp_train_step``s on the same batches, noise,
    flip and dropout on: whether losses, parameters, moments, generator
    and step are equal, bit for bit."""
    ds = dataset(inputs["trajectories"])
    spec = dict(inputs["models"]["FvgnD"], dropout=0.1)
    tr = trainer.Trainer(inputs["noisy_config"], build_model(spec))
    tr.epoch_count = 2
    state = tr.init_state()
    mesh = inputs["trajectories"][rank][0]
    ts = np.asarray([[1], [4], [2]], np.int32)
    lrs = [1e-4, 5e-5, 2.5e-5]
    tr.dp_train_step(state, ds.get_batch([(mesh, 0)]), 1e-4)
    snap = snapshot(state)
    single = trainer._stack([tr.dp_train_step(
        state, ds.get_batch([(mesh, int(t))]), lr) for t, lr in
        zip(ts[:, 0], lrs)])
    after = snapshot(state)
    restore(state, snap)
    fused = tr.dp_train_step_indexed(state, ds._batched_static((mesh,)),
                                     ds.device_fields((mesh,)), ts, lrs,
                                     WINDOW)
    moments = [(v, state.optimizer.state_dict()["state"][i][k])
               for i, st in after[1]["state"].items() for k, v in st.items()]
    return {
        "losses": all(torch.equal(fused[k], single[k]) for k in single),
        "parameters": all(torch.equal(v, state.module.state_dict()[k])
                          for k, v in after[0].items()),
        "moments": all(torch.equal(a, b) for a, b in moments),
        "generator": torch.equal(after[2], state.generator.get_state()),
        "step": state.step == after[3] == snap[3] + 3,
        "moved": not torch.equal(after[2], snap[2]),
    }


class Recorder:
    """A logger that keeps what the trainer logs."""

    def __init__(self):
        self.rows = []

    def save_loss(self, values, step, prefix):
        self.rows.append((prefix, step, dict(values)))

    def save_scalar(self, value, step, prefix):
        self.rows.append((prefix, step, float(value)))


class Saves:
    """A checkpointer that counts its saves."""

    def __init__(self):
        self.saved = 0

    def save(self, *args, **kw):
        self.saved += 1


def run(inputs, rank):
    """``Trainer.run`` with ``multi_gpu`` on two ranks (global batch 2, one
    sample a rank; 2 epochs, the first the pushforward warm-up), each rank
    given a recording logger, a monitor and a counting checkpointer: the
    counters, each epoch's global batches (this rank's sampler's and the
    broadcast ones) and this rank's share of them, what each rank logged
    and saved, and its state."""
    from gnn_fluid_dynamics_tpu_torch.training.monitoring import ModelMonitor
    ds = dataset(inputs["trajectories"])
    tr = trainer.Trainer(inputs["run_config"], build_model(
        inputs["models"]["FvgnD"], augment=False), logger=Recorder(),
        checkpointer=Saves(), monitor=ModelMonitor())
    calls, epochs = [], []
    step, slices, share = tr.dp_train_step, tr._dp_batches, \
        data_parallel.broadcast_object
    tr.dp_train_step = lambda s, g, lr: calls.append(g.num_graphs) or step(
        s, g, lr)
    tr._dp_batches = lambda *a: epochs.append({"own": slices(*a)}) or \
        epochs[-1]["own"]

    def shared(obj):
        out = share(obj)
        epochs.append({"sampled": obj, "shared": out})
        return out

    data_parallel.broadcast_object = shared
    try:
        state = tr.run(tr.init_state(), ds)
    finally:
        data_parallel.broadcast_object = share
    return {"counters": (tr.epoch_count, tr.mini_epoch_count, tr.step_count,
                         tr.sample_count, state.step),
            "epochs": epochs,
            "path": tr.train_path(ds), "graphs_per_step": calls,
            "rows": tr.logger.rows, "saved": tr.checkpointer.saved,
            "state": state.module.state_dict()}


def unreached(inputs, rank):
    """ConservativeA, one DP step of both ranks on the same batch at the
    decay's learning rate, no noise or flip: its state after it."""
    ds = dataset(inputs["trajectories"])
    tr = trainer.Trainer(inputs["config"], build_model(
        inputs["models"]["ConservativeA"], augment=False))
    state = tr.init_state()
    tr.dp_train_step(state, ds.get_batch(inputs["batches"][0]),
                     inputs["decay_lr"])
    return {"state": state.module.state_dict()}


def train_main(inputs, rank, workdir):
    """``train.main`` under a two-rank launch (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``; the rendezvous a file store), then ``--resume latest``
    for one more epoch: the counters, the validations each rank ran, the
    state and the generator's state after each."""
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank))
    validations = []
    validate = trainer.Trainer.validate

    def counted(self, *args, **kw):
        validations.append(self.mini_epoch_count)
        return validate(self, *args, **kw)

    trainer.Trainer.validate = counted
    out = {}
    for run_name, cfg in (("first", "main.json"), ("resumed", "resume.json")):
        argv = ["--config", os.path.join(workdir, cfg), "--device", "cpu",
                "--ckpt-dir", os.path.join(workdir, "ckpt"), "--dist-init",
                "file://" + os.path.join(workdir, f"store_{run_name}")]
        if run_name == "resumed":
            argv += ["--resume", "latest"]
        validations.clear()
        tr, state = train.main(argv)
        out[run_name] = {
            "counters": (tr.epoch_count, tr.mini_epoch_count, tr.step_count,
                         tr.sample_count, state.step),
            "validations": list(validations),
            "duties": (tr.logger is not None, tr.monitor is not None,
                       tr.checkpointer is not None),
            "state": state.module.state_dict(),
            "generator": state.generator.get_state()}
    return out


SCENARIOS = (refusals, same_batch, two_batches, against_jax, indexed, run,
             unreached)


def rank_main(rank: int, world: int, workdir: str) -> None:
    """One rank: every scenario of SCENARIOS under a gloo group of ``world``
    ranks, then ``train.main``'s launch, each result saved beside the
    inputs."""
    torch.set_num_threads(1)
    os.chdir(workdir)
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    data_parallel.init_process_group(
        "cpu", init_method="file://" + os.path.join(workdir, "store"),
        rank=rank, world_size=world)
    try:
        for scenario in SCENARIOS:
            torch.save(scenario(inputs, rank), os.path.join(
                workdir, f"{scenario.__name__}_rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()
    torch.save(train_main(inputs, rank, workdir),
               os.path.join(workdir, f"train_main_rank{rank}.pt"))
