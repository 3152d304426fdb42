"""Training runtime (counterpart of ``gnn_fluid_dynamics_tpu/training/
trainer.py``): the train state, the train step, the mini-epoch loop,
validation and the checkpoint cadence.

The JAX package jits its step (transform -> forward -> loss -> grad -> clip ->
update) and on the TPU fuses several into one call (``steps_per_call``: the
scan-fused ``multi`` and ``indexed`` steps) to amortize the per-call
dispatch. Here a step is eager PyTorch: autograd for the gradient,
``torch.optim`` for the update, and one explicit ``torch.Generator`` on the
model's device for the noise, the edge flip and dropout, where the JAX
package splits its key three ways. The fused calls (``train_step_multi``,
``train_step_indexed``) take the same inputs as the JAX package's and run
their ``k`` steps one after another, each exactly :meth:`Trainer.train_step`
with its own AdamW update, so that they draw from the generator in the order
``k`` single steps do and equal them bit for bit; the indexed call gathers
each step's window on the device from the trajectory store.

The train step takes the plain route: ``arch.kernel_route(..., train=True)``
refuses the kernels, which have no backward, as the JAX package's
``_resolve_aggregation`` downgrades ``"pallas"`` under ``train``. So it
launches none of the kernels of :mod:`gnn_fluid_dynamics_tpu_torch.ops.kernels`;
validation, a rollout in eval mode, does (K6 and K7 on the validation
graph's tables). The no-grad unroll of pushforward training is a rollout-mode
forward, so it takes whatever route the model's aggregation gives a rollout.

Data parallelism (``settings.multi_gpu`` under a launch of more than one
rank): one process per card, :mod:`gnn_fluid_dynamics_tpu_torch.parallel.
data_parallel`; :meth:`Trainer.dp_train_step` is the single step with the
means over the ranks of the gradients, losses and BatchNorm statistics in it,
before the clip. Rank 0 alone validates, logs, monitors and checkpoints; the
other ranks wait for it at a barrier.

A ``monitor`` (:class:`~gnn_fluid_dynamics_tpu_torch.training.monitoring.
ModelMonitor`, built by ``train.main`` where the JAX package builds one)
logs the decoder's gradient norms, its update and the scalar parameters at
each mini-epoch boundary, from the last step's gradients before the clip; as
in the JAX package, the data-parallel path keeps no gradients for it, so
there it logs the update and the parameters alone.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from gnn_fluid_dynamics_tpu_torch.data.pipeline import (MeshDataset, prefetch,
                                                        prefetch_grouped,
                                                        prefetch_indexed)
from gnn_fluid_dynamics_tpu_torch.data.samplers import get_sampler
from gnn_fluid_dynamics_tpu_torch.parallel import data_parallel, halo
from gnn_fluid_dynamics_tpu_torch.rollout.engine import error_summary
from gnn_fluid_dynamics_tpu_torch.training.config import Config
from gnn_fluid_dynamics_tpu_torch.training.lr_schedule import get_schedule
from gnn_fluid_dynamics_tpu_torch.training.validate import (flat_summary,
                                                            validation_rollout)


@dataclasses.dataclass
class TrainState:
    module: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int                       # optimizer steps taken
    generator: torch.Generator      # on the module's device


def _f32(x: float) -> float:
    return float(np.float32(x))


def select_optimizer(cfg: Config, params) -> torch.optim.Optimizer:
    """Adam or AdamW by name (reference ``select_optimizer``,
    train.py:70-95), with optax's defaults: betas (0.9, 0.999), eps 1e-8,
    and for AdamW a weight decay of 1e-4 on every parameter (torch's default
    is 1e-2). Each is rounded to f32, as the JAX package's
    ``inject_hyperparams`` holds it: 1 - b2 is then 0.99998713e-3, not
    1e-3, which a resumed second moment, a sum over tens of thousands of
    steps, shows. Clipping is :func:`clip_by_global_norm_`."""
    t = cfg.training
    kw = dict(lr=t.lr_max, betas=(_f32(0.9), _f32(0.999)), eps=_f32(1e-8))
    if t.optimizer_name == "Adam":
        return torch.optim.Adam(params, **kw)
    if t.optimizer_name == "AdamW":
        return torch.optim.AdamW(params, weight_decay=_f32(1e-4), **kw)
    raise ValueError(f"Optimizer {t.optimizer_name} not recognised")


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm``: every gradient scaled by
    ``max_norm / max(norm, max_norm)``, with ``norm`` the global L2 norm of
    all of them (``clip_grad_norm_`` adds 1e-6 to it). In place, with no
    host sync; returns the norm before clipping."""
    norm = torch.nn.utils.get_total_norm(grads)
    torch._foreach_mul_(grads, max_norm / torch.clamp(norm, min=max_norm))
    return norm


def gradients(optimizer: torch.optim.Optimizer) -> list:
    """The ``.grad`` of every parameter the optimizer updates, a zero one
    given first to a parameter the loss does not reach.

    optax updates every parameter, and one the loss does not reach (as the
    last block's cell MLP of ConservativeA, D and E, whose heads read the
    edge latents only) has a zero gradient there, so AdamW's weight decay
    still shrinks it. ``torch.optim`` skips a parameter whose ``.grad`` is
    None."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None and p.requires_grad:
                p.grad = torch.zeros_like(p)
    return [p.grad for group in optimizer.param_groups
            for p in group["params"]]


def optimizer_step(optimizer: torch.optim.Optimizer, lr: float,
                   clip_norm: Optional[float]) -> torch.Tensor:
    """The update from the parameters' ``.grad`` (:func:`gradients`):
    clipped to the global norm ``clip_norm`` when given, then the
    optimizer's step at learning rate ``lr`` (the JAX package's ``_set_lr``
    + ``optimizer.update``). Returns the gradients' global norm before
    clipping."""
    grads = gradients(optimizer)
    if clip_norm:
        norm = clip_by_global_norm_(grads, clip_norm)
    else:
        norm = torch.nn.utils.get_total_norm(grads)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    return norm


def pushforward_retarget(model, tgraph, feats: Dict, pf: int) -> Dict:
    """Pushforward trick (reference train.py:247-252): unroll ``pf``
    rollout steps without gradient from the current state, feed the pushed
    state back as the input features, and retarget ``cell_y`` at the
    window's final state, read from the trajectory (the JAX package's
    ``pushforward_retarget``)."""
    v_final = tgraph.cell_velocity[:, -1, 0:2]
    with torch.no_grad():
        for _ in range(pf):
            outputs = model.forward(tgraph, feats, mode="rollout")
            sol = halo.refresh_state(
                model.derive_state(outputs, feats, tgraph), tgraph)
            feats = model.update_features(sol, feats, tgraph)
    feats = dict(feats)
    feats["cell_y"] = torch.cat([v_final - feats["cell_x"][:, 0:2],
                                 feats["cell_y"][:, 2:]], dim=1)
    return feats


_WINDOW_FIELDS = ("cell_velocity", "cell_pressure", "face_velocity",
                  "face_pressure", "face_flux")


# the indexed path is taken, unless ``training.device_fields`` says, when
# the whole dataset's trajectories fit this many bytes on the device (the
# JAX package's rule; it decides which path a config takes)
DEVICE_FIELD_BUDGET = 4e9


def gather_windows(dev_fields: Dict[str, torch.Tensor], ts_b: torch.Tensor,
                   window: int) -> Dict[str, torch.Tensor]:
    """Each trajectory's ``window`` states from its start step: the store
    ``{key: (T, B*Npad, D)}`` and ``(B,)`` start steps on its device give
    ``{key: (B*Npad, window, D)}``, laid out as ``MeshDataset.get_batch``
    lays a batch (the JAX package's ``gather_windows``)."""
    B = ts_b.shape[0]
    steps = ts_b[:, None] + torch.arange(window, device=ts_b.device)
    rows = torch.arange(B, device=ts_b.device)[:, None]
    out = {}
    for key, arr in dev_fields.items():
        T, NB, D = arr.shape
        win = arr.reshape(T, B, NB // B, D)[steps, rows]    # (B, W, Npad, D)
        out[key] = win.permute(0, 2, 1, 3).reshape(NB, window, D)
    return out


def _stack(per_step) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([losses[k] for losses in per_step])
            for k in per_step[0]}


def warmup_window(graph):
    """A pushforward-sized trajectory window cut to its final 2 steps, so
    that the warmup epochs (no retarget) supervise one step ahead of the
    input, as a plain step does."""
    upd = {k: getattr(graph, k)[:, -2:] for k in _WINDOW_FIELDS
           if getattr(graph, k) is not None and getattr(graph, k).shape[1] > 2}
    return graph.replace(**upd) if upd else graph


class Trainer:
    """Epoch / mini-epoch training loop (reference train.py:159-243).

    Under a process group of more than one rank, ``settings.multi_gpu``
    must be set (N copies of one run are never what a launch of N ranks
    means) and takes the data-parallel loop; ``settings.num_devices``, when
    set with it, must equal the world size (the JAX package takes the
    first ``num_devices`` devices). ``multi_gpu`` with one rank takes the
    single path, as the JAX package's does with one device."""

    def __init__(self, config: Config, model, logger=None, checkpointer=None,
                 monitor=None):
        settings = config.settings
        world = data_parallel.world_size()
        if world > 1 and not settings.multi_gpu:
            raise ValueError(
                f"a launch of {world} ranks without settings.multi_gpu: "
                "set it to train data-parallel, or launch one rank")
        if (settings.multi_gpu and settings.num_devices
                and settings.num_devices != world):
            raise ValueError(
                f"settings.num_devices = {settings.num_devices}, but the "
                f"launch has {world} ranks (one process per card)")
        self.data_parallel = bool(settings.multi_gpu) and world > 1
        self.rank = data_parallel.rank() if self.data_parallel else 0
        self.world = world if self.data_parallel else 1
        self.config = config
        self.model = model
        self.logger = logger
        self.checkpointer = checkpointer
        self.monitor = monitor
        self.mini_epoch_count = 0
        self.epoch_count = 0
        self.step_count = 0
        self.sample_count = 0

    # ---- state --------------------------------------------------------------
    def init_state(self) -> TrainState:
        """The state of the model's module (its weights as constructed), a
        fresh optimizer and a generator on the model's device seeded with
        ``settings.random_seed`` (on rank r of a data-parallel run, with
        ``data_parallel.rank_seed`` of it)."""
        seed = data_parallel.rank_seed(self.config.settings.random_seed,
                                       self.rank)
        module = self.model.module
        return TrainState(
            module=module,
            optimizer=select_optimizer(self.config, module.parameters()),
            step=0,
            generator=torch.Generator(device=self.model.device).manual_seed(seed))

    # ---- step ---------------------------------------------------------------
    def train_step(self, state: TrainState, graph, lr: float,
                   keep_grads: bool = False) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``graph`` at learning rate ``lr`` (the
        counterpart of ``_build_train_step``): transform (noise, flip) ->
        [pushforward] -> train-mode forward -> loss -> backward -> clip ->
        update. Returns the losses, detached, on the device (no host sync).
        With ``keep_grads`` and a monitor, the gradients it reads are copied
        before the clip (``_last_grads``): :meth:`run` asks so of the step
        that closes a mini-epoch, the only one whose gradients it logs."""
        losses = self._forward_backward(state, graph)
        if keep_grads and self.monitor is not None:
            self._last_grads = self.monitor.copy_gradients(state.module)
        optimizer_step(state.optimizer, lr, self.config.training.clip_grad_norm)
        state.step += 1
        return losses

    def dp_train_step(self, state: TrainState, graph, lr: float
                      ) -> Dict[str, torch.Tensor]:
        """One data-parallel step on this rank's share ``graph`` of the
        global batch (the counterpart of ``make_dp_train_step``): the single
        step's transform -> [pushforward] -> forward -> loss -> backward,
        then the mean over the ranks of the gradients, the losses and the
        BatchNorm running statistics in one ``all_reduce``, then the clip
        of the averaged gradients and AdamW. Returns the mean losses, on
        the device."""
        losses = self._forward_backward(state, graph)
        keys = list(losses)
        means = torch.stack([losses[k].float() for k in keys])
        data_parallel.all_reduce_mean_(
            gradients(state.optimizer) + [means]
            + data_parallel.batch_statistics(state.module))
        optimizer_step(state.optimizer, lr, self.config.training.clip_grad_norm)
        state.step += 1
        return dict(zip(keys, means.unbind()))

    def spmd_train_step(self, state: TrainState, graph, lr: float
                        ) -> Dict[str, torch.Tensor]:
        """One data x space step on this rank's local graph ``graph``: its
        space rank's part of its data row's batch (the counterpart of
        ``make_spmd_train_step``; :mod:`~gnn_fluid_dynamics_tpu_torch.
        parallel.spmd`). The single step's transform -> [pushforward] ->
        forward -> loss -> backward runs inside ``halo.sharded``: the draws
        are the data row's (every rank of a row shares its generator), the
        losses and BatchNorm statistics global to the row, and each rank's
        gradient the share of its owned rows. One ``all_reduce`` of one
        flat buffer then sums the gradients over every rank (the space
        sum and the data sum) and divides them by the number of data rows;
        the losses and the running statistics, equal on the ranks of a row,
        enter it from each row's space rank 0 alone. Then the clip and
        AdamW, as :meth:`dp_train_step`. Returns the mean losses."""
        with halo.sharded(graph.halo):
            losses = self._forward_backward(state, graph)
        keys = list(losses)
        means = torch.stack([losses[k].float() for k in keys])
        shared = [means] + data_parallel.batch_statistics(state.module)
        if graph.halo.space_rank:
            for t in shared:
                t.zero_()
        data_parallel.all_reduce_mean_(
            gradients(state.optimizer) + shared,
            divisor=data_parallel.world_size() // graph.halo.n_space)
        optimizer_step(state.optimizer, lr, self.config.training.clip_grad_norm)
        state.step += 1
        return dict(zip(keys, means.unbind()))

    def _forward_backward(self, state: TrainState, graph
                          ) -> Dict[str, torch.Tensor]:
        """A train step up to its gradients in ``.grad``: transform (noise,
        flip) -> [warm slice | pushforward retarget] -> train-mode forward
        -> loss -> backward. Returns the losses, detached."""
        model, t = self.model, self.config.training
        noise_std = float(t.noise_std or 0.0)
        pf = int(t.pushforward_factor or 0)
        # pushforward warmup: plain one-step training for the first
        # ``pushforward_warmup_epochs``, on the window's last two steps
        with_pf = self.epoch_count > int(t.pushforward_warmup_epochs or 0)
        use_pf = with_pf and pf > 0 and model.pushforward_use
        if (not with_pf) and pf > 0 and model.pushforward_use:
            graph = warmup_window(graph)
        tgraph, feats = model.transform_features(
            graph, state.generator, mode="train", noise_std=noise_std)
        if use_pf:
            feats = pushforward_retarget(model, tgraph, feats, pf)

        state.module.train()
        outputs = model.forward(tgraph, feats, mode="train",
                                generator=state.generator)
        losses = model.loss(outputs, feats, tgraph)
        state.optimizer.zero_grad(set_to_none=True)
        losses["total_log_loss"].backward()
        return {k: v.detach() for k, v in losses.items()}

    def train_step_multi(self, state: TrainState, graph, field_stack,
                         lrs, keep_grads: bool = False
                         ) -> Dict[str, torch.Tensor]:
        """``len(lrs)`` steps on one static batched graph, step ``i`` on the
        windows ``field_stack[key][i]`` at learning rate ``lrs[i]`` (the
        counterpart of ``train_step_multi``); ``keep_grads`` applies to the
        last step. Returns ``{loss: (k,)}`` on the device."""
        return _stack([self.train_step(
            state, graph.replace(**{k: v[i] for k, v in field_stack.items()}),
            lr, keep_grads and i == len(lrs) - 1)
            for i, lr in enumerate(lrs)])

    def train_step_indexed(self, state: TrainState, graph, dev_fields, ts,
                           lrs, window: int, keep_grads: bool = False
                           ) -> Dict[str, torch.Tensor]:
        """``len(lrs)`` steps on the trajectory store ``dev_fields``
        (``MeshDataset.device_fields``), step ``i`` on the ``window`` states
        from the start steps ``ts[i]`` (``ts``: ``(k, B)`` int), gathered on
        the device (the counterpart of ``train_step_indexed``);
        ``keep_grads`` applies to the last step. Returns ``{loss: (k,)}`` on
        the device."""
        return _stack([self.train_step(state, g, lr,
                                       keep_grads and i == len(lrs) - 1)
                       for i, (g, lr) in enumerate(
                           self._windows(graph, dev_fields, ts, lrs, window))])

    def dp_train_step_indexed(self, state: TrainState, graph, dev_fields,
                              ts, lrs, window: int) -> Dict[str, torch.Tensor]:
        """``len(lrs)`` data-parallel steps, each exactly
        :meth:`dp_train_step`, on this rank's own combination: its static
        batched ``graph``, its trajectory store ``dev_fields`` and its
        ``(k, B)`` start steps ``ts`` (the counterpart of
        ``make_dp_indexed_train_step``, whose ``shard_device_fields`` gives
        each device its own store). Returns ``{mean loss: (k,)}``."""
        return _stack([self.dp_train_step(state, g, lr) for g, lr in
                       self._windows(graph, dev_fields, ts, lrs, window)])

    def _windows(self, graph, dev_fields, ts, lrs, window: int):
        """(graph with step ``i``'s windows gathered on the device, lr) for
        each step of an indexed call; raises on start steps whose window
        leaves the store."""
        ts = np.asarray(ts)
        T = min(v.shape[0] for v in dev_fields.values())
        if ts.size and (ts.min() < 0 or ts.max() + window > T):
            raise ValueError(f"start steps {ts.min()}..{ts.max()} with a "
                             f"window of {window} leave a store of {T} steps")
        ts_host = torch.from_numpy(np.ascontiguousarray(ts, np.int64))
        if graph.device.type == "cuda":
            # pinned, so the copy needs no host sync; the caching host
            # allocator keeps the buffer until the copy has completed
            ts_host = ts_host.pin_memory()
        ts_dev = ts_host.to(graph.device, non_blocking=True)
        for i, lr in enumerate(lrs):
            yield graph.replace(**gather_windows(dev_fields, ts_dev[i],
                                                 window)), lr

    def train_path(self, dataset: MeshDataset) -> str:
        """``"data_parallel"``, ``"indexed"``, ``"multi"`` or ``"single"``:
        how :meth:`run` feeds ``dataset``. The data-parallel path takes one
        step a call, whatever ``steps_per_call`` says, as the JAX package's
        does. Otherwise ``steps_per_call > 1`` takes the indexed path when
        ``training.device_fields`` says so or, where it is None, when the
        dataset's trajectories fit DEVICE_FIELD_BUDGET on the device."""
        t = self.config.training
        if self.data_parallel:
            return "data_parallel"
        if max(1, int(t.steps_per_call or 1)) == 1:
            return "single"
        use_dev = t.device_fields
        if use_dev is None:
            use_dev = (dataset.estimate_device_field_bytes()
                       <= DEVICE_FIELD_BUDGET)
        return "indexed" if use_dev else "multi"

    def _batches(self, dataset: MeshDataset, rng: np.random.Generator):
        """One epoch of the sampler's batches through the feed of
        :meth:`train_path`: ``("single", graph)``, ``("multi", graph,
        field_stack)``, ``("indexed", graph, dev_fields, ts)`` or
        ``("data_parallel", graph)``."""
        t = self.config.training
        spc = max(1, int(t.steps_per_call or 1))
        path = self.train_path(dataset)
        if path == "data_parallel":
            return (("data_parallel", g) for g in prefetch(
                iter(self._dp_batches(dataset, rng)), dataset,
                size=t.prefetch_buffer))
        batches = get_sampler(self.config.dataset.sampler)(
            dataset, t.batch_size, rng)
        if path == "indexed":
            return prefetch_indexed(batches, dataset, spc)
        if path == "multi":
            return prefetch_grouped(batches, dataset, spc,
                                    size=t.prefetch_buffer)
        return (("single", g) for g in prefetch(batches, dataset,
                                                size=t.prefetch_buffer))

    def _dp_batches(self, dataset: MeshDataset, rng: np.random.Generator
                    ) -> list:
        """This rank's share of each global batch of an epoch (the JAX
        package's DP loop, trainer.py:463-476): the sampler, seeded alike on
        every rank, at a batch of ``per_dev * world`` with ``per_dev =
        max(batch_size // world, 1)``, shorter batches skipped; rank r takes
        samples ``[r * per_dev, (r + 1) * per_dev)`` of each. The batches
        are rank 0's, broadcast once an epoch: ``static_chunked`` draws its
        timestep orders in the iteration order of a set of mesh ids, which
        each process hashes its own way (PYTHONHASHSEED), so two ranks'
        samplers need not agree. Collective, so it runs in the caller's
        thread, ahead of the feed's worker."""
        per_dev = max(self.config.training.batch_size // self.world, 1)
        glob = per_dev * self.world
        batches = data_parallel.broadcast_object(
            [samples for samples in get_sampler(self.config.dataset.sampler)(
                dataset, glob, rng) if len(samples) == glob]
            if self.rank == 0 else None)
        return [samples[self.rank * per_dev:(self.rank + 1) * per_dev]
                for samples in batches]

    # ---- loop ---------------------------------------------------------------
    def run(self, state: TrainState, train_dataset: MeshDataset,
            valid_dataset: Optional[MeshDataset] = None,
            num_valid_steps: int = 50) -> TrainState:
        """Validate, then train ``training.epochs`` epochs of the sampler's
        batches, one step a call or ``steps_per_call`` (:meth:`train_path`);
        when the step count crosses a mini-epoch boundary, log the mean
        losses (and the monitor's records), validate every
        ``valid_frequency`` and checkpoint every ``save_frequency``
        mini-epochs. A fused call of ``n`` steps takes one learning rate and
        advances the counters by ``n``; a boundary it crosses is taken after
        it (the JAX package's crossing rule, one mini-epoch a call).
        ``GFD_EPOCH_LIMIT`` bounds the epochs of this call; a run it cuts
        saves its tail. Data-parallel, the state is replicated from rank 0
        first, a step counts ``per_dev * world`` samples, and the validation,
        the logs, the monitor and the checkpoints are rank 0's, the other
        ranks waiting for it at a barrier."""
        cfg = self.config
        t = cfg.training
        total_mini_epochs = max(
            1, (t.epochs * len(train_dataset)) // t.mini_epoch_size)
        schedule = get_schedule(t.lr_class, t, total_mini_epochs)
        steps_per_mini_epoch = max(t.mini_epoch_size // t.batch_size, 1)
        np_rng = np.random.default_rng(cfg.settings.random_seed)
        lead = self.rank == 0
        if self.data_parallel:
            data_parallel.replicate_(state.module)

        # pre-training validation (reference train.py:169-171)
        if valid_dataset is not None and lead:
            self._last_valid = self.validate(state, valid_dataset,
                                             num_valid_steps)
            self._log(self._last_valid, prefix="valid")
        if self.data_parallel:
            data_parallel.barrier()

        mini_losses: Dict[str, float] = {}
        pending: list = []
        me_start = time.time()
        epoch_limit = int(os.environ.get("GFD_EPOCH_LIMIT", "0") or 0)
        epochs_this_run = 0
        for _ in range(t.epochs - self.epoch_count):
            if epoch_limit and epochs_this_run >= epoch_limit:
                break
            epochs_this_run += 1
            self.epoch_count += 1
            for item in self._batches(train_dataset, np_rng):
                graph = item[1]
                lr = schedule(self.mini_epoch_count)
                if item[0] == "indexed":
                    n = item[3].shape[0]
                elif item[0] == "multi":
                    n = next(iter(item[2].values())).shape[0]
                else:
                    n = 1
                self.step_count += n
                self.sample_count += graph.num_graphs * n * self.world
                closes = (self.step_count // steps_per_mini_epoch
                          > self.mini_epoch_count)
                # the losses stay on the device until the mini-epoch ends:
                # reading one per step would sync host and card every step
                if item[0] == "indexed":
                    pending.append(self.train_step_indexed(
                        state, graph, item[2], item[3], [lr] * n,
                        train_dataset.data_window, keep_grads=closes))
                elif item[0] == "multi":
                    pending.append(self.train_step_multi(
                        state, graph, item[2], [lr] * n, keep_grads=closes))
                elif item[0] == "data_parallel":
                    pending.append(self.dp_train_step(state, graph, lr))
                else:
                    pending.append(self.train_step(state, graph, lr,
                                                   keep_grads=closes))
                if not closes:
                    continue
                self.mini_epoch_count += 1
                keys = list(pending[0])
                # a single step's losses are scalars, a fused call's (n,)
                sums = torch.cat([torch.stack([p[k] for k in keys]).reshape(
                    len(keys), -1) for p in pending], 1).double().sum(1).tolist()
                for k, v in zip(keys, sums):
                    mini_losses[k] = mini_losses.get(k, 0.0) + v
                pending = []
                me_time = time.time() - me_start
                if lead:
                    self._boundary(state, mini_losses, me_time,
                                   steps_per_mini_epoch, lr, valid_dataset,
                                   num_valid_steps)
                if self.data_parallel:
                    data_parallel.barrier()
                mini_losses = {}
                me_start = time.time()
        if (self.checkpointer is not None and lead
                and self.epoch_count < t.epochs):
            # an epoch-limit break between mini-epoch boundaries: persist the
            # tail so the restarted run loses nothing
            self.checkpointer.save(state, self, mini_losses,
                                   valid_losses=getattr(self, "_last_valid",
                                                        None))
        return state

    def _boundary(self, state: TrainState, mini_losses: Dict[str, float],
                  me_time: float, steps_per_mini_epoch: int, lr: float,
                  valid_dataset, num_valid_steps: int) -> None:
        """A mini-epoch's end (rank 0's): the monitor's records (reference
        train.py:258-277), the mean losses and times, its printed line, the
        validation and the checkpoint when due, the learning rate and the
        sample count."""
        cfg = self.config
        if self.monitor is not None and self.logger is not None:
            grads = getattr(self, "_last_grads", None)
            step = self.mini_epoch_count
            self.monitor.monitor_decoder_gradients(state.module, grads,
                                                   self.logger, step)
            self.monitor.monitor_decoder_updates(state.module, self.logger,
                                                 step)
            self.monitor.monitor_scalar_parameters(state.module, grads,
                                                   self.logger, step)
        for k in mini_losses:
            mini_losses[k] /= steps_per_mini_epoch
        self._log(mini_losses, prefix="train")
        self._log({"train_step_time": me_time / steps_per_mini_epoch,
                   "mini_epoch_train_time": me_time}, prefix="performance")
        print(f"\ttrain | e {self.epoch_count:>3} | me "
              f"{self.mini_epoch_count:>5} | s {self.step_count:>6}"
              f" | t {me_time:<3.2e} | loss "
              f"{mini_losses.get('total_log_loss', float('nan')):>3.2e}"
              f" | lr {lr:>3.2e}", flush=True)

        if (valid_dataset is not None and cfg.logging.valid_frequency
                and self.mini_epoch_count % cfg.logging.valid_frequency == 0):
            self._last_valid = self.validate(state, valid_dataset,
                                             num_valid_steps)
            self._log(self._last_valid, prefix="valid")
        if (self.checkpointer is not None and cfg.logging.save_frequency
                and self.mini_epoch_count % cfg.logging.save_frequency == 0):
            # the latest validation drives 'best' (logging.py:293-327)
            self.checkpointer.save(
                state, self, mini_losses,
                valid_losses=getattr(self, "_last_valid", None))
        self._log({"learning_rate": lr,
                   "sample_count": self.sample_count}, prefix="train")

    # ---- validation (reference train.py:286-303) ----------------------------
    def validate(self, state: TrainState, valid_dataset: MeshDataset,
                 num_steps: int) -> Dict[str, float]:
        """The validation rollout (``training/validate.py``) in eval mode,
        its error evolutions and snapshots logged, its line printed; returns
        the flat error summary."""
        t0 = time.time()
        state.module.eval()
        snapshot_indices = [i for i in self.config.rollout.snapshot_indices
                            if i < num_steps]
        errors, fields = validation_rollout(self.model, valid_dataset,
                                            num_steps,
                                            save_fields=bool(snapshot_indices))
        scalars, evo = error_summary(errors, valid_dataset.sim_ids())
        if self.logger is not None:
            self.logger.save_plots(evo, step=self.mini_epoch_count,
                                   prefix="rollout")
            if snapshot_indices:
                self.logger.save_snapshot(
                    self._snapshot_payload(fields, valid_dataset,
                                           snapshot_indices),
                    step=self.mini_epoch_count, prefix="rollout")
        err = scalars["total_mean_error"]
        print(f"\tvalid | e {self.epoch_count:>3} | me "
              f"{self.mini_epoch_count:>5} | s {self.step_count:>6} | t "
              f"{time.time() - t0:<3.2e} | error {err:>3.2e}", flush=True)
        return flat_summary(scalars)

    def _snapshot_payload(self, fields: Dict, dataset: MeshDataset,
                          snapshot_indices) -> Dict:
        """Per-mesh snapshot dicts for ``Logger.save_snapshot`` (reference
        ``Rollout._save_snapshot``, rollout.py:225-253)."""
        Cp = dataset.pad_to["cell"]
        cv = fields["cell_velocity"].detach().cpu().numpy()
        out = {}
        for ts in snapshot_indices:
            meshes = {}
            for b, mesh_id in enumerate(dataset.sim_ids()):
                traj = dataset.by_id[mesh_id]
                C = traj.geom["cell_pos"].shape[0]
                meshes[mesh_id] = {
                    "field_data": cv[ts, b * Cp: b * Cp + C],
                    "vertex_pos": traj.geom["vertex_pos"],
                    "vertex_face": traj.geom["vertex_face"],
                }
            out[ts] = meshes
        return out

    def _log(self, values: Dict[str, float], prefix: str):
        if self.logger is not None:
            self.logger.save_loss(values, step=self.mini_epoch_count,
                                  prefix=prefix)
