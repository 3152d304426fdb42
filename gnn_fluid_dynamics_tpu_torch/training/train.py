"""Training CLI (counterpart of ``gnn_fluid_dynamics_tpu/training/train.py``;
reference ``src/train.py main()``, train.py:318-470): config, optional
resume, datasets and statistics, the model, the trainer loop.

    python -m gnn_fluid_dynamics_tpu_torch.training.train --config config/train_synthetic.json --device cpu
    python -m gnn_fluid_dynamics_tpu_torch.training.train --config ... --resume latest
    torchrun --nproc_per_node N -m gnn_fluid_dynamics_tpu_torch.training.train --config ...

It runs on the card unless ``--device cpu`` is given, and raises when there
is none. Under ``torchrun`` (its ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``) each rank trains on ``cuda:LOCAL_RANK`` in a process group
(NCCL; gloo with ``--device cpu``) whose rendezvous is ``--dist-init``
(``env://`` by default), data-parallel when ``settings.multi_gpu`` is set
(:mod:`gnn_fluid_dynamics_tpu_torch.parallel.data_parallel`): every rank
builds the training set and the statistics (rank 0 first, the others then
read its cache), loads ``--resume`` and honours ``GFD_EPOCH_LIMIT``; rank 0
alone builds the validation set, the logger, the monitor and the
checkpoints it writes. Data comes from the ``synthetic`` module (Taylor-Green
trajectories) or, for any other module, from the reference-layout HDF5 files
``<dataset.dpath>/<subset>.h5``, read into memory or, with ``dataset.lazy``
(by default once a subset holds more than ``dataset.cache_meshes`` meshes),
streamed through the out-of-core store; the meshes are padded in
``dataset.num_buckets`` size buckets. ``--resume`` and a
warm start from ``model.fpath`` read this package's checkpoints, those
converted from the JAX package's included
(``scripts/torch_convert_flax_checkpoint.py``).
"""

from __future__ import annotations

import argparse
import os
import sys
import traceback
from typing import List, Optional

import numpy as np
import torch

from gnn_fluid_dynamics_tpu_torch import resolve_device

_BANDED = ("banded", "pallas", "auto")


def build_datasets(config, model_cls, splits=("train", "valid"),
                   device="cuda"):
    """(train_ds, valid_ds), None for a split not in ``splits``.
    ``dataset.module`` "synthetic" makes Taylor-Green trajectories; any
    other reads ``<dataset.dpath>/<subset>.h5`` (the OpenFOAM modules' face
    flux divided by 0.001, as the reference loads it), the validation split
    the meshes ``rollout.data_sim_index`` where given. The file is streamed
    through the out-of-core store (``data/hdf5.py::load_dataset_lazy``, an
    LRU of ``dataset.cache_meshes`` geometry arrays, and the datasets' graph
    caches bounded at as many) where ``dataset.lazy`` is true, or, with it
    unset, where the subset (its ``sim_limit`` meshes, or all of the file's)
    holds more than ``dataset.cache_meshes`` meshes, as the JAX package
    decides. With a banded aggregation the meshes are RCM-ordered, as in
    the JAX package (a streamed mesh's fields permuted on read and its
    reordered geometry one entry of the store's LRU), and the validation
    split carries the banded tables its rollout reads (K6/K7 on the card);
    the training split carries none, since the train step takes the plain
    route. Both are padded in ``dataset.num_buckets`` size buckets. A model
    that asks for MLS weights gets them, of the configured order or 1."""
    from gnn_fluid_dynamics_tpu_torch.data.pipeline import (MeshDataset,
                                                            Trajectory,
                                                            compute_window)
    from gnn_fluid_dynamics_tpu_torch.ops.reorder import (rcm_reorder_geometry,
                                                          reorder_fields)

    stride, window = compute_window(config.model.timestep_stride,
                                    config.training.pushforward_factor,
                                    config.model.bundle_size)
    r_stride, r_window = compute_window(config.model.timestep_stride, None,
                                        config.model.bundle_size,
                                        mode="rollout")
    banded = config.model.aggregation in _BANDED

    def synthetic(sim_limit, timestep_range, window):
        from gnn_fluid_dynamics_tpu_torch.data.synthetic import (
            make_geometry, taylor_green_trajectory)
        T = (timestep_range[1] if timestep_range else 30) + window + 1
        trajs = []
        for i in range(sim_limit or 2):
            geom = make_geometry("structured", nx=10 + i % 3, ny=6,
                                 jitter=0.15, seed=i)
            fields = taylor_green_trajectory(geom, num_timesteps=T, dt=0.01)
            trajs.append(Trajectory(mesh_id=f"mesh_{i}", geom=geom,
                                    fields=fields))
        return trajs

    def hdf5(subset, sim_limit, sim_index):
        """(trajectories, whether they stream)."""
        from gnn_fluid_dynamics_tpu_torch.data import hdf5 as store
        flux_scale = (1.0 / 0.001 if "openfoam" in config.dataset.module.lower()
                      else 1.0)
        path = os.path.join(config.dataset.dpath, subset + ".h5")
        lazy = config.dataset.lazy
        if lazy is None:
            # auto: stream a subset larger than the caches' bound
            with store.require_h5py().File(path, "r") as f:
                n_avail = sum(1 for k in f if k.startswith("mesh"))
            lazy = (sim_limit or n_avail) > config.dataset.cache_meshes
        kw = ({"cache_entries": config.dataset.cache_meshes} if lazy else {})
        loader = store.load_dataset_lazy if lazy else store.load_dataset
        return loader(path, sim_limit=sim_limit, sim_index=sim_index,
                      flux_scale=flux_scale, shuffle=config.dataset.shuffle,
                      **kw), bool(lazy)

    def rcm(t):
        """``t`` relabeled by RCM, in place; a streamed trajectory lazily:
        its permutations computed once, its fields permuted on read, its
        reordered geometry made on demand into the store's LRU."""
        from gnn_fluid_dynamics_tpu_torch.data.hdf5 import (
            LazyGeom, PermutedLazyArray, TransformedLazyGeom)
        from gnn_fluid_dynamics_tpu_torch.ops.reorder import perms_from_pos
        if isinstance(t.geom, LazyGeom):
            new_geom = rcm_reorder_geometry(
                {k: t.geom[k] for k in t.geom.keys()})
            cperm, fperm = perms_from_pos(t.geom, new_geom)
            t.fields = {k: PermutedLazyArray(
                v, cperm if k.startswith("cell") else fperm)
                for k, v in t.fields.items()}
            t.geom = TransformedLazyGeom(t.geom, rcm_reorder_geometry,
                                         "__rcm__")
        else:
            new_geom = rcm_reorder_geometry(t.geom)
            t.fields = reorder_fields(t.fields, t.geom, new_geom)
            t.geom = new_geom

    def load(subset, sim_limit, timestep_range, stride, window, with_banded,
             sim_index=None):
        lazy = False
        if config.dataset.module == "synthetic":
            trajs = synthetic(sim_limit, timestep_range, window)
        else:
            trajs, lazy = hdf5(subset, sim_limit, sim_index)
        if banded:
            # RCM relabeling narrows the aggregation bands
            for t in trajs:
                rcm(t)
        return MeshDataset(trajs, stride=stride, data_window=window,
                           timestep_range=timestep_range,
                           pad_multiple=config.training.pad_multiple,
                           with_banded=with_banded,
                           banded_dtype=("bfloat16"
                                         if config.model.compute_dtype
                                         == "bfloat16" else "float32"),
                           num_buckets=config.dataset.num_buckets,
                           max_cached_graphs=(config.dataset.cache_meshes
                                              if lazy else None),
                           device=device)

    train_ds = load(config.training.data_subset,
                    config.training.data_sim_limit,
                    config.training.data_timestep_range, stride, window,
                    False) if "train" in splits else None
    valid_ds = load(config.rollout.data_subset, config.rollout.data_sim_limit,
                    config.rollout.data_timestep_range, r_stride, r_window,
                    banded, sim_index=config.rollout.data_sim_index
                    ) if "valid" in splits else None
    for ds in (train_ds, valid_ds):
        if ds is None:
            continue
        if model_cls.cell_grad_weights_use:
            ds.add_grad_weights("cell", config.model.cell_grad_weights_order
                                or 1)
        if model_cls.face_grad_weights_use:
            ds.add_grad_weights("face", config.model.face_grad_weights_order
                                or 1)
    return train_ds, valid_ds


def compute_stats(config, model, dataset, save: bool = True):
    """Normalization statistics over the dataset's samples, cached in
    ``dataset.stats_fpath`` (reference ``DataSet.read_stats``,
    DataSet.py:314-337): read from there when it holds every statistic the
    model needs, else accumulated (over every ``stats_stride``-th sample)
    and, with ``save``, written there."""
    from gnn_fluid_dynamics_tpu_torch.models.base import feature_masks
    from gnn_fluid_dynamics_tpu_torch.models.normalizer import (
        StatsAccumulator, load_stats, save_stats)
    fpath = config.dataset.stats_fpath
    if fpath and os.path.exists(fpath) and not config.dataset.stats_recompute:
        cached = load_stats(fpath)
        needed = {k for k, v in model.nmap.registry.items()
                  if v.extractor is not None}
        if needed <= set(cached):
            print(f"\tstats loaded from {fpath}")
            return cached
    acc = StatsAccumulator(model.nmap)
    stride = max(1, int(config.dataset.stats_stride or 1))
    for i in range(0, len(dataset), stride):
        graph = dataset.get_item(i)
        _, feats = model.transform_rollout(graph)
        acc.update(feats, feature_masks(graph, feats))
    stats = acc.finalize()
    if fpath and save:
        os.makedirs(os.path.dirname(os.path.abspath(fpath)), exist_ok=True)
        save_stats(stats, fpath)
    return stats


def _flat(stats) -> List[float]:
    """The statistics' values in the order of their sorted names."""
    return [v for k in sorted(stats) for v in (
        _flat(stats[k]) if isinstance(stats[k], dict) else [float(stats[k])])]


def set_noise_std(config, stats):
    """noise_std = |noise_std_norm * mean(u)| (reference DataSet.py:339-342;
    the absolute value keeps a zero-mean dataset's std positive)."""
    if config.training.noise_std is None and config.training.noise_std_norm:
        config.training.noise_std = abs(config.training.noise_std_norm
                                        * stats["cell_velocity_x"]["mean"])
    print("Noise std set to:", config.training.noise_std)


def build_model(config, device):
    """The configured model on ``device``, its weights drawn from
    ``settings.random_seed``."""
    from gnn_fluid_dynamics_tpu_torch.models.base import ModelConfig
    from gnn_fluid_dynamics_tpu_torch.models.registry import get_model_class
    m = config.model
    cls = get_model_class(m.name)
    return cls(ModelConfig(name=m.name, hidden_width=m.hidden_width,
                           mp_num=m.mp_num, aggregation=m.aggregation,
                           compute_dtype=m.compute_dtype,
                           bundle_size=m.bundle_size,
                           scale_init=m.scale_init,
                           dropout_rate=config.training.dropout_rate,
                           remat=m.remat,
                           integrator_detach=tuple(m.integrator_detach),
                           pushforward=m.pushforward),
               device=device, seed=config.settings.random_seed,
               loss_weights=config.training.loss_weights)


def warm_start_state(state, trainer, config):
    """Warm start for training from ``model.fpath``, a checkpoint of this
    package (reference train.py:333-385): every weight whose name and shape
    match is taken, the optimizer starts fresh, and the checkpoint's
    counters are resumed unless ``model.warm_start_reset``."""
    from gnn_fluid_dynamics_tpu_torch.training.checkpoint import Checkpointer
    wpath = config.model.fpath
    wdir = os.path.dirname(wpath.rstrip("/"))
    which = os.path.basename(wpath.rstrip("/"))
    tree, meta = Checkpointer(wdir).load(
        which if which in ("latest", "best") else wpath)
    if meta is None:
        raise FileNotFoundError(f"no warm-start checkpoint at {wpath}")
    own = state.module.state_dict()
    merged = {k: v for k, v in tree["module"].items()
              if k in own and own[k].shape == v.shape}
    state.module.load_state_dict(merged, strict=False)
    if not config.model.warm_start_reset:
        trainer.mini_epoch_count = meta["mini_epoch"]
        trainer.epoch_count = meta["epoch"]
        trainer.step_count = meta["step"]
        trainer.sample_count = meta["sample_count"]
    print(f"Warm-started {len(merged)} of {len(own)} tensors from {wpath} "
          f"(checkpoint epoch {meta['epoch']}, "
          f"reset={config.model.warm_start_reset})")
    return state


def main(argv: Optional[List[str]] = None):
    """Train as the config says; returns (trainer, state). Exits with 3 when
    ``GFD_EPOCH_LIMIT`` cut the run before its last epoch (resumable)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--resume", type=str, default=None,
                        help="latest | best | path to a checkpoint dir")
    parser.add_argument("--ckpt-dir", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default) or cpu")
    parser.add_argument("--dist-init", type=str, default="env://",
                        help="the process group's rendezvous under a "
                             "launch of several ranks (env://, file://..., "
                             "tcp://host:port)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    launched = "WORLD_SIZE" in os.environ
    if launched:
        from gnn_fluid_dynamics_tpu_torch.parallel import data_parallel
        if device.type == "cuda":
            device = torch.device("cuda", data_parallel.launch_env()[2])
            torch.cuda.set_device(device)
        data_parallel.init_process_group(device, init_method=args.dist_init)
    try:
        return _main(args, device)
    finally:
        if launched:
            torch.distributed.destroy_process_group()


def _main(args, device):
    from gnn_fluid_dynamics_tpu_torch.parallel import data_parallel
    from gnn_fluid_dynamics_tpu_torch.training.checkpoint import (
        Checkpointer, restore_train_state)
    from gnn_fluid_dynamics_tpu_torch.training.config import (
        load_config, merge_checkpoint_config)
    from gnn_fluid_dynamics_tpu_torch.training.logging import Logger
    from gnn_fluid_dynamics_tpu_torch.training.monitoring import ModelMonitor
    from gnn_fluid_dynamics_tpu_torch.training.trainer import Trainer

    config = load_config(args.config)
    if args.debug:
        config.logging.is_debug = True
    ckpt_dir = args.ckpt_dir or os.path.join(
        "checkpoints", config.logging.project or "default",
        config.logging.name or config.model.name)
    checkpointer = Checkpointer(ckpt_dir)

    resume_meta, resume_wandb_id = None, None
    if args.resume:
        _, resume_meta = checkpointer.load(args.resume)
        if resume_meta is not None:
            config = merge_checkpoint_config(config, resume_meta["config"])
            resume_wandb_id = resume_meta.get("wandb_id")
            print(f"Resuming from {args.resume} "
                  f"(mini_epoch {resume_meta['mini_epoch']})")

    rank, world = data_parallel.rank(), data_parallel.world_size()
    lead = rank == 0
    np.random.seed(config.settings.random_seed)
    model = build_model(config, device)
    train_ds, valid_ds = build_datasets(
        config, type(model), splits=("train", "valid") if lead else ("train",),
        device=device)
    print(f"Train dataset: {len(train_ds)} samples over "
          f"{len(train_ds.trajectories)} meshes (bucket {train_ds.pad_to}"
          + (f", bucket pads {train_ds.bucket_pad}"
             if len(train_ds.bucket_pad) > 1 else "") + ")")

    if resume_meta and "stats" in resume_meta:
        stats = resume_meta["stats"]
    else:
        # rank 0 writes the cache; the others read it after
        stats = compute_stats(config, model, train_ds) if lead else None
        if world > 1:
            data_parallel.barrier()
        if not lead:
            stats = compute_stats(config, model, train_ds, save=False)
    if world > 1:
        data_parallel.assert_replicated(torch.tensor(
            _flat(stats), dtype=torch.float64, device=device),
            "the statistics")
    model.set_stats(stats)
    set_noise_std(config, stats)

    # the grad/param monitor exactly where the JAX package builds one: a
    # logger exists and logging.use_monitor is set
    logger = (None if (config.logging.is_debug or not lead)
              else Logger(config, resume_wandb_id=resume_wandb_id))
    monitor = (ModelMonitor()
               if logger is not None and config.logging.use_monitor else None)

    trainer = Trainer(config, model, logger=logger,
                      checkpointer=checkpointer if lead else None,
                      monitor=monitor)
    state = trainer.init_state()
    print(f"Model {config.model.name}: {model.count_parameters():,} parameters")

    if resume_meta is not None:
        tree, _ = checkpointer.load(args.resume)
        state = restore_train_state(tree, state)
        if trainer.rank > 0:
            # the checkpoint holds rank 0's generator: the others start
            # streams of their own, from the seed and the resumed step
            state.generator.manual_seed(data_parallel.rank_seed(
                config.settings.random_seed + state.step, trainer.rank))
        trainer.mini_epoch_count = resume_meta["mini_epoch"]
        trainer.epoch_count = resume_meta["epoch"]
        trainer.step_count = resume_meta["step"]
        trainer.sample_count = resume_meta["sample_count"]
    elif config.model.fpath:
        state = warm_start_state(state, trainer, config)

    num_valid_steps = 0 if valid_ds is None else max(
        1, (valid_ds.timestep_range[1] - valid_ds.timestep_range[0] - 1)
        // valid_ds.stride)
    state = trainer.run(state, train_ds, valid_ds,
                        num_valid_steps=num_valid_steps)
    if logger:
        logger.close()
    if trainer.epoch_count < config.training.epochs:
        # GFD_EPOCH_LIMIT break: rc 3 = incomplete but resumable
        print(f"Epoch limit reached at {trainer.epoch_count}/"
              f"{config.training.epochs}; resumable.")
        sys.exit(3)
    return trainer, state


if __name__ == "__main__":
    try:
        main()
    except KeyboardInterrupt:
        print("\nTraining stopped by keyboard interrupt.")
        sys.exit(1)
    except Exception as e:
        print(f"\nTraining failed: {e}")
        traceback.print_exc()
        sys.exit(1)
