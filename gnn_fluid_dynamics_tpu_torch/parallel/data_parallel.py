"""Data-parallel training, one process per card over ``torch.distributed``
(counterpart of ``gnn_fluid_dynamics_tpu/parallel/data_parallel.py``):

    torchrun --nproc_per_node N -m gnn_fluid_dynamics_tpu_torch.training.train --config ...

The JAX package runs one program over a mesh of devices (``shard_map``,
``pmean`` over ICI). Here each card has a process of its own (rank r on
``cuda:LOCAL_RANK``) that holds the whole train state, and
:meth:`~gnn_fluid_dynamics_tpu_torch.training.trainer.Trainer.dp_train_step`
averages across them with the collectives below: NCCL for CUDA tensors,
gloo for CPU tensors (or, with ``backend="gloo"``, for CUDA tensors of
several ranks that share one card). What the JAX package's step keeps, this
keeps:

* **the state is replicated**: :func:`replicate_` broadcasts rank 0's
  parameters and buffers before the first step; after it, identical
  averaged updates keep the replicas equal, bit for bit;
* **the means**: a step's gradients (zeros for a parameter the loss does
  not reach), its losses and the BatchNorm running statistics are averaged
  over the ranks in one ``all_reduce`` of one flat f32 buffer
  (:func:`all_reduce_mean_`: the sum, divided by the world size, as
  ``pmean``); the clip by global norm then acts on the averaged gradients,
  as optax's does after the ``pmean``, and AdamW after it;
* **the random streams differ by rank** (:func:`rank_seed`), as JAX folds
  the device index into its key, and rank 0 draws as the single process
  does.

Each rank assembles its own share of the global batch (the trainer's
``_dp_batches``), so no batch is stacked along a device axis: the JAX
package's ``graph.stack_graphs`` and ``shard_batch`` have no counterpart.
For the indexed call each rank holds only its own combination's trajectory
store (``MeshDataset.device_fields``), which is what ``shard_device_fields``
arranges there. The data x space sharding of the JAX package's
``parallel/spmd.py`` is :mod:`.spmd`, whose train step
(:meth:`~gnn_fluid_dynamics_tpu_torch.training.trainer.Trainer.spmd_train_step`)
reduces through the same :func:`all_reduce_mean_`.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from gnn_fluid_dynamics_tpu_torch.models.arch import BatchNorm

# rank r > 0 seeds its generator with seed + r * this (mod 2^63): the 64-bit
# golden-ratio increment of splitmix64, so that nearby seeds and ranks do not
# collide
_RANK_STRIDE = 0x9E3779B97F4A7C15


def launch_env() -> Tuple[int, int, int]:
    """(rank, world size, local rank) from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``); (0, 1, 0) outside a
    launch."""
    return (int(os.environ.get("RANK", 0)),
            int(os.environ.get("WORLD_SIZE", 1)),
            int(os.environ.get("LOCAL_RANK", 0)))


def init_process_group(device, init_method: str = "env://",
                       backend: str = None, rank: int = None,
                       world_size: int = None) -> None:
    """``torch.distributed.init_process_group`` for this rank: NCCL when
    ``device`` is a card and gloo on the CPU unless ``backend`` says
    (gloo on CUDA tensors lets several ranks share one card, which NCCL
    refuses); the rank and world size from :func:`launch_env` unless
    given; the rendezvous at ``init_method`` (``env://``: ``torchrun``'s
    ``MASTER_ADDR`` and ``MASTER_PORT``; or a ``file://`` or
    ``tcp://`` address)."""
    env_rank, env_world, _ = launch_env()
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=init_method,
        rank=env_rank if rank is None else rank,
        world_size=env_world if world_size is None else world_size)


def rank() -> int:
    """This process's rank; 0 outside a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The number of ranks; 1 outside a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s generator: ``seed`` itself on rank 0 (so
    that one rank draws noise, flips and dropout as the single process
    does), ``(seed + rank * 0x9E3779B97F4A7C15) mod 2^63`` on the others."""
    return seed if rank == 0 else (seed + rank * _RANK_STRIDE) % (1 << 63)


def barrier() -> None:
    """Every rank waits here for the others (on NCCL, on this rank's
    card)."""
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def broadcast_object(obj):
    """Rank 0's ``obj`` (any picklable value) on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def replicate_(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers broadcast into every rank's
    ``module``, in place (JAX's ``replicate``)."""
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t, 0)


def all_reduce_mean_(tensors: Sequence[torch.Tensor],
                     divisor: int = None) -> None:
    """Each f32 tensor replaced, in place, by its mean over the ranks: one
    ``all_reduce`` (sum) of one flat buffer holding them all, divided by the
    world size (or ``divisor``), as ``jax.lax.pmean`` divides its sum. With
    one rank the values come back unchanged, bit for bit."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat /= dist.get_world_size() if divisor is None else divisor
    with torch.no_grad():
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(part.view_as(t))


def batch_statistics(module: torch.nn.Module) -> List[torch.Tensor]:
    """The running mean and variance of each BatchNorm in ``module``: the
    JAX package's ``batch_stats`` collection, which its DP step averages
    (a ``MaskedBatchNorm`` of ``FaceAreaNorm`` or ``VolDtNorm``)."""
    return [t for m in module.modules() if isinstance(m, BatchNorm)
            for t in (m.running_mean, m.running_var)]


def assert_replicated(tensor: torch.Tensor, what: str) -> None:
    """Raise on every rank unless ``tensor`` holds rank 0's bits on every
    rank: rank 0's copy is broadcast and compared byte for byte on each,
    and the ranks agree on the verdict with one more ``all_reduce``."""
    own = tensor.detach().reshape(-1)
    ref = own.clone()
    dist.broadcast(ref, 0)
    differs = not torch.equal(ref.view(torch.uint8), own.view(torch.uint8))
    flag = torch.tensor([float(differs)], device=tensor.device)
    dist.all_reduce(flag)
    if flag.item():
        raise RuntimeError(f"{what} differ between the ranks "
                           f"({int(flag.item())} of {world_size()} differ "
                           "from rank 0's)")
