"""The halo of a space-sharded graph: the exchange of ghost rows, the sums
over the space group, and the random draws at the global row count.

A graph sharded over ``space`` ranks (:mod:`.spmd`) is one local
:class:`~gnn_fluid_dynamics_tpu_torch.graph.MeshGraph` per rank, whose
cells and faces are the rows the rank owns and the ghost rows that its
owned rows read through the index tables, and whose ``halo`` field is this
module's :class:`Halo`. The JAX package leaves XLA's partitioner to insert
the collectives; here the model code calls them where it reads a
neighbour's row, and each is a no-op on a graph without a halo:

* :func:`refresh` overwrites the ghost rows of a cell- or face-row tensor
  with their owners' values (one ``all_to_all_single`` of the rows, as
  bytes, over the space group); its backward is the transpose: the ghost
  rows' gradients go to their owners and are added there, and the ghost
  rows get zero. NCCL exchanges on the card. Gloo has no all-to-all for
  CUDA tensors, so with gloo (several ranks sharing one card, or the CPU)
  the rows of a CUDA tensor are staged through host memory and the
  exchange runs on the CPU copies;
* inside :func:`sharded` (the sharded rollout and train step enter it),
  :func:`reduce_sums` and :func:`reduce_statistics` all-reduce the masked
  numerators and counts of the losses, the rollout metrics and the
  train-mode BatchNorm over the space group before they are divided, so
  that every rank holds the global value, and :func:`draw` makes a random
  draw at the global row count and takes the rank's rows, so that a rank
  draws what the single process draws at its rows;
* two reductions over the whole graph: :func:`first_owned` (per graph,
  the value at the candidate row of least global id, from its owner:
  FvgnK's first INFLOW face) and :func:`all_rows` (every rank's owned rows
  in one global-sized tensor on every rank: VertPotG's last-write face
  flux, whose writes read cells of the whole graph).

Every failed exchange raises: there is no fallback.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

KINDS = ("cell", "face")            # the row kinds that have owners


@dataclasses.dataclass(eq=False)
class Halo:
    """One rank's part of a space sharding.

    ``gid[kind]`` is the global row of each local row (a local pad row maps
    to the global graph's last row), ``global_rows[kind]`` the global
    graph's padded row count, for ``"cell"``, ``"face"`` and ``"vertex"``;
    the three local row counts differ (:mod:`.spmd` pads them so), which
    tells :func:`draw` the kind of a tensor by its rows.
    ``send_rows[kind]`` are the local owned rows sent, peer by peer in
    space-rank order, ``send_splits[kind]`` how many to each peer;
    ``recv_rows``/``recv_splits`` the local ghost rows they fill, likewise
    (both sides order a peer's rows by global id). ``live_faces`` marks the
    local faces the global graph's ``face_mask`` marks (owned and ghost):
    the local graph's own masks mark its owned rows only. ``exchanges`` and
    ``bytes_sent`` count what :func:`refresh` did (backward included).
    ``unowned[kind]`` are the global rows no rank owns (the global graph's
    pad rows), which :func:`all_rows` fills from space rank 0's pad row."""

    group: object                       # the space group (None: the default)
    n_space: int
    space_rank: int
    gid: Dict[str, torch.Tensor]
    global_rows: Dict[str, int]
    send_rows: Dict[str, torch.Tensor]
    send_splits: Dict[str, List[int]]
    recv_rows: Dict[str, torch.Tensor]
    recv_splits: Dict[str, List[int]]
    live_faces: torch.Tensor
    exchanges: int = 0
    bytes_sent: int = 0
    unowned: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    def kind_of(self, rows: int) -> str:
        """The row kind whose local count is ``rows``."""
        for kind, ids in self.gid.items():
            if ids.shape[0] == rows:
                return kind
        raise NotImplementedError(
            f"a tensor of {rows} rows is neither the cells, the faces nor "
            f"the vertices of this rank's graph "
            f"({ {k: v.shape[0] for k, v in self.gid.items()} }): its rows "
            "cannot be drawn at the global count (ROADMAP §1 item 6)")

    def transfer(self, send: torch.Tensor, send_splits: List[int],
                 recv_splits: List[int]) -> torch.Tensor:
        """One ``all_to_all_single`` over the space group: ``send``'s rows,
        ``send_splits[p]`` of them to peer p; returns the rows received,
        ``recv_splits[p]`` from peer p, in ``send``'s dtype. The rows travel
        as bytes, so every dtype arrives bit for bit."""
        rest, dtype, dev = send.shape[1:], send.dtype, send.device
        width = math.prod(rest) * send.element_size()
        raw = send.contiguous().view(torch.uint8).reshape(send.shape[0], width)
        staged = dev.type == "cuda" and dist.get_backend(self.group) != "nccl"
        if staged:
            raw = raw.cpu()
        recv = torch.empty((sum(recv_splits), width), dtype=torch.uint8,
                           device=raw.device)
        dist.all_to_all_single(recv, raw, recv_splits, send_splits,
                               group=self.group)
        self.exchanges += 1
        self.bytes_sent += raw.numel()
        if staged:
            recv = recv.to(dev)
        return recv.view(dtype).reshape((recv.shape[0],) + tuple(rest))


class _Exchange(torch.autograd.Function):
    """The ghost rows of ``x`` overwritten by their owners' rows; backward,
    the ghost rows' gradients added to their owners' and zeroed."""

    @staticmethod
    def forward(ctx, x, halo: Halo, kind: str):
        ctx.halo, ctx.kind = halo, kind
        got = halo.transfer(x.index_select(0, halo.send_rows[kind]),
                            halo.send_splits[kind], halo.recv_splits[kind])
        return x.index_copy(0, halo.recv_rows[kind], got)

    @staticmethod
    def backward(ctx, grad):
        halo, kind = ctx.halo, ctx.kind
        back = halo.transfer(grad.index_select(0, halo.recv_rows[kind]),
                             halo.recv_splits[kind], halo.send_splits[kind])
        out = grad.index_fill(0, halo.recv_rows[kind], 0)
        return out.index_add(0, halo.send_rows[kind], back), None, None


def refresh(x: torch.Tensor, graph, kind: str) -> torch.Tensor:
    """``x`` (the ``kind`` rows of ``graph``, ``"cell"`` or ``"face"``) with
    its ghost rows refreshed from their owners; ``x`` itself on a graph
    without a halo or of one space rank."""
    halo = graph.halo
    if halo is None or halo.n_space == 1:
        return x
    return _Exchange.apply(x, halo, kind)


def refresh_state(solution: Dict, graph) -> Dict:
    """A derived state with its ``cell_velocity`` refreshed: the feedback
    and the MLS divergence metric read it through the index tables."""
    if graph.halo is None or "cell_velocity" not in solution:
        return solution
    return {**solution,
            "cell_velocity": refresh(solution["cell_velocity"], graph, "cell")}


_ACTIVE: Optional[Halo] = None


@contextlib.contextmanager
def sharded(halo: Optional[Halo]):
    """Within it, the reductions and draws act for ``halo``'s rank (no-ops
    for ``None``)."""
    global _ACTIVE
    previous, _ACTIVE = _ACTIVE, halo
    try:
        yield
    finally:
        _ACTIVE = previous


def _flat_all_reduce(tensors, group) -> List[torch.Tensor]:
    dtype = functools.reduce(torch.promote_types, [t.dtype for t in tensors])
    flat = torch.cat([t.detach().to(dtype).reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [part.view_as(t).to(t.dtype) for t, part in
            zip(tensors, flat.split([t.numel() for t in tensors]))]


class _SumReplicated(torch.autograd.Function):
    """Sums over the space group whose users are replicated on every rank
    (a loss): the backward passes the gradient through, which each rank
    then holds in full, so each rank's parameters get the gradient of its
    own rows' share, and the shares sum to the whole."""

    @staticmethod
    def forward(ctx, group, *tensors):
        return tuple(_flat_all_reduce(tensors, group))

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + grads


class _SumPartitioned(torch.autograd.Function):
    """Sums over the space group whose users are partitioned among the
    ranks (BatchNorm statistics normalizing each rank's rows): each rank's
    gradient is its rows' share, so the backward sums them too."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(_flat_all_reduce(tensors, group))

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros_like(g) if g is None else g for g in grads]
        return (None,) + tuple(_flat_all_reduce(grads, ctx.group))


def _sums(fn, tensors):
    halo = _ACTIVE
    if halo is None or halo.n_space == 1:
        return tensors if len(tensors) > 1 else tensors[0]
    out = fn.apply(halo.group, *tensors)
    return out if len(out) > 1 else out[0]


def reduce_sums(*tensors):
    """The masked numerators and counts of a loss or metric summed over the
    space group (the tensors as they are outside :func:`sharded`)."""
    return _sums(_SumReplicated, tensors)


def reduce_statistics(*tensors):
    """The masked sums of a train-mode BatchNorm summed over the space
    group (the tensors as they are outside :func:`sharded`)."""
    return _sums(_SumPartitioned, tensors)


def draw(fn, shape, generator: torch.Generator, device,
         dtype=torch.float32) -> torch.Tensor:
    """``fn(shape, generator=, device=, dtype=)`` (``torch.rand`` or
    ``torch.randn``); inside :func:`sharded`, drawn at the global row count
    of the rows' kind and cut to this rank's rows, so that a rank of a data
    row's shared generator draws the single process's values at its rows."""
    halo = _ACTIVE
    if halo is None:
        return fn(shape, generator=generator, device=device, dtype=dtype)
    kind = halo.kind_of(shape[0])
    full = fn((halo.global_rows[kind],) + tuple(shape[1:]),
              generator=generator, device=device, dtype=dtype)
    return full.index_select(0, halo.gid[kind])


def first_owned(graph, kind: str, candidate: torch.Tensor,
                values: torch.Tensor, batch: torch.Tensor, num_graphs: int):
    """Per graph of a batch, the ``values`` row of its ``candidate`` row
    (``kind`` rows, masked by ``candidate``, graph ``batch``) with the least
    global id: ``(found (num_graphs,) bool, value (num_graphs, ...))``, the
    value 0 where a graph has no candidate. On a space-sharded graph each
    rank offers its owned candidates (pass ``candidate`` masked by the
    owned rows), the space group takes the least global id, and the rank
    that owns that row supplies its value to every rank, exactly (a sum
    with zeros). No gradient flows through it."""
    halo = graph.halo
    rows = candidate.shape[0]
    gid = (torch.arange(rows, device=candidate.device) if halo is None
           else halo.gid[kind].to(candidate.device))
    n = rows if halo is None else halo.global_rows[kind]
    prio = torch.where(candidate, gid, torch.full_like(gid, n))
    first = torch.full((num_graphs,), n, dtype=gid.dtype,
                       device=gid.device).scatter_reduce_(
        0, batch.long(), prio, "amin")
    spread = halo is not None and halo.n_space > 1
    if spread:
        dist.all_reduce(first, op=dist.ReduceOp.MIN, group=halo.group)
    mine = candidate & (gid == first[batch.long()])
    v = values.detach()
    picked = torch.where(mine.reshape((-1,) + (1,) * (v.ndim - 1)), v,
                         torch.zeros_like(v))
    value = torch.zeros((num_graphs,) + v.shape[1:], dtype=v.dtype,
                        device=v.device).index_add_(0, batch.long(), picked)
    if spread:
        dist.all_reduce(value, group=halo.group)
    return first < n, value


def all_rows(x: torch.Tensor, graph, kind: str) -> torch.Tensor:
    """The global graph's ``kind`` rows of ``x`` on every rank of the space
    group, each from the rank that owns it, and a row no rank owns (a pad
    row of the global graph) from space rank 0's pad row, which its rank
    computes from the same inputs: one all-reduce of a global-sized
    tensor. Its backward sums the gradients of every rank's use over the
    group and hands each row its sum. ``x`` itself on a graph without a
    halo."""
    halo = graph.halo
    if halo is None:
        return x
    own = graph.cell_mask if kind == "cell" else graph.face_mask
    full = x.new_zeros((halo.global_rows[kind],) + x.shape[1:]).index_copy(
        0, halo.gid[kind][own], x[own])
    pads = halo.unowned.get(kind)
    if halo.space_rank == 0 and pads is not None and len(pads):
        full = full.index_copy(0, pads, x[-1:].expand(
            (len(pads),) + x.shape[1:]))
    if halo.n_space == 1:
        return full
    (out,) = _SumPartitioned.apply(halo.group, full)
    return out


def live_faces(graph) -> torch.Tensor:
    """The faces the global graph marks live at ``graph``'s rows: its
    ``face_mask``, or on a local graph its owned and ghost faces."""
    return graph.face_mask if graph.halo is None else graph.halo.live_faces
