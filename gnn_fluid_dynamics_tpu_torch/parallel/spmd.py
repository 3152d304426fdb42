"""Data x space sharding, one process per rank over ``torch.distributed``
(counterpart of ``gnn_fluid_dynamics_tpu/parallel/spmd.py``):

    torchrun --nproc_per_node N ... (N = n_data * n_space)

The JAX package shards every per-entity array of a graph over a ``space``
mesh axis and every graph stack over a ``data`` axis, and leaves XLA's
partitioner to insert the collectives. PyTorch has no partitioner, so here
the graph is cut by hand and the halo exchange is written where XLA would
insert it:

* :func:`make_mesh_2d` is the rank layout: rank r is (d = r // n_space,
  s = r % n_space), with one ``torch.distributed`` group for each data
  row's space ranks;
* :func:`partition` (``graph_pspec``'s counterpart) cuts one whole graph
  into ``n_space`` parts. Each space rank owns a contiguous
  range of the live cells in their order (RCM order: few of a range's
  neighbours lie outside it), split evenly; a face belongs to the rank of
  its owner cell (``cell_edge_index[0]``); vertices belong to no rank, each
  computes its own. A rank's ghosts are the rows its owned rows reach: the
  cells on either side of each face of an owned cell, the faces and
  vertices of its owned cells, every face at such a vertex (so that K3's
  vertex sums are whole), and the MLS stencils' rows. Its local rows are
  its owned and ghost rows in increasing global id, then padded (at least
  one pad row, the three counts made to differ); an index that leaves them
  points at the last (pad) row, which holds zeros. The vertex CSR is built
  afresh on the local ids, so at every vertex of an owned cell it lists the
  global graph's half-rows in the global order, and its sums match the
  single process's bit for bit. A graph with banded tables (the table
  route's K6/K7) gets each rank's own tables, es/er, cf and vc, built from
  its local index tables with the offsets of its own rows: its rows keep
  increasing global id, so its bands stay as narrow as the whole graph's,
  and K6/K7 take a band of any width; the graph keeps its route;
* :func:`shard_graph_spatial` / :func:`shard_spatial_batch` give this
  rank's local graph (``MeshGraph.halo`` carries its exchange plan,
  :class:`~gnn_fluid_dynamics_tpu_torch.parallel.halo.Halo`), whose
  ``cell_mask``/``face_mask`` mark the owned rows: the losses, the metrics
  and the BatchNorm statistics sum over them and then over the space
  group. The model code refreshes ghost rows where it reads them
  (``models/arch.py``, ``rollout/engine.py``);
* ``replicate_2d`` is ``data_parallel.replicate_``;
* :func:`make_spmd_rollout` runs ``rollout_scan`` on the local graph and
  returns the global metrics and the owned rows of the saved fields with
  their global ids (:func:`gather_fields` puts them in global order on the
  first space rank); :func:`make_spmd_train_step` is
  ``Trainer.spmd_train_step``.

Every registered model runs on a local graph, on both routes: FvgnK takes
its reference velocity over the whole graph (``halo.first_owned``) and
VertPotG its face flux conversion from every rank's cells
(``fvm.cell_flux_to_face_flux_lastwrite_g``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from gnn_fluid_dynamics_tpu_torch import resolve_device
from gnn_fluid_dynamics_tpu_torch.graph import (FIELD_KEYS, MeshGraph,
                                                local_banded_fields,
                                                vertex_incidence_csr)
from gnn_fluid_dynamics_tpu_torch.parallel import data_parallel
from gnn_fluid_dynamics_tpu_torch.parallel.halo import KINDS, Halo

PAD_MULTIPLE = 128         # local row counts, as the datasets pad graphs

replicate_2d = data_parallel.replicate_


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """This rank's place in an ``n_data`` x ``n_space`` layout, and the
    group of its data row's space ranks."""
    n_data: int
    n_space: int
    data_index: int
    space_index: int
    space_group: object


def make_mesh_2d(n_data: int, n_space: int) -> Mesh2D:
    """The rank layout over the process group, whose size must be
    ``n_data * n_space``: rank r is (r // n_space, r % n_space). Every rank
    must call it (it creates one group per data row)."""
    world = data_parallel.world_size()
    if n_data * n_space != world:
        raise ValueError(f"a {n_data} x {n_space} layout needs "
                         f"{n_data * n_space} ranks, the group has {world}")
    groups = [dist.new_group([d * n_space + s for s in range(n_space)])
              for d in range(n_data)]
    r = data_parallel.rank()
    return Mesh2D(n_data, n_space, r // n_space, r % n_space,
                  groups[r // n_space])


def make_mesh_spatial(n_space: int) -> Mesh2D:
    """A 1 x ``n_space`` layout: every rank shards one graph."""
    return make_mesh_2d(1, n_space)


@dataclasses.dataclass
class Partition:
    """One whole graph cut into ``n_space`` parts: per part, the global ids
    of its live local rows (``rows[s][kind]``, increasing, for ``"cell"``,
    ``"face"`` and ``"vertex"``) and its padded local counts
    (``padded[s][kind]``); the owner of every global cell and face (-1 for
    a pad row); the global padded counts."""
    n_space: int
    rows: List[Dict[str, np.ndarray]]
    padded: List[Dict[str, int]]
    owner: Dict[str, np.ndarray]
    global_rows: Dict[str, int]


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def partition(graph: MeshGraph, n_space: int) -> Partition:
    """The space partition of ``graph`` (see the module's docstring)."""
    if graph.halo is not None:
        raise ValueError("the graph is already one rank's part")
    cm, fm, vm = _np(graph.cell_mask), _np(graph.face_mask), _np(graph.vertex_mask)
    cei = _np(graph.cell_edge_index).astype(np.int64)
    vei = _np(graph.vertex_edge_index).astype(np.int64)
    fidx = _np(graph.face_index).astype(np.int64)
    vf = _np(graph.vertex_face).astype(np.int64)
    cgn = (None if graph.cell_grad_neighbours is None
           else _np(graph.cell_grad_neighbours).astype(np.int64))
    fgn = (None if graph.face_grad_neighbours is None
           else _np(graph.face_grad_neighbours).astype(np.int64))
    live = np.flatnonzero(cm)
    if len(live) < n_space:
        raise ValueError(f"{len(live)} live cells cannot be cut into "
                         f"{n_space} parts")
    bounds = [s * len(live) // n_space for s in range(n_space + 1)]
    cell_owner = np.full(cm.shape[0], -1, np.int64)
    for s in range(n_space):
        cell_owner[live[bounds[s]:bounds[s + 1]]] = s
    face_owner = np.where(fm, cell_owner[cei[0]], -1)
    rows, padded = [], []
    for s in range(n_space):
        own = live[bounds[s]:bounds[s + 1]]
        fc = np.unique(fidx[:, own])
        fc = fc[fm[fc]]
        vc = np.zeros(vm.shape[0], bool)
        vc[vf[:, own]] = True
        at_vertex = np.flatnonzero(fm & (vc[vei[0]] | vc[vei[1]]))
        cells = [own, cei[:, fc].ravel()]
        faces = [fc, at_vertex]
        if cgn is not None:
            cells.append(cgn[own].ravel())
        if fgn is not None:
            faces.append(fgn[fc].ravel())
        cells = np.unique(np.concatenate(cells))
        cells = cells[cm[cells]]
        faces = np.unique(np.concatenate(faces))
        faces = faces[fm[faces]]
        verts = np.unique(np.concatenate([vf[:, cells].ravel(),
                                          vei[:, faces].ravel()]))
        verts = verts[vm[verts]]
        part = {"cell": cells, "face": faces, "vertex": verts}
        pads, taken = {}, set()
        for kind in ("cell", "face", "vertex"):
            n = _round_up(len(part[kind]) + 1, PAD_MULTIPLE)
            while n in taken:             # the counts tell the kinds apart
                n += PAD_MULTIPLE
            pads[kind] = n
            taken.add(n)
        rows.append(part)
        padded.append(pads)
    return Partition(n_space, rows, padded,
                     {"cell": cell_owner, "face": face_owner},
                     {"cell": cm.shape[0], "face": fm.shape[0],
                      "vertex": vm.shape[0]})


def local_graph(graph: MeshGraph, part: Partition, s: int, group=None,
                device=None) -> MeshGraph:
    """Space rank ``s``'s local graph of ``part`` (the partition of
    ``graph``), on ``device`` (``graph``'s by default), with its halo over
    ``group``. Geometry, types, signs, slots, windowed fields and MLS
    weights are sliced from ``graph``, never recomputed."""
    dev = graph.device if device is None else resolve_device(device)
    ids, pads = part.rows[s], part.padded[s]
    gmap = {}
    for kind, n_global in part.global_rows.items():
        m = np.full(n_global, pads[kind] - 1, np.int64)
        m[ids[kind]] = np.arange(len(ids[kind]))
        gmap[kind] = m

    def take(t, kind, fill=0):
        """Rows ``ids[kind]`` of ``t``, padded with ``fill``."""
        if t is None:
            return None
        x = _np(t)[ids[kind]]
        out = np.full((pads[kind],) + x.shape[1:], fill, x.dtype)
        out[:len(x)] = x
        return torch.from_numpy(out).to(dev)

    def index_np(t, src, dst, axis):
        """The index table ``t`` (rows of ``src`` along ``axis``) on the
        local ids of ``dst``; pad rows point at ``dst``'s pad row."""
        x = _np(t).astype(np.int64)
        x = np.take(x, ids[src], axis=axis)
        x = gmap[dst][x]
        width = [(0, 0)] * x.ndim
        width[axis] = (0, pads[src] - len(ids[src]))
        return np.pad(x, width, constant_values=pads[dst] - 1).astype(np.int32)

    def index(t, src, dst, axis):
        return torch.from_numpy(index_np(t, src, dst, axis)).to(dev)

    def owned(kind):
        m = np.zeros(pads[kind], bool)
        m[:len(ids[kind])] = part.owner[kind][ids[kind]] == s
        return torch.from_numpy(m).to(dev)

    local_index = {
        "vertex_edge_index": index_np(graph.vertex_edge_index, "face",
                                      "vertex", 1),
        "vertex_face": index_np(graph.vertex_face, "cell", "vertex", 1),
        "cell_edge_index": index_np(graph.cell_edge_index, "face", "cell", 1)}
    vei = torch.from_numpy(local_index["vertex_edge_index"]).to(dev)
    inc_ptr, inc_row = vertex_incidence_csr(local_index["vertex_edge_index"],
                                            pads["vertex"])
    vmask = np.zeros(pads["vertex"], bool)
    vmask[:len(ids["vertex"])] = True
    last_batch = (int(graph.cell_batch[-1]), int(graph.face_batch[-1]))
    grad = {}
    for loc in ("cell", "face"):
        if getattr(graph, f"{loc}_grad_weights") is not None:
            grad[f"{loc}_grad_weights"] = take(
                getattr(graph, f"{loc}_grad_weights"), loc)
            grad[f"{loc}_grad_neighbours"] = index(
                getattr(graph, f"{loc}_grad_neighbours"), loc, loc, 0)
    local = MeshGraph(
        cell_pos=take(graph.cell_pos, "cell"),
        cell_volume=take(graph.cell_volume, "cell"),
        cell_normal=take(graph.cell_normal, "cell"),
        cell_edge_index=torch.from_numpy(
            local_index["cell_edge_index"]).to(dev),
        cell_face_sign=take(graph.cell_face_sign, "cell"),
        face_pos=take(graph.face_pos, "face"),
        face_area=take(graph.face_area, "face"),
        face_normal=take(graph.face_normal, "face"),
        face_type=take(graph.face_type, "face"),
        face_index=index(graph.face_index, "cell", "face", 1),
        owner_local_slot=take(graph.owner_local_slot, "face"),
        vertex_pos=take(graph.vertex_pos, "vertex"),
        vertex_edge_index=vei,
        vertex_face=torch.from_numpy(local_index["vertex_face"]).to(dev),
        cell_mask=owned("cell"),
        face_mask=owned("face"),
        vertex_mask=torch.from_numpy(vmask).to(dev),
        face_boundary_mask=take(graph.face_boundary_mask, "face"),
        cell_batch=take(graph.cell_batch, "cell", last_batch[0]),
        face_batch=take(graph.face_batch, "face", last_batch[1]),
        vertex_inc_ptr=torch.from_numpy(inc_ptr).to(dev),
        vertex_inc_row=torch.from_numpy(inc_row).to(dev),
        num_graphs=graph.num_graphs,
        dt=graph.dt.to(dev),
        reynolds=graph.reynolds.to(dev),
        **{k: take(getattr(graph, k), k.split("_")[0]) for k in FIELD_KEYS},
        **grad,
        **(_local_tables(graph, local_index, ids, pads, dev)
           if graph.es_onehot is not None else {}),
        table_route=graph.table_route,
    )
    return local.replace(halo=_halo(part, s, group, dev, gmap))


def _local_tables(graph: MeshGraph, local_index, ids, pads, dev) -> dict:
    """A rank's banded tables, in ``graph``'s table dtype, built from its
    local index tables (``graph.local_banded_fields``). A live ghost face
    whose cell the rank does not hold keeps no cf entry for it (its local
    index points at the pad row, which would stretch its tile's band to
    the last row): it reads zeros there, and its row is refreshed from its
    owner before an owned row reads it. Its bands may be of any width:
    K6/K7 take them, and the graph never falls back to the index route."""
    cei = local_index["cell_edge_index"]
    cf_valid = np.ones(cei.shape, bool)
    n = len(ids["face"])
    cf_valid[:, :n] = cei[:, :n] != pads["cell"] - 1
    return local_banded_fields(local_index, pads, graph.es_onehot.dtype, dev,
                               cf_valid)


def band_widths(graph: MeshGraph) -> Dict[str, int]:
    """The band width of each table group of ``graph`` (es/er, cf, vc)."""
    return {name: int(getattr(graph, key).shape[2]) for name, key in
            (("es", "es_onehot"), ("cf", "cf_row_onehot"), ("vc", "vc_onehot"))}


def _halo(part: Partition, s: int, group, dev, gmap) -> Halo:
    """Space rank ``s``'s exchange plan: from peer p it receives its ghost
    rows that p owns, and to p it sends its owned rows that are p's ghosts,
    each in increasing global id."""
    def ghosts(r, kind, owner):
        g = part.rows[r][kind]
        return g[part.owner[kind][g] == owner]

    def t(x):
        return torch.from_numpy(np.asarray(x, np.int64)).to(dev)

    plan = {"send_rows": {}, "send_splits": {}, "recv_rows": {},
            "recv_splits": {}}
    for kind in KINDS:
        recv = [ghosts(s, kind, p) if p != s else np.zeros(0, np.int64)
                for p in range(part.n_space)]
        send = [ghosts(p, kind, s) if p != s else np.zeros(0, np.int64)
                for p in range(part.n_space)]
        plan["recv_rows"][kind] = t(gmap[kind][np.concatenate(recv)])
        plan["recv_splits"][kind] = [len(x) for x in recv]
        plan["send_rows"][kind] = t(gmap[kind][np.concatenate(send)])
        plan["send_splits"][kind] = [len(x) for x in send]
    gid = {}
    for kind, n_global in part.global_rows.items():
        g = np.full(part.padded[s][kind], n_global - 1, np.int64)
        g[:len(part.rows[s][kind])] = part.rows[s][kind]
        gid[kind] = t(g)
    live = np.zeros(part.padded[s]["face"], bool)
    live[:len(part.rows[s]["face"])] = True
    return Halo(group=group, n_space=part.n_space, space_rank=s, gid=gid,
                global_rows=dict(part.global_rows),
                live_faces=torch.from_numpy(live).to(dev),
                unowned={k: t(np.flatnonzero(v < 0))
                         for k, v in part.owner.items()}, **plan)


def shard_graph_spatial(graph: MeshGraph, mesh: Mesh2D,
                        device=None) -> MeshGraph:
    """This rank's local graph of the whole graph ``graph`` (the same on
    every space rank of its data row), on ``device``."""
    part = partition(graph, mesh.n_space)
    return local_graph(graph, part, mesh.space_index, mesh.space_group,
                       device)


def shard_spatial_batch(per_data_graphs: Sequence[MeshGraph], mesh: Mesh2D,
                        device=None) -> MeshGraph:
    """This rank's local graph of its data row's graph: one whole (batched)
    graph per data row, exactly ``mesh.n_data`` of them."""
    if len(per_data_graphs) != mesh.n_data:
        raise ValueError(
            f"shard_spatial_batch needs exactly mesh.n_data={mesh.n_data} "
            f"graphs, got {len(per_data_graphs)}")
    return shard_graph_spatial(per_data_graphs[mesh.data_index], mesh, device)


def local_rows(x: torch.Tensor, graph: MeshGraph, kind: str,
               dim: int = 0) -> torch.Tensor:
    """The local graph's rows of the global ``kind`` rows of ``x`` along
    ``dim`` (e.g. a (T, C, 2) ground truth); a pad row takes the global
    graph's last row."""
    halo = graph.halo
    return x.index_select(dim, halo.gid[kind].to(x.device))


def _field_kind(key: str) -> str:
    return "face" if key.startswith("face") else "cell"


def make_spmd_rollout(model, rollout_cfg) -> Callable:
    """The rollout on a local graph: returns ``run(graph, feats, gt_v=None,
    gt_p=None) -> (errors, fields)`` with ``graph`` from
    :func:`shard_graph_spatial`, ``feats`` from
    ``model.transform_rollout(graph)`` and the ground truth in local rows
    (:func:`local_rows`). ``errors`` are global (every rank holds them);
    ``fields`` hold each saved field's owned rows, (T, n_owned, ...), and
    ``final_cell_state``'s, with ``cell_ids``/``face_ids`` their global
    rows."""
    from gnn_fluid_dynamics_tpu_torch.rollout.engine import rollout_scan

    def run(graph, feats, gt_v=None, gt_p=None):
        errors, fields = rollout_scan(model, graph, feats, gt_v, gt_p,
                                      rollout_cfg)
        own = {"cell": graph.cell_mask, "face": graph.face_mask}
        out = {"cell_ids": graph.halo.gid["cell"][own["cell"]],
               "face_ids": graph.halo.gid["face"][own["face"]]}
        for key, v in fields.items():
            kind = _field_kind(key)
            out[key] = (v[own[kind]] if key == "final_cell_state"
                        else v[:, own[kind]])
        return errors, out
    return run


def gather_fields(fields: Dict[str, torch.Tensor], graph: MeshGraph,
                  mesh: Mesh2D) -> Dict[str, torch.Tensor]:
    """The owned rows of every space rank of this data row (``fields`` from
    :func:`make_spmd_rollout`'s ``run``) in global order, on the CPU, on
    space rank 0 (None on the others); a global row no rank owns (a pad
    row) holds zeros."""
    halo = graph.halo
    mine = {k: v.detach().cpu() for k, v in fields.items()}
    box = [None] * mesh.n_space if mesh.space_index == 0 else None
    dst = mesh.data_index * mesh.n_space
    dist.gather_object(mine, box, dst=dst, group=mesh.space_group)
    if box is None:
        return None
    out = {}
    for key in fields:
        if key.endswith("_ids"):
            continue
        kind = _field_kind(key)
        tdim = 0 if key == "final_cell_state" else 1
        first = box[0][key]
        shape = list(first.shape)
        shape[tdim] = halo.global_rows[kind]
        full = first.new_zeros(shape)
        for part in box:
            full.index_copy_(tdim, part[f"{kind}_ids"], part[key])
        out[key] = full
    return out


def init_state(trainer, mesh: Mesh2D):
    """The trainer's state on this rank: rank 0's weights broadcast to every
    rank, the generator seeded for the data row (``rank_seed(seed, d)``),
    shared by its space ranks."""
    state = trainer.init_state()
    replicate_2d(state.module)
    state.generator.manual_seed(data_parallel.rank_seed(
        trainer.config.settings.random_seed, mesh.data_index))
    return state


def make_spmd_train_step(trainer, mesh: Mesh2D) -> Callable:
    """``step(state, graph, lr) -> losses`` on this rank's local graph
    (:func:`shard_spatial_batch`): ``Trainer.spmd_train_step``, with the
    state from :func:`init_state`. The noise, the pushforward factor and
    its warm-up come from the trainer's config and epoch, as in
    ``Trainer.train_step``."""

    def step(state, graph, lr):
        if graph.halo is None or graph.halo.n_space != mesh.n_space:
            raise ValueError("the graph is not this layout's local graph "
                             "(shard_spatial_batch)")
        return trainer.spmd_train_step(state, graph, lr)
    return step
