"""The rank side of ``tests/test_torch_spmd.py``: each rank runs in a
process of its own, started by ``torch.multiprocessing``, on the CPU with
gloo and one intra-op thread. It imports torch and the port only. The test
process writes what the ranks need (``inputs.pt``: the mesh, its fields,
weights, statistics and configs) into a directory; each rank runs every
scenario of its world size and writes what it found there
(``<scenario>_<world>_rank<r>.pt``; gathered fields on each data row's
space rank 0).
"""

import copy
import traceback

import torch
import torch.distributed as dist

from gnn_fluid_dynamics_tpu_torch.data import pipeline
from gnn_fluid_dynamics_tpu_torch.data.node_types import NodeType
from gnn_fluid_dynamics_tpu_torch.graph import batch_graphs, from_geometry
from gnn_fluid_dynamics_tpu_torch.models.base import ModelConfig
from gnn_fluid_dynamics_tpu_torch.models.registry import (MODEL_REGISTRY,
                                                          get_model_class)
from gnn_fluid_dynamics_tpu_torch.ops import fvm, kernels
from gnn_fluid_dynamics_tpu_torch.parallel import halo, spmd
from gnn_fluid_dynamics_tpu_torch.rollout import engine
from gnn_fluid_dynamics_tpu_torch.training import trainer

STEPS = 5


def graph(inputs, window=2, mls=False, start=0):
    """The port's graph of the test mesh at ``window`` states from state
    ``start``, with order-1 MLS weights at cells and faces given ``mls``."""
    fields = {k: v[start:start + window] for k, v in inputs["fields"].items()}
    if mls:
        fields.update(inputs["mls"])
    return from_geometry(inputs["geom"], fields, dt=0.01, pad_multiple=128,
                         device="cpu")


def build_model(spec):
    """The port's model of ``spec`` (name, config fields, statistics, state
    dict) on the CPU; without ``augment`` its train-mode transform draws no
    noise and no flip."""
    m = get_model_class(spec["name"])(
        ModelConfig(name=spec["name"], **spec["config"]), device="cpu",
        seed=spec.get("seed", 0), loss_weights=spec.get("loss_weights"))
    m.set_stats(spec["stats"])
    if spec.get("state_dict") is not None:
        m.module.load_state_dict(spec["state_dict"])
    if not spec.get("augment", True):
        tt = m.transform_features
        m.transform_features = (
            lambda g, generator=None, mode="rollout", noise_std=0.0: tt(
                g, None, mode, noise_std))
    return m


def sharded_rollout(model, g, mesh, steps, gt=None):
    """``make_spmd_rollout`` on this rank's part of ``g``; the errors and
    the fields gathered in global order (None off space rank 0)."""
    lg = spmd.shard_graph_spatial(g, mesh)
    _, feats = model.transform_rollout(lg)
    cfg = engine.RolloutConfig(num_steps=steps, compute_error=gt is not None,
                               save_fields=True)
    local_gt = ([spmd.local_rows(x, lg, "cell", 1) for x in gt]
                if gt is not None else (None, None))
    errors, fields = spmd.make_spmd_rollout(model, cfg)(lg, feats, *local_gt)
    return errors, spmd.gather_fields(fields, lg, mesh), lg.halo


def rollouts(inputs, mesh):
    """Each rollout case: STEPS sharded steps with the error metrics, the
    halo's exchanges and bytes."""
    gt = [torch.from_numpy(x) for x in inputs["ground_truth"]]
    out = {}
    for case, spec in inputs["rollouts"].items():
        g = graph(inputs, mls=spec["name"] == "MgnA")
        errors, fields, h = sharded_rollout(build_model(spec), g, mesh,
                                            STEPS, gt)
        out[case] = {"errors": errors, "fields": fields,
                     "exchanges": h.exchanges, "bytes": h.bytes_sent}
    return out


def adjoint(inputs, mesh):
    """The exchange on the partition of the test mesh, in f64: a rank's
    rows of a global tensor with its ghost rows scrambled come back as they
    were (the ghosts from their owners, bit for bit; the other rows
    untouched); and <E x, y> summed over the ranks equals <x, E^T y> summed
    over the ranks, E^T being the backward, for random x and y of each
    rank."""
    lg = spmd.shard_graph_spatial(graph(inputs), mesh)
    h = lg.halo
    gen = torch.Generator().manual_seed(1234 + mesh.space_index)
    out = {}
    for kind in ("cell", "face"):
        full = torch.randn((h.global_rows[kind], 3), dtype=torch.float64,
                           generator=torch.Generator().manual_seed(7))
        mine = spmd.local_rows(full, lg, kind)
        ghost = torch.zeros(mine.shape[0], dtype=torch.bool)
        ghost[h.recv_rows[kind]] = True
        got = halo.refresh(torch.where(ghost[:, None], -mine - 1.0, mine),
                           lg, kind)
        out[f"{kind}_ghosts"] = int(ghost.sum())
        out[f"{kind}_forward_equal"] = bool(torch.equal(got, mine))
        x = torch.randn(mine.shape, generator=gen, dtype=torch.float64,
                        requires_grad=True)
        y = torch.randn(mine.shape, generator=gen, dtype=torch.float64)
        ex = halo.refresh(x, lg, kind)
        (xt_y,) = torch.autograd.grad(ex, x, y)
        sums = torch.stack([(ex.detach() * y).sum(),
                            (x.detach() * xt_y).sum()])
        dist.all_reduce(sums, group=mesh.space_group)
        out[f"{kind}_adjoint"] = sums.tolist()
    out["exchanges"] = h.exchanges
    return out


def _config(inputs, key):
    cfg = copy.deepcopy(inputs["configs"][key])
    cfg.settings.multi_gpu = True
    return cfg


def train_result(state, losses):
    return {"losses": losses,
            "state": copy.deepcopy(state.module.state_dict()),
            "moments": copy.deepcopy(state.optimizer.state_dict()["state"])}


def spmd_steps(inputs, mesh, case):
    """``inputs["train"][case]``: its steps on this rank's part of its data
    row's batch, through ``make_spmd_train_step``."""
    spec = inputs["train"][case]
    ds = pipeline.MeshDataset(
        [pipeline.Trajectory(mesh_id="m0", geom=inputs["geom"],
                             fields=dict(inputs["fields"]))],
        data_window=spec["window"], pad_multiple=128, device="cpu")
    cfg = _config(inputs, spec["config"])
    tr = trainer.Trainer(cfg, build_model(spec["model"]))
    tr.epoch_count = spec["epoch"]
    state = spmd.init_state(tr, mesh)
    step = spmd.make_spmd_train_step(tr, mesh)
    losses = []
    for starts in spec["starts"]:
        graphs = [ds.get_batch([("m0", t)]) for t in starts]
        losses.append(step(state, spmd.shard_spatial_batch(graphs, mesh),
                           spec["lr"]))
    return train_result(state, losses)


def dp_steps(inputs, case):
    """``inputs["train"][case]`` as ``dp_train_step``s, rank r on the data
    row r's batches: the 2 x 2 step's counterpart on 2 ranks."""
    spec = inputs["train"][case]
    ds = pipeline.MeshDataset(
        [pipeline.Trajectory(mesh_id="m0", geom=inputs["geom"],
                             fields=dict(inputs["fields"]))],
        data_window=spec["window"], pad_multiple=128, device="cpu")
    tr = trainer.Trainer(_config(inputs, spec["config"]),
                         build_model(spec["model"]))
    tr.epoch_count = spec["epoch"]
    state = tr.init_state()
    r = dist.get_rank()
    losses = [tr.dp_train_step(state, ds.get_batch([("m0", starts[r])]),
                               spec["lr"]) for starts in spec["starts"]]
    return train_result(state, losses)


def registry(inputs, mesh):
    """Every registered name: a rollout of 2 forwards on the kernel route
    (the kernels' plain versions) and on the plain route, and one train
    step with noise, flip and dropout, sharded."""
    g = graph(inputs, window=3, mls=True)
    lg = spmd.shard_graph_spatial(g, mesh)
    out = {}
    for name in sorted(MODEL_REGISTRY):
        res = {}
        try:
            for aggregation in ("pallas", "segment"):
                m = build_model(registry_spec(inputs, name, aggregation))
                k = int(m.config.bundle_size or 1)
                _, feats = m.transform_rollout(lg)
                _, fields = spmd.make_spmd_rollout(
                    m, engine.RolloutConfig(num_steps=2 * k,
                                            compute_error=False,
                                            save_fields=True))(lg, feats)
                res[aggregation] = spmd.gather_fields(fields, lg, mesh)
            tr = trainer.Trainer(_config(inputs, "registry"), build_model(
                registry_spec(inputs, name, "segment", train=True)))
            state = spmd.init_state(tr, mesh)
            res["train"] = train_result(state, spmd.make_spmd_train_step(
                tr, mesh)(state, lg, inputs["lr"]))
        except Exception:
            res = {"error": traceback.format_exc()}
        out[name] = res
    return out


def registry_spec(inputs, name, aggregation, train=False):
    """The registry case's model: hidden 16, 2 blocks, seeded weights,
    statistics from the test mesh (computed in the test process), FvgnC
    with a bundle of 2, dropout in the train step."""
    cfg = {"hidden_width": 16, "mp_num": 2, "aggregation": aggregation,
           "bundle_size": 2 if name == "FvgnC" else None,
           "dropout_rate": inputs["dropout"] if train else 0.0}
    return {"name": name, "config": cfg, "seed": 0,
            "stats": inputs["registry_stats"][name],
            "loss_weights": inputs["configs"]["registry"].training.loss_weights}


def table_graph(inputs, window=2):
    """The test mesh's graph with int8 banded tables, on the table route
    (the trainer's validation graph), with MLS weights."""
    fields = {k: v[:window] for k, v in inputs["fields"].items()}
    fields.update(inputs["mls"])
    return from_geometry(inputs["geom"], fields, dt=0.01, pad_multiple=128,
                         with_banded=True, banded_dtype="int8", device="cpu")


KERNEL_WRAPPERS = ("fused_face_block", "fused_cell_block", "edges_to_vertices",
                   "vertices_to_cells", "gather_face_cells", "table_dual",
                   "table_single")


def counted_calls():
    """Count each kernel wrapper's calls (on the CPU each runs its plain
    version): returns the counts, reset by ``counts.clear()``."""
    counts = {}

    def wrap(name, fn):
        def call(*args, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kw)
        return call
    for name in KERNEL_WRAPPERS:
        setattr(kernels, name, wrap(name, getattr(kernels, name)))
    return counts


def table_rollouts(inputs, mesh, counts):
    """Each table-route case: STEPS sharded steps on the rank's local graph
    with its own tables, with the error metrics, the halo's exchanges and
    bytes, the local graph's band widths and the kernel wrappers called."""
    gt = [torch.from_numpy(x) for x in inputs["ground_truth"]]
    g = table_graph(inputs)
    lg = spmd.shard_graph_spatial(g, mesh)
    out = {}
    for case, spec in inputs["table_rollouts"].items():
        counts.clear()
        errors, fields, h = sharded_rollout(build_model(spec), g, mesh,
                                            STEPS, gt)
        out[case] = {"errors": errors, "fields": fields,
                     "exchanges": h.exchanges, "bytes": h.bytes_sent,
                     "calls": dict(counts)}
    out["bands"] = spmd.band_widths(lg)
    out["table_route"] = lg.table_route
    out["local_rows"] = [lg.num_cells, lg.num_faces, lg.num_vertices]
    return out


def family_rollouts(inputs, mesh):
    """Each family case (a name on a route): STEPS sharded steps with the
    error metrics, gathered."""
    gt = [torch.from_numpy(x) for x in inputs["ground_truth"]]
    g = graph(inputs, mls=True)
    out = {}
    for case, spec in inputs["families"].items():
        errors, fields, h = sharded_rollout(build_model(spec), g, mesh,
                                            STEPS, gt)
        out[case] = {"errors": errors, "fields": fields,
                     "exchanges": h.exchanges}
    return out


def family_steps(inputs, mesh):
    """Each family's train step (``inputs["family_steps"]``: no noise, flip
    or dropout), data row d on the window from state d with MLS weights,
    on this rank's part of it."""
    graphs = [graph(inputs, mls=True, start=d) for d in range(mesh.n_data)]
    local = spmd.shard_spatial_batch(graphs, mesh)
    out = {}
    for name, spec in inputs["family_steps"].items():
        tr = trainer.Trainer(_config(inputs, "jax"), build_model(spec))
        tr.epoch_count = 1
        state = spmd.init_state(tr, mesh)
        losses = spmd.make_spmd_train_step(tr, mesh)(state, local,
                                                     inputs["lr"])
        out[name] = train_result(state, losses)
    return out


def first_inflow(inputs, mesh):
    """FvgnK's reference velocity on the rank's local graph, with the mesh's
    INFLOW faces kept only where space rank ``t`` owns them, for each t in
    turn, and with none kept (``"none"``); then a batch of two copies of
    the mesh, the second without INFLOW faces. Per case the owned faces'
    global ids and their u_ref and l_ref. Also ``halo.first_owned`` on
    random f64 values at the mesh's INFLOW faces: (found, value)."""
    g = graph(inputs)
    part = spmd.partition(g, mesh.n_space)
    inflow = g.face_type.reshape(-1) == NodeType.INFLOW
    owner = torch.from_numpy(part.owner["face"])
    model = build_model(inputs["fvgnk"])
    out = {}

    def refs(gg, p):
        lg = spmd.local_graph(gg, p, mesh.space_index, mesh.space_group)
        _, feats = model.transform_rollout(lg)
        u, l_ = model._refs(lg, feats)
        own = lg.face_mask
        return {"ids": lg.halo.gid["face"][own], "u_ref": u[own],
                "l_ref": l_[own]}

    for t in list(range(mesh.n_space)) + ["none"]:
        drop = inflow & (owner != t) if t != "none" else inflow
        ft = torch.where(drop[:, None], torch.full_like(g.face_type,
                                                        NodeType.NORMAL),
                         g.face_type)
        out[t] = refs(g.replace(face_type=ft), part)
    no_inflow = g.replace(face_type=torch.where(
        inflow[:, None], torch.full_like(g.face_type, NodeType.NORMAL),
        g.face_type))
    batch = batch_graphs([g, no_inflow])
    out["batch"] = refs(batch, spmd.partition(batch, mesh.n_space))
    lg = spmd.local_graph(g, part, mesh.space_index, mesh.space_group)
    values = torch.randn(g.num_faces, dtype=torch.float64,
                         generator=torch.Generator().manual_seed(5))
    found, value = halo.first_owned(
        lg, "face", (lg.face_type.reshape(-1) == NodeType.INFLOW)
        & lg.face_mask, spmd.local_rows(values, lg, "face"), lg.face_batch,
        lg.num_graphs)
    out["random"] = {"found": found, "value": value}
    return out


def lastwrite(inputs, mesh):
    """VertPotG's face flux conversion on the rank's local graph, of random
    f64 cell fluxes (the global graph's pad cells alike, as a model's
    are): the owned faces' global ids and fluxes, the faces whose two
    cells lie on different ranks, and the gradient of the owned faces'
    sum weighted by random f64 weights at the owned cells."""
    g = graph(inputs)
    part = spmd.partition(g, mesh.n_space)
    lg = spmd.local_graph(g, part, mesh.space_index, mesh.space_group)
    gen = torch.Generator().manual_seed(11)
    cf = torch.randn((g.num_cells, 3), dtype=torch.float64, generator=gen)
    cf[~g.cell_mask] = cf[-1].clone()
    w = torch.randn((g.num_faces, 1), dtype=torch.float64, generator=gen)
    x = spmd.local_rows(cf, lg, "cell").requires_grad_(True)
    ff = fvm.cell_flux_to_face_flux_lastwrite_g(x, lg)
    own = lg.face_mask
    ids = lg.halo.gid["face"][own]
    (grad,) = torch.autograd.grad(
        (ff[own] * w[ids]).sum(), x)
    cei = g.cell_edge_index.long()
    cut = torch.from_numpy(part.owner["cell"])[cei[0]] != torch.from_numpy(
        part.owner["cell"])[cei[1]]
    return {"ids": ids, "face_flux": ff[own].detach(),
            "cut_owned": int(cut[ids].sum()),
            "cell_ids": lg.halo.gid["cell"][lg.cell_mask],
            "grad": grad[lg.cell_mask]}


def _group(rank, world, workdir, store):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/{store}",
                            rank=rank, world_size=world)
    return torch.load(f"{workdir}/inputs.pt", weights_only=False)


def _finish(found, workdir, world, rank):
    for scenario, value in found.items():
        torch.save(value, f"{workdir}/{scenario}_{world}_rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def tables_main(rank, world, workdir):
    """One rank of ``world`` (1 x world) for ``tests/test_torch_spmd_tables.py``:
    the table-route rollouts."""
    inputs = _group(rank, world, workdir, f"tables{world}")
    counts = counted_calls()
    _finish({"tables": table_rollouts(inputs, spmd.make_mesh_spatial(world),
                                      counts)}, workdir, world, rank)


def families_main(rank, world, workdir):
    """One rank of ``world`` for ``tests/test_torch_spmd_families.py``: the
    family rollouts, FvgnK's reduction and VertPotG's conversion on 1 x
    world, and the family train steps on 1 x 2 (world 2) or 2 x 2 (world
    4)."""
    inputs = _group(rank, world, workdir, f"families{world}")
    mesh = spmd.make_mesh_spatial(world)
    found = {"rollouts": family_rollouts(inputs, mesh),
             "first_inflow": first_inflow(inputs, mesh),
             "lastwrite": lastwrite(inputs, mesh)}
    found["steps"] = family_steps(inputs, mesh if world == 2
                                  else spmd.make_mesh_2d(2, 2))
    _finish(found, workdir, world, rank)


def rank_main(rank, world, workdir):
    """One rank of ``world``: every scenario of its world size."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store{world}",
                            rank=rank, world_size=world)
    inputs = torch.load(f"{workdir}/inputs.pt", weights_only=False)
    found = {}
    if world == 2:
        mesh = spmd.make_mesh_spatial(2)
        found["rollouts"] = rollouts(inputs, mesh)
        found["adjoint"] = adjoint(inputs, mesh)
        found["jax_1x2"] = spmd_steps(inputs, mesh, "jax_1x2")
        found["noisy_1x2"] = spmd_steps(inputs, mesh, "noisy_1x2")
        found["dp"] = dp_steps(inputs, "noisy_2x2")
        found["registry"] = registry(inputs, mesh)
    else:
        mesh = spmd.make_mesh_spatial(4)
        found["rollouts"] = rollouts(inputs, mesh)
        found["adjoint"] = adjoint(inputs, mesh)
        mesh = spmd.make_mesh_2d(2, 2)
        found["jax_2x2"] = spmd_steps(inputs, mesh, "jax_2x2")
        found["noisy_2x2"] = spmd_steps(inputs, mesh, "noisy_2x2")
    for scenario, value in found.items():
        torch.save(value, f"{workdir}/{scenario}_{world}_rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
