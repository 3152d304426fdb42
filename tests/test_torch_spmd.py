"""The port's data x space sharding (``parallel/spmd.py``, ``parallel/halo.py``,
``Trainer.spmd_train_step``) on the CPU with gloo, against the port's
single process, its data-parallel step and the JAX package's
``make_spmd_rollout`` / ``make_spmd_train_step`` on the 8 host devices of
``tests/conftest.py``.

The mesh is the RCM-ordered 300-point cylinder of ``test_torch_fluxd.py``
(518 cells, 851 faces, padded to 640 and 896), its channel flow, order-1
MLS weights at cells and faces; the models hidden 16, 2 GN blocks, weights
from the JAX package's seeded init through ``weights.params_from_flax``.
The partition tests run in the test process. The sharded runs run in two
groups of processes started once for the module (``torch.multiprocessing``
on ``tests/torch_spmd_ranks.py``, gloo, one intra-op thread each, a file
store in the module's temporary directory): 2 ranks (1 x 2) and 4 ranks
(1 x 4, then 2 x 2).

Tolerances:

* a sharded rollout against the port's single process: the saved fields
  bit for bit on the live rows (each rank computes its owned rows as the
  single process does: the same rows, the same reduction orders, the CSR
  rows in the global order); the error metrics, sums of per-rank partial
  sums, within METRIC_RTOL;
* against the JAX package: its ``make_spmd_rollout`` on a
  ``make_mesh_spatial(n)`` mesh of the same n (its Pallas route partitions
  in interpret mode on host devices), and its single-device
  ``rollout_scan``'s metrics (the sharded rollout takes no ground truth).
  On the plain f32 route (FluxD, FvgnF and MgnA on ``"segment"``, FvgnA on
  ``"banded"`` as ``test_parallel.py``'s own test) the largest difference
  over the live rows within F32_TOL of the field's largest magnitude: the
  JAX test's rtol 1e-5 with an atol scaled to the field, where its absolute
  atol of 1e-6 fails already between the two packages' single processes
  (FvgnA's face pressure after 5 steps: 4.1e-6 apart at an element of
  about 0.1, on 0.9 the largest); on the kernel route ("pallas", bf16
  latents) within BF16_TOL, ``test_torch_fluxd.py``'s bound for that route;
* the train step (FvgnA, no noise, flip or dropout, as
  ``test_spmd_matches_single_device_gradients``) against JAX's
  ``make_spmd_train_step`` at 1 x 2 and 2 x 2: the losses within
  F32_TOL, AdamW's moments within MOMENT_RTOL of each tensor's largest
  magnitude (``test_torch_data_parallel.py``'s bound: they carry the
  gradients), the parameters at rtol 1e-5, atol 1e-6 (the JAX test's);
* with noise, flip, dropout and pushforward (FluxD) the 1 x 2 step against
  the port's ``train_step`` and the 2 x 2 step against ``dp_train_step`` on
  2 ranks: losses within F32_TOL, moments within MOMENT_RTOL (the draws
  are the single process's; the sums differ in order only; an AdamW step
  moves a parameter by about lr whatever its gradient, so the moments,
  not the parameters, are what see the gradients);
* every registered name: its sharded rollout on both routes as above (bit
  for bit), its train step's losses within F32_TOL and its gradients
  (AdamW's first moment) within F32_TOL of the model's largest gradient
  (a tensor whose gradient vanishes in exact arithmetic, as the bias of
  VertPot's vertex decoder whose potential enters only by differences,
  holds rounding noise of another order of summation).
"""

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
import copy
import shutil

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from torch_spmd_ranks import (STEPS, build_model, rank_main, registry_spec,
                              train_result)
from torch_spmd_ranks import graph as port_graph

from gnn_fluid_dynamics_tpu.data import pipeline as jax_pipeline
from gnn_fluid_dynamics_tpu.data.synthetic import (channel_flow_trajectory,
                                                   make_geometry)
from gnn_fluid_dynamics_tpu.graph import from_geometry as jax_from_geometry
from gnn_fluid_dynamics_tpu.graph import to_static_bands
from gnn_fluid_dynamics_tpu.models import get_model_class as jax_model_class
from gnn_fluid_dynamics_tpu.models.base import ModelConfig as JaxModelConfig
from gnn_fluid_dynamics_tpu.models.base import feature_masks as jax_masks
from gnn_fluid_dynamics_tpu.models.normalizer import \
    StatsAccumulator as JaxStatsAccumulator
from gnn_fluid_dynamics_tpu.ops.mls import compute_mls_weights
from gnn_fluid_dynamics_tpu.ops.reorder import rcm_reorder_geometry
from gnn_fluid_dynamics_tpu.parallel import (make_mesh_2d, make_mesh_spatial,
                                             make_spmd_rollout,
                                             make_spmd_train_step,
                                             replicate_2d, shard_graph_spatial,
                                             shard_spatial_batch)
from gnn_fluid_dynamics_tpu.rollout import engine as jax_engine
from gnn_fluid_dynamics_tpu.training import trainer as jax_trainer
from gnn_fluid_dynamics_tpu.training.config import Config as JaxConfig

from gnn_fluid_dynamics_tpu_torch.data import pipeline
from gnn_fluid_dynamics_tpu_torch.graph import batch_graphs, from_geometry
from gnn_fluid_dynamics_tpu_torch.models.base import ModelConfig, feature_masks
from gnn_fluid_dynamics_tpu_torch.models.normalizer import StatsAccumulator
from gnn_fluid_dynamics_tpu_torch.models.registry import (MODEL_REGISTRY,
                                                          get_model_class)
from gnn_fluid_dynamics_tpu_torch.parallel import data_parallel, halo, spmd
from gnn_fluid_dynamics_tpu_torch.rollout import engine
from gnn_fluid_dynamics_tpu_torch.training import trainer
from gnn_fluid_dynamics_tpu_torch.training.config import Config
from gnn_fluid_dynamics_tpu_torch.weights import (optimizer_state_from_optax,
                                                  params_from_flax)

HIDDEN, MP = 16, 2
LR = 1e-3
DROPOUT = 0.1
METRIC_RTOL = 1e-5
F32_TOL, BF16_TOL = 1e-5, 4e-2
MOMENT_RTOL = 1e-4
ROLLOUTS = {"FluxD-kernel": ("FluxD", "pallas"),
            "FluxD-plain": ("FluxD", "segment"),
            "FvgnF-kernel": ("FvgnF", "pallas"),
            "FvgnF-plain": ("FvgnF", "segment"),
            "MgnA-kernel": ("MgnA", "pallas"),
            "MgnA-plain": ("MgnA", "segment"),
            "FvgnA-banded": ("FvgnA", "banded")}
# exchanges per step on a 2-block model: the encoder's 2, 2 a block, the
# face decoder's output, the new cell state (MgnA has no face decoder)
EXCHANGES_PER_STEP = {"FluxD": 8, "FvgnF": 8, "MgnA": 7, "FvgnA": 8}


# ---- the mesh and the models both packages use ----------------------------------

@pytest.fixture(scope="module")
def data():
    """The mesh (geometry, STEPS + 2 states of a channel flow, MLS weights)
    and the JAX models of each rollout case with their weights and
    statistics."""
    geom = rcm_reorder_geometry(make_geometry("cylinder", n_points=300, seed=0))
    fields = channel_flow_trajectory(geom, num_timesteps=STEPS + 2, dt=0.01)
    mls = {}
    for loc in ("cell", "face"):
        nb, w = compute_mls_weights(geom[f"{loc}_pos"], 1)
        mls[f"{loc}_grad_weights"], mls[f"{loc}_grad_neighbours"] = w, nb
    n_cells = geom["cell_pos"].shape[0]
    pad = ((0, 0), (0, 640 - n_cells), (0, 0))
    gt = [np.pad(fields[k][1:STEPS + 1], pad).astype(np.float32)
          for k in ("cell_velocity", "cell_pressure")]
    inits = {}
    models = {case: _jax_model(name, aggregation, geom, fields, mls, inits)
              for case, (name, aggregation) in ROLLOUTS.items()}
    return {"geom": geom, "fields": fields, "mls": mls, "gt": gt,
            "models": models}


def _jax_graph(geom, fields, mls=None, window=2):
    window = {k: v[:window] for k, v in fields.items()}
    window.update(mls or {})
    return to_static_bands(jax_from_geometry(geom, window, dt=0.01,
                                             pad_multiple=128,
                                             with_banded=True))


def _jax_model(name, aggregation, geom, fields, mls, inits):
    """The JAX model (hidden 16, 2 blocks, FluxD with the shipped output
    scales), its statistics on the mesh and its variables from PRNGKey(0),
    drawn once per name (``inits``: the routes share them)."""
    g = _jax_graph(geom, fields, mls if name == "MgnA" else None)
    jm = jax_model_class(name)(JaxModelConfig(
        name=name, hidden_width=HIDDEN, mp_num=MP, aggregation=aggregation))
    _, feats = jm.transform_rollout(g)
    acc = JaxStatsAccumulator(jm.nmap)
    acc.update(feats, jax_masks(g, feats))
    stats = acc.finalize()
    jm.set_stats(stats)
    if name not in inits:
        inits[name] = jm.init(jax.random.PRNGKey(0), g, feats)
    variables = inits[name]
    return jm, g, feats, variables, {
        k: {s: float(v) for s, v in d.items()} for k, d in stats.items()}


def _spec(data, case, **config):
    name, aggregation = ROLLOUTS[case]
    _, _, _, variables, stats = data["models"][case]
    return {"name": name, "stats": stats,
            "config": {"hidden_width": HIDDEN, "mp_num": MP,
                       "aggregation": aggregation, **config},
            "state_dict": params_from_flax(variables)}


def _configs():
    """The port's train configs of the cases: ``jax`` (no noise, no
    pushforward), ``noisy`` (noise, pushforward 2 after a warm-up epoch)
    and ``registry`` (noise)."""
    out = {}
    for key, noise, pf in (("jax", 0.0, 0), ("noisy", 0.01, 2),
                           ("registry", 0.01, 0)):
        cfg = Config()
        cfg.training.noise_std = noise
        cfg.training.pushforward_factor = pf
        cfg.training.pushforward_warmup_epochs = 1
        cfg.training.lr_max = LR
        out[key] = cfg
    return out


def _registry_stats(inputs):
    """Each registered model's statistics on the registry's graph."""
    g = port_graph(inputs, window=3, mls=True)
    out = {}
    for name in sorted(MODEL_REGISTRY):
        m = get_model_class(name)(ModelConfig(
            name=name, hidden_width=HIDDEN, mp_num=MP,
            bundle_size=2 if name == "FvgnC" else None), device="cpu")
        _, feats = m.transform_rollout(g)
        acc = StatsAccumulator(m.nmap)
        acc.update(feats, feature_masks(g, feats))
        out[name] = {k: {s: float(v) for s, v in d.items()}
                     for k, d in acc.finalize().items()}
    return out


def _train_specs(data):
    weights = Config().training.loss_weights
    jax_model = dict(_spec(data, "FvgnA-banded", aggregation="segment"),
                     augment=False, loss_weights=weights)
    noisy = dict(_spec(data, "FluxD-plain", pushforward=True,
                       dropout_rate=DROPOUT), loss_weights=weights)
    jax_case = {"model": jax_model, "config": "jax", "window": 2, "epoch": 1,
                "lr": LR}
    noisy_case = {"model": noisy, "config": "noisy", "window": 4, "epoch": 2,
                  "lr": LR}
    return {"jax_1x2": dict(jax_case, starts=[[0]]),
            "jax_2x2": dict(jax_case, starts=[[0, 1]]),
            "noisy_1x2": dict(noisy_case, starts=[[1], [2]]),
            "noisy_2x2": dict(noisy_case, starts=[[1, 2], [2, 3]])}


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    """The 2-rank and the 4-rank groups, started once together: every
    scenario of ``torch_spmd_ranks``; returns ``load(scenario, world,
    rank)`` and the inputs they ran on."""
    work = tmp_path_factory.mktemp("spmd_ranks")
    inputs = {"geom": data["geom"], "fields": data["fields"],
              "mls": data["mls"], "ground_truth": data["gt"],
              "rollouts": {case: _spec(data, case, scale_init=None)
                           for case in ROLLOUTS},
              "configs": _configs(), "lr": LR, "dropout": DROPOUT}
    inputs["train"] = _train_specs(data)
    inputs["registry_stats"] = _registry_stats(inputs)
    torch.save(inputs, work / "inputs.pt")
    groups = {n: mp.spawn(rank_main, args=(n, str(work)), nprocs=n,
                          join=False) for n in (2, 4)}

    def load(scenario, world, rank=0):
        """What rank ``rank`` of ``world`` found (waiting for its group the
        first time, so that the JAX runs of the test process overlap the
        ranks)."""
        while not groups[world].join():
            pass
        return torch.load(work / f"{scenario}_{world}_rank{rank}.pt",
                          weights_only=False)
    yield load, inputs
    shutil.rmtree(work, ignore_errors=True)


def _port_graph(data, mls=False, **kw):
    window = {k: v[:2] for k, v in data["fields"].items()}
    if mls:
        window.update(data["mls"])
    return from_geometry(data["geom"], window, dt=0.01, pad_multiple=128,
                         device="cpu", **kw)


# ---- the partition ---------------------------------------------------------------

def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def parts(data):
    """The port's graph with MLS weights, and its 2- and 4-way partitions
    with each part's local graph (no process group: the halo's group is
    unused here)."""
    g = _port_graph(data, mls=True)
    out = {}
    for n in (2, 4):
        part = spmd.partition(g, n)
        out[n] = (part, [spmd.local_graph(g, part, s) for s in range(n)])
    return g, out


@pytest.mark.parametrize("n", [2, 4])
def test_partition_owns_every_live_row_once(parts, n):
    """The owned cells are contiguous ranges of the live cells, split
    evenly; every live cell and face is owned by exactly one rank, a face
    by its owner cell's; each local graph's masks mark its owned rows."""
    g, by_n = parts
    part, locals_ = by_n[n]
    for kind, mask in (("cell", g.cell_mask), ("face", g.face_mask)):
        counts = np.zeros(mask.shape[0], int)
        for s, lg in enumerate(locals_):
            own = _np(lg.halo.gid[kind])[_np(getattr(lg, f"{kind}_mask"))]
            assert np.all(part.owner[kind][own] == s)
            counts[own] += 1
        np.testing.assert_array_equal(counts, _np(mask).astype(int))
    sizes = [int(lg.cell_mask.sum()) for lg in locals_]
    assert max(sizes) - min(sizes) <= 1
    for lg in locals_:
        own = _np(lg.halo.gid["cell"])[_np(lg.cell_mask)]
        assert np.all(np.diff(own) == 1)
    cei = _np(g.cell_edge_index)
    live = _np(g.face_mask)
    np.testing.assert_array_equal(part.owner["face"][live],
                                  part.owner["cell"][cei[0][live]])


@pytest.mark.parametrize("n", [2, 4])
def test_partition_holds_every_row_its_owned_rows_read(parts, n):
    """Each local graph holds the faces and vertices of its owned cells,
    the cells on either side of those faces, every face at those vertices
    and the MLS stencils' rows, with the global row order; its index
    tables point at the same global rows (or, leaving the local rows, at
    the pad row, which holds zeros)."""
    g, by_n = parts
    _, locals_ = by_n[n]
    gcei, gfi, gvf = (_np(g.cell_edge_index), _np(g.face_index),
                      _np(g.vertex_face))
    gvei = _np(g.vertex_edge_index)
    for lg in locals_:
        gid = {k: _np(v) for k, v in lg.halo.gid.items()}
        n_live = {k: int((v != g_last).sum()) for (k, v), g_last in zip(
            gid.items(), (g.num_cells - 1, g.num_faces - 1,
                          g.num_vertices - 1))}
        held = {k: set(v[:n_live[k]]) for k, v in gid.items()}
        assert all(np.all(np.diff(v[:n_live[k]]) > 0) for k, v in gid.items())
        own = gid["cell"][_np(lg.cell_mask)]
        faces = set(gfi[:, own].ravel())
        verts = set(gvf[:, own].ravel())
        assert faces <= held["face"] and verts <= held["vertex"]
        assert set(gcei[:, sorted(faces)].ravel()) <= held["cell"]
        at_vertex = np.isin(gvei[0], list(verts)) | np.isin(gvei[1], list(verts))
        assert set(np.flatnonzero(at_vertex & _np(g.face_mask))) <= held["face"]
        assert set(_np(g.cell_grad_neighbours)[own].ravel()) <= held["cell"]
        assert (set(_np(g.face_grad_neighbours)[sorted(faces)].ravel())
                <= held["face"])
        # the tables on the local ids point at the same global rows
        lcei = _np(lg.cell_edge_index)[:, :n_live["face"]]
        pad_c = lg.num_cells - 1
        mapped = np.where(lcei == pad_c, -1, gid["cell"][lcei])
        want = gcei[:, gid["face"][:n_live["face"]]]
        assert np.all((mapped == want) | (mapped == -1))
        lfi = _np(lg.face_index)[:, _np(lg.cell_mask)]
        np.testing.assert_array_equal(gid["face"][lfi], gfi[:, own])
        # the pad rows hold zeros
        assert n_live["cell"] < lg.num_cells
        assert float(lg.cell_volume[n_live["cell"]:].abs().sum()) == 0
        assert float(lg.cell_velocity[n_live["cell"]:].abs().sum()) == 0
        assert float(lg.face_area[n_live["face"]:].abs().sum()) == 0
        assert len({lg.num_cells, lg.num_faces, lg.num_vertices}) == 3


@pytest.mark.parametrize("n", [2, 4])
def test_local_csr_lists_the_global_half_rows_in_order(parts, n):
    """At every vertex of an owned cell, the local vertex CSR lists the
    global graph's half-rows of that vertex (senders' halves, then
    receivers', each in face order), in the global order."""
    g, by_n = parts
    _, locals_ = by_n[n]
    gptr, grow = _np(g.vertex_inc_ptr), _np(g.vertex_inc_row)
    for lg in locals_:
        ptr, row = _np(lg.vertex_inc_ptr), _np(lg.vertex_inc_row)
        fgid, vgid = _np(lg.halo.gid["face"]), _np(lg.halo.gid["vertex"])
        for v in np.unique(_np(lg.vertex_face)[:, _np(lg.cell_mask)]):
            local = row[ptr[v]:ptr[v + 1]]
            mapped = 2 * fgid[local // 2] + local % 2
            gv = vgid[v]
            np.testing.assert_array_equal(mapped, grow[gptr[gv]:gptr[gv + 1]])


@pytest.mark.parametrize("n", [2, 4])
def test_cut_faces_keep_their_type(parts, n):
    """A face whose cells lie on two ranks keeps its interior type and is
    no boundary face on either rank; geometry, signs and slots are the
    global graph's rows."""
    g, by_n = parts
    part, locals_ = by_n[n]
    cei = _np(g.cell_edge_index)
    live = _np(g.face_mask)
    cut = live & (part.owner["cell"][cei[0]] != part.owner["cell"][cei[1]])
    assert cut.sum() > 0
    for lg in locals_:
        fgid = _np(lg.halo.gid["face"])
        n_live = int((fgid != g.num_faces - 1).sum())
        rows = fgid[:n_live]
        here = cut[rows]
        assert here.any()
        np.testing.assert_array_equal(_np(lg.face_type)[:n_live],
                                      _np(g.face_type)[rows])
        assert not _np(lg.face_boundary_mask)[:n_live][here].any()
        for key in ("face_normal", "face_area", "owner_local_slot"):
            np.testing.assert_array_equal(_np(getattr(lg, key))[:n_live],
                                          _np(getattr(g, key))[rows])
        cgid = _np(lg.halo.gid["cell"])
        nc = int((cgid != g.num_cells - 1).sum())
        np.testing.assert_array_equal(_np(lg.cell_face_sign)[:nc],
                                      _np(g.cell_face_sign)[cgid[:nc]])


def test_mismatched_stack_length_raises(data):
    """A stack of graphs whose length is not the layout's data extent
    raises, as ``test_spmd_rejects_mismatched_stack_length``."""
    mesh = spmd.Mesh2D(n_data=2, n_space=2, data_index=0, space_index=0,
                       space_group=None)
    with pytest.raises(ValueError, match="n_data=2"):
        spmd.shard_spatial_batch([_port_graph(data)], mesh)


def test_local_graphs_are_not_batched(parts):
    """``batch_graphs`` refuses a rank's local graph: a batch is sharded
    whole."""
    _, by_n = parts
    with pytest.raises(ValueError, match="shard the batch"):
        batch_graphs(by_n[2][1])


# ---- the sharded rollouts --------------------------------------------------------

def _live(graph, key, v):
    mask = graph.face_mask if key.startswith("face") else graph.cell_mask
    return v[mask] if key == "final_cell_state" else v[:, mask]


def _single_rollout(data, spec, gt=True):
    g = _port_graph(data, mls=spec["name"] == "MgnA")
    m = build_model(spec)
    _, feats = m.transform_rollout(g)
    truth = [torch.from_numpy(x) for x in data["gt"]] if gt else (None, None)
    return g, engine.rollout_scan(m, g, feats, *truth, engine.RolloutConfig(
        num_steps=STEPS, compute_error=gt, save_fields=True))


@pytest.fixture(scope="module")
def jax_rollouts(data):
    """Per case, the JAX package's single-device rollout (with the error
    metrics) and its ``make_spmd_rollout`` on 2 and 4 host devices."""
    out = {}
    for case, (jm, g, feats, variables, _) in data["models"].items():
        cfg = jax_engine.RolloutConfig(num_steps=STEPS, compute_error=True,
                                       save_fields=True)
        gt = data["gt"]
        errors, _ = jax.jit(lambda v, g_, f: jax_engine.rollout_scan(
            jm, v, g_, f, gt[0], gt[1], cfg))(variables, g, feats)
        sharded = {}
        for n in (2, 4):
            mesh = make_mesh_spatial(n)
            _, fields = make_spmd_rollout(jm, jax_engine.RolloutConfig(
                num_steps=STEPS, compute_error=False, save_fields=True))(
                replicate_2d(variables, mesh), shard_graph_spatial(g, mesh),
                feats)
            sharded[n] = jax.device_get(fields)
        out[case] = (jax.device_get(errors), sharded)
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", list(ROLLOUTS))
def test_sharded_rollout_matches_jax(data, ranks, jax_rollouts, case, world):
    """The 1 x ``world`` rollout against the JAX package's
    ``make_spmd_rollout`` on ``world`` host devices (fields) and its
    single-device rollout (metrics): within F32_TOL of each field's largest
    magnitude on the plain route, BF16_TOL on the kernel route."""
    load, _ = ranks
    got = load("rollouts", world)[case]
    want_errors, sharded = jax_rollouts[case]
    tol = BF16_TOL if ROLLOUTS[case][1] == "pallas" else F32_TOL
    g = _port_graph(data)
    for key, v in sharded[world].items():
        a = _live(g, key, got["fields"][key]).numpy()
        b = _live(g, key, torch.from_numpy(np.array(v))).numpy()
        assert np.abs(a - b).max() <= tol * np.abs(b).max(), key
    for key, v in want_errors.items():
        np.testing.assert_allclose(got["errors"][key].numpy(), np.asarray(v),
                                   rtol=tol, atol=tol * float(np.abs(v).max()),
                                   err_msg=key)




@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", list(ROLLOUTS))
def test_sharded_rollout_equals_the_single_process(data, ranks, case, world):
    """The 1 x ``world`` rollout's gathered fields equal the single
    process's on the live rows bit for bit, its metrics within
    METRIC_RTOL; it refreshed EXCHANGES_PER_STEP row sets a step."""
    load, inputs = ranks
    got = load("rollouts", world)[case]
    g, (errors, fields) = _single_rollout(data, inputs["rollouts"][case])
    assert set(got["fields"]) == set(fields)
    for key, v in fields.items():
        assert torch.equal(_live(g, key, got["fields"][key]),
                           _live(g, key, v)), key
    for key, v in errors.items():
        np.testing.assert_allclose(got["errors"][key].numpy(), v.numpy(),
                                   rtol=METRIC_RTOL, err_msg=key)
    name = ROLLOUTS[case][0]
    assert got["exchanges"] == EXCHANGES_PER_STEP[name] * STEPS
    assert got["bytes"] > 0


# ---- the exchange ----------------------------------------------------------------

@pytest.fixture
def one_rank(tmp_path):
    data_parallel.init_process_group(
        "cpu", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1)
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


def test_exchange_backward_passes_gradcheck(one_rank):
    """The exchange's autograd function in f64 under ``gradcheck``, on a
    group of one rank whose halo sends rows 0, 2, 5 (row 5 twice) into rows
    7, 3, 1, 4: the forward a row copy, the backward its transpose (the
    ghost rows' gradients added to their owners', the ghost rows zero)."""
    send = torch.tensor([0, 2, 5, 5])
    recv = torch.tensor([7, 3, 1, 4])
    h = halo.Halo(group=None, n_space=1, space_rank=0,
                  gid={"cell": torch.arange(8)}, global_rows={"cell": 8},
                  send_rows={"cell": send}, send_splits={"cell": [4]},
                  recv_rows={"cell": recv}, recv_splits={"cell": [4]},
                  live_faces=torch.ones(0, dtype=torch.bool))
    x = torch.randn(8, 3, dtype=torch.float64, requires_grad=True)
    y = halo._Exchange.apply(x, h, "cell")
    assert torch.equal(y[recv], x[send]) and torch.equal(y[6], x[6])
    assert torch.autograd.gradcheck(
        lambda t: halo._Exchange.apply(t, h, "cell"), (x,))
    (g,) = torch.autograd.grad(halo._Exchange.apply(x, h, "cell"), x,
                               torch.ones(8, 3, dtype=torch.float64))
    # a sent row keeps its own gradient and gains its copies'; a ghost row
    # gets none
    np.testing.assert_array_equal(g[:, 0].numpy(),
                                  [2, 0, 2, 0, 0, 3, 1, 0])


@pytest.mark.parametrize("world", [2, 4])
def test_exchange_refreshes_ghosts_and_its_backward_is_its_transpose(ranks,
                                                                      world):
    """On the mesh's partition, scrambled ghost rows come back as their
    owners' rows, bit for bit, the other rows untouched; and <E x, y> =
    <x, E^T y> over all ranks, in f64."""
    load, _ = ranks
    for r in range(world):
        got = load("adjoint", world, r)
        for kind in ("cell", "face"):
            assert got[f"{kind}_ghosts"] > 0
            assert got[f"{kind}_forward_equal"], (r, kind)
            ex_y, x_ety = got[f"{kind}_adjoint"]
            assert abs(ex_y - x_ety) <= 1e-12 * max(abs(ex_y), 1.0)


# ---- the train step --------------------------------------------------------------

def _gap(got, want):
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    return err / scale if scale else (0.0 if err == 0 else float("inf"))


def _jax_spmd_step(data, n_data, n_space):
    """One step of the JAX package's ``make_spmd_train_step`` of FvgnA on
    an ``n_data`` x ``n_space`` host mesh, data row d on the window from
    state d, no noise or flip: the losses and the state after it."""
    jm, _, _, variables, _ = data["models"]["FvgnA-banded"]
    jm = jax_model_class("FvgnA")(JaxModelConfig(
        name="FvgnA", hidden_width=HIDDEN, mp_num=MP, aggregation="segment"),
        loss_weights=JaxConfig().training.loss_weights)
    jm.set_stats(data["models"]["FvgnA-banded"][0].stats)
    jcfg = JaxConfig()
    jcfg.training.noise_std = 0.0
    optimizer = jax_trainer.select_optimizer(jcfg)
    jds = jax_pipeline.MeshDataset([jax_pipeline.Trajectory(
        mesh_id="m0", geom=data["geom"], fields=dict(data["fields"]))],
        pad_multiple=128)
    g0 = jds.get_batch([("m0", 0)])
    state = jax_trainer.Trainer(jcfg, jm, optimizer=optimizer).init_state(
        jax.random.PRNGKey(0), g0, jm.transform_features(g0, None,
                                                         mode="rollout")[1])
    # host copies: the step donates the state it is given
    variables = jax.tree.map(np.array, dict(variables))
    state = state.replace(params=variables["params"],
                          batch_stats=variables.get("batch_stats", {}),
                          opt_state=optimizer.init(variables["params"]))

    class NoAugment:
        def __getattr__(self, k):
            return getattr(jm, k)

        def transform_features(self, graph, rng, mode="train", noise_std=0.0):
            return jm.transform_features(graph, None, mode="rollout")

    mesh = make_mesh_2d(n_data, n_space)
    step = make_spmd_train_step(NoAugment(), optimizer, mesh, noise_std=0.0)
    graphs = shard_spatial_batch([jds.get_batch([("m0", d)])
                                  for d in range(n_data)], mesh)
    state, losses = step(replicate_2d(state, mesh), graphs, LR)
    state = jax.device_get(state)
    return jax.device_get(losses), state


def _moments_from_optax(opt_state, module):
    cfg = Config()
    return optimizer_state_from_optax(
        _as_tree(opt_state), trainer.select_optimizer(cfg, module.parameters()),
        module)["state"]


def _as_tree(x):
    if hasattr(x, "_asdict"):
        return {k: _as_tree(v) for k, v in x._asdict().items()}
    if isinstance(x, (list, tuple)):
        return [_as_tree(v) for v in x]
    if isinstance(x, dict) or hasattr(x, "items"):
        return {k: _as_tree(v) for k, v in x.items()}
    return np.asarray(x)


@pytest.mark.parametrize("layout", ["1x2", "2x2"])
def test_train_step_matches_jax_spmd_step(data, ranks, layout):
    """The ``layout`` step of FvgnA (its BatchNorm's statistics summed over
    the space group) against JAX's ``make_spmd_train_step`` on the same
    host layout: losses, AdamW's moments and the parameters and running
    statistics."""
    load, inputs = ranks
    n_data, n_space = (int(x) for x in layout.split("x"))
    world = n_data * n_space
    got = load(f"jax_{layout}", world)
    for r in range(1, world):
        other = load(f"jax_{layout}", world, r)
        assert all(torch.equal(other["state"][k], v)
                   for k, v in got["state"].items())
    want_losses, state = _jax_spmd_step(data, n_data, n_space)
    for k, v in want_losses.items():
        assert abs(float(got["losses"][0][k]) - float(v)) <= (
            F32_TOL * abs(float(v))), k
    want = params_from_flax({"params": state.params,
                             "batch_stats": state.batch_stats})
    assert any("running_mean" in k for k in want)
    for k, v in want.items():
        np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    module = build_model(inputs["train"][f"jax_{layout}"]["model"]).module
    for i, st in _moments_from_optax(state.opt_state, module).items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert _gap(got["moments"][i][key], st[key]) <= MOMENT_RTOL, (
                i, key)


def _close_steps(got, want):
    """Losses within F32_TOL, AdamW's moments within MOMENT_RTOL. The
    parameters are not held: an AdamW step moves an element by about lr
    whatever its gradient, so the moments are what see the gradients."""
    for a, b in zip(got["losses"], want["losses"]):
        assert set(a) == set(b)
        for k in b:
            assert abs(float(a[k]) - float(b[k])) <= F32_TOL * abs(
                float(b[k])), k
    for i, st in want["moments"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert _gap(got["moments"][i][key], st[key]) <= MOMENT_RTOL, (
                i, key)


def test_noisy_pushforward_step_1x2_equals_train_step(ranks):
    """FluxD with noise, the edge flip, dropout and a pushforward unroll of
    2: two 1 x 2 steps equal two ``train_step``s of the single process
    from the same weights and seed (the draws made at the global row
    count, each rank taking its rows)."""
    load, inputs = ranks
    spec = inputs["train"]["noisy_1x2"]
    ds = pipeline.MeshDataset([pipeline.Trajectory(
        mesh_id="m0", geom=inputs["geom"], fields=dict(inputs["fields"]))],
        data_window=spec["window"], pad_multiple=128, device="cpu")
    tr = trainer.Trainer(copy.deepcopy(inputs["configs"]["noisy"]),
                         build_model(spec["model"]))
    tr.epoch_count = spec["epoch"]
    state = tr.init_state()
    losses = [tr.train_step(state, ds.get_batch([("m0", t)]), spec["lr"])
              for (t,) in spec["starts"]]
    for r in (0, 1):
        _close_steps(load("noisy_1x2", 2, r), train_result(state, losses))


def test_noisy_2x2_step_equals_dp_step(ranks):
    """Two 2 x 2 steps (each data row's space ranks on its own window) equal
    two ``dp_train_step``s on 2 ranks, rank r on data row r's windows; the
    4 replicas are equal bit for bit."""
    load, _ = ranks
    want = load("dp", 2)
    got = [load("noisy_2x2", 4, r) for r in range(4)]
    for other in got[1:]:
        assert all(torch.equal(other["state"][k], v)
                   for k, v in got[0]["state"].items())
    _close_steps(got[0], want)


# ---- every registered name -------------------------------------------------------

@pytest.fixture(scope="module")
def registry_single(ranks):
    """Each registered name's single-process runs of the registry case."""
    _, inputs = ranks
    g = port_graph(inputs, window=3, mls=True)
    out = {}
    for name in sorted(MODEL_REGISTRY):
        res = {}
        for aggregation in ("pallas", "segment"):
            m = build_model(registry_spec(inputs, name, aggregation))
            k = int(m.config.bundle_size or 1)
            _, feats = m.transform_rollout(g)
            res[aggregation] = engine.rollout_scan(
                m, g, feats, config=engine.RolloutConfig(
                    num_steps=2 * k, compute_error=False, save_fields=True))[1]
        tr = trainer.Trainer(copy.deepcopy(inputs["configs"]["registry"]),
                             build_model(registry_spec(inputs, name, "segment",
                                                       train=True)))
        state = tr.init_state()
        losses = tr.train_step(state, g, inputs["lr"])
        res["losses"] = losses
        res["moments"] = state.optimizer.state_dict()["state"]
        out[name] = res
    return g, out


@pytest.mark.parametrize("name", sorted(MODEL_REGISTRY))
def test_every_name_matches_the_single_process(ranks, registry_single,
                                               name):
    """On 1 x 2, every registered name: the rollout on the kernel and the
    plain route, bit for bit on the live rows, and a train step with
    noise, flip and dropout (losses and gradients within F32_TOL), each
    against the single process."""
    load, _ = ranks
    got = load("registry", 2)[name]
    assert "error" not in got, got.get("error")
    g, singles = registry_single
    want = singles[name]
    for aggregation in ("pallas", "segment"):
        for key, v in want[aggregation].items():
            assert torch.equal(_live(g, key, got[aggregation][key]),
                               _live(g, key, v)), (aggregation, key)
    losses = got["train"]["losses"]
    for k, v in want["losses"].items():
        assert abs(float(losses[k]) - float(v)) <= F32_TOL * max(
            abs(float(v)), 1e-30), k
    largest = max(float(st["exp_avg"].abs().max())
                  for st in want["moments"].values())
    for i, st in want["moments"].items():
        err = float((got["train"]["moments"][i]["exp_avg"]
                     - st["exp_avg"]).abs().max())
        assert err <= F32_TOL * largest, (i, err, largest)
