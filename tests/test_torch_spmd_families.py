"""Space sharding of the Conservative family, FvgnK and VertPotG
(``parallel/spmd.py``) on the CPU with gloo, in a 2-rank and a 4-rank group
of processes (``torch.multiprocessing`` on ``tests/torch_spmd_ranks.py``'s
``families_main``), against the port's single process and the JAX
package's ``make_spmd_rollout`` / ``make_spmd_train_step`` on the
conftest's host devices; and the two reductions over the whole graph that
FvgnK and VertPotG read: the first INFLOW face (``halo.first_owned``) and
the last-write face flux conversion
(``fvm.cell_flux_to_face_flux_lastwrite_g``).

The mesh is ``test_torch_spmd.py``'s (the RCM-ordered 300-point cylinder,
518 cells, its channel flow, order-1 MLS weights at cells and faces); the
models hidden 16, 2 blocks, f32, weights from the JAX package's seeded
init, statistics from the mesh.

Tolerances:

* a sharded rollout (1 x 2 and 1 x 4) against the port's single process,
  on the plain and the kernel route (on the CPU each kernel wrapper runs
  its plain version): the fields bit for bit on the live rows, the metrics
  within METRIC_RTOL (sums of per-rank partial sums);
* against the JAX package's ``make_spmd_rollout`` on 2 host devices (the
  plain route), STEPS free-running steps: each field within ROLLOUT_TOL of
  its largest magnitude (``test_torch_conservative.py``'s rollout bound
  for the family), ConservativeJ's within J_ROLLOUT_TOL (its physical
  integrator scales the face terms by dt/V: free-running f32 roundings
  part the two packages' single processes by 3.0e-4 of its largest face
  pressure after 5 steps, and the sharded runs as far); the metrics
  against JAX's single-device rollout within the same bound, but
  VertPotG's ``divergence_raw_error``, the rounding noise of an exact
  zero (a telescoping sum), which must lie below RAW_NOISE on both;
* a train step without noise, flip or dropout against JAX's
  ``make_spmd_train_step`` on the same layout (1 x 2 for every name; 2 x 2
  for ConservativeA, the shipped recipe's, and VertPotG): losses within
  F32_TOL, AdamW's moments within MOMENT_RTOL of each tensor's largest
  magnitude plus F32_TOL of the model's largest (the gradient of
  VertPot's vertex decoder bias vanishes in exact arithmetic, the
  potential entering by differences, and holds rounding noise alone);
  the 1 x 2 step also against the port's ``train_step``: losses
  within F32_TOL, the first moment within F32_TOL of the model's largest
  (``test_torch_spmd.py``'s registry bound);
* FvgnK's u_ref and l_ref, ``first_owned``'s value and VertPotG's converted
  flux: bit for bit against the single process; the conversion's gradient
  within 1e-12 of the largest (f64, sums over the ranks in another order).
"""

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
import copy
import shutil

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from torch_spmd_ranks import STEPS, build_model, families_main
from torch_spmd_ranks import graph as port_graph

from gnn_fluid_dynamics_tpu.data.synthetic import (channel_flow_trajectory,
                                                   make_geometry)
from gnn_fluid_dynamics_tpu.graph import from_geometry as jax_from_geometry
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

from gnn_fluid_dynamics_tpu_torch.data.node_types import NodeType
from gnn_fluid_dynamics_tpu_torch.graph import batch_graphs
from gnn_fluid_dynamics_tpu_torch.ops import fvm
from gnn_fluid_dynamics_tpu_torch.parallel import spmd
from gnn_fluid_dynamics_tpu_torch.rollout import engine
from gnn_fluid_dynamics_tpu_torch.training import trainer
from gnn_fluid_dynamics_tpu_torch.training.config import Config
from gnn_fluid_dynamics_tpu_torch.weights import params_from_flax

HIDDEN, MP = 16, 2
LR = 1e-3
METRIC_RTOL = 1e-5
F32_TOL = 1e-5
ROLLOUT_TOL = 1e-4
J_ROLLOUT_TOL = 5e-4
RAW_NOISE = 1e-12
MOMENT_RTOL = 1e-4
NAMES = ("ConservativeA", "ConservativeB", "ConservativeD", "ConservativeE",
         "ConservativeF", "ConservativeG", "ConservativeH", "ConservativeI",
         "ConservativeJ", "ConservativeK", "FvgnK", "VertPotG")
ROUTES = ("segment", "pallas")
STEPS_2X2 = ("ConservativeA", "VertPotG")


def _jax_graph(geom, fields, mls, start=0):
    window = {k: v[start:start + 2] for k, v in fields.items()}
    window.update(mls)
    return jax_from_geometry(geom, window, dt=0.01, pad_multiple=128)


@pytest.fixture(scope="module")
def data():
    """The mesh (geometry, STEPS + 2 states, MLS weights, ground truth) and
    per name the JAX model on the plain route, its statistics and its
    variables."""
    geom = rcm_reorder_geometry(make_geometry("cylinder", n_points=300, seed=0))
    fields = channel_flow_trajectory(geom, num_timesteps=STEPS + 2, dt=0.01)
    mls = {}
    for loc in ("cell", "face"):
        nb, w = compute_mls_weights(geom[f"{loc}_pos"], 1)
        mls[f"{loc}_grad_weights"], mls[f"{loc}_grad_neighbours"] = w, nb
    pad = ((0, 0), (0, 640 - geom["cell_pos"].shape[0]), (0, 0))
    gt = [np.pad(fields[k][1:STEPS + 1], pad).astype(np.float32)
          for k in ("cell_velocity", "cell_pressure")]
    jg = _jax_graph(geom, fields, mls)
    weights = JaxConfig().training.loss_weights
    models = {}
    for name in NAMES:
        jm = jax_model_class(name)(JaxModelConfig(
            name=name, hidden_width=HIDDEN, mp_num=MP, aggregation="segment"),
            loss_weights=weights)
        _, feats = jm.transform_rollout(jg)
        acc = JaxStatsAccumulator(jm.nmap)
        acc.update(feats, jax_masks(jg, feats))
        stats = acc.finalize()
        jm.set_stats(stats)
        variables = jm.init(jax.random.PRNGKey(0), jg, feats)
        models[name] = (jm, feats, variables, {
            k: {s: float(v) for s, v in d.items()} for k, d in stats.items()})
    return {"geom": geom, "fields": fields, "mls": mls, "gt": gt,
            "jax_graph": jg, "models": models}


def _spec(data, name, aggregation, **extra):
    _, _, variables, stats = data["models"][name]
    return {"name": name, "stats": stats,
            "config": {"hidden_width": HIDDEN, "mp_num": MP,
                       "aggregation": aggregation},
            "state_dict": params_from_flax(variables), **extra}


def _jax_config():
    cfg = Config()
    cfg.training.noise_std = 0.0
    cfg.training.pushforward_factor = 0
    cfg.training.lr_max = LR
    return {"jax": cfg}


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    """The 2-rank and the 4-rank groups of ``families_main``, started once
    together; returns ``load(scenario, world, rank)`` and the inputs."""
    work = tmp_path_factory.mktemp("spmd_families")
    weights = Config().training.loss_weights
    inputs = {"geom": data["geom"], "fields": data["fields"],
              "mls": data["mls"], "ground_truth": data["gt"],
              "families": {f"{name}-{route}": _spec(data, name, route)
                           for name in NAMES for route in ROUTES},
              "family_steps": {name: _spec(data, name, "segment",
                                           augment=False,
                                           loss_weights=weights)
                               for name in NAMES},
              "fvgnk": _spec(data, "FvgnK", "segment"),
              "configs": _jax_config(), "lr": LR}
    torch.save(inputs, work / "inputs.pt")
    groups = {n: mp.spawn(families_main, args=(n, str(work)), nprocs=n,
                          join=False) for n in (2, 4)}

    def load(scenario, world, rank=0):
        while not groups[world].join():
            pass
        return torch.load(work / f"{scenario}_{world}_rank{rank}.pt",
                          weights_only=False)
    yield load, inputs
    shutil.rmtree(work, ignore_errors=True)


def _live(graph, key, v):
    mask = graph.face_mask if key.startswith("face") else graph.cell_mask
    return v[mask] if key == "final_cell_state" else v[:, mask]


# ---- rollouts ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def singles(ranks):
    """Per name and route, the port's single-process rollout."""
    _, inputs = ranks
    g = port_graph(inputs, mls=True)
    gt = [torch.from_numpy(x) for x in inputs["ground_truth"]]
    out = {}
    for case, spec in inputs["families"].items():
        m = build_model(spec)
        _, feats = m.transform_rollout(g)
        out[case] = engine.rollout_scan(m, g, feats, *gt, engine.RolloutConfig(
            num_steps=STEPS, compute_error=True, save_fields=True))
    return g, out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", NAMES)
def test_sharded_rollout_equals_the_single_process(ranks, singles, name,
                                                   world):
    """The 1 x ``world`` rollout on the plain and the kernel route against
    the single process's: the fields bit for bit on the live rows, the
    metrics within METRIC_RTOL."""
    load, _ = ranks
    g, want = singles
    for route in ROUTES:
        got = load("rollouts", world)[f"{name}-{route}"]
        errors, fields = want[f"{name}-{route}"]
        assert set(got["fields"]) == set(fields)
        for key, v in fields.items():
            assert torch.equal(_live(g, key, got["fields"][key]),
                               _live(g, key, v)), (route, key)
        for key, v in errors.items():
            np.testing.assert_allclose(got["errors"][key].numpy(), v.numpy(),
                                       rtol=METRIC_RTOL, err_msg=key)
        assert got["exchanges"] > 0


@pytest.fixture(scope="module")
def jax_rollouts(data):
    """Per name, the JAX package's single-device rollout (with the metrics)
    and its ``make_spmd_rollout`` on 2 host devices."""
    jg, gt = data["jax_graph"], data["gt"]
    out = {}
    for name, (jm, feats, variables, _) in data["models"].items():
        cfg = jax_engine.RolloutConfig(num_steps=STEPS, compute_error=True,
                                       save_fields=True)
        errors, _ = jax.jit(lambda v, g_, f: jax_engine.rollout_scan(
            jm, v, g_, f, gt[0], gt[1], cfg))(variables, jg, feats)
        mesh = make_mesh_spatial(2)
        _, fields = make_spmd_rollout(jm, jax_engine.RolloutConfig(
            num_steps=STEPS, compute_error=False, save_fields=True))(
            replicate_2d(variables, mesh), shard_graph_spatial(jg, mesh),
            feats)
        out[name] = (jax.device_get(errors), jax.device_get(fields))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_sharded_rollout_matches_jax(ranks, singles, jax_rollouts, name):
    """The 1 x 2 rollout on the plain route against the JAX package's
    ``make_spmd_rollout`` on 2 host devices (fields) and its single-device
    rollout (metrics), as the module's docstring says."""
    load, _ = ranks
    g, _ = singles
    got = load("rollouts", 2)[f"{name}-segment"]
    want_errors, fields = jax_rollouts[name]
    tol = J_ROLLOUT_TOL if name == "ConservativeJ" else ROLLOUT_TOL
    for key, v in fields.items():
        a = _live(g, key, got["fields"][key]).numpy()
        b = _live(g, key, torch.from_numpy(np.array(v))).numpy()
        assert np.abs(a - b).max() <= tol * np.abs(b).max(), key
    for key, v in want_errors.items():
        if key == "divergence_raw_error":
            assert float(np.abs(v).max()) <= RAW_NOISE
            assert float(got["errors"][key].abs().max()) <= RAW_NOISE
            continue
        np.testing.assert_allclose(got["errors"][key].numpy(), np.asarray(v),
                                   rtol=tol,
                                   atol=tol * float(np.abs(v).max()),
                                   err_msg=key)


# ---- train steps -------------------------------------------------------------------

def _gap(got, want):
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    return err / scale if scale else (0.0 if err == 0 else float("inf"))


def _as_tree(x):
    if hasattr(x, "_asdict"):
        return {k: _as_tree(v) for k, v in x._asdict().items()}
    if isinstance(x, (list, tuple)):
        return [_as_tree(v) for v in x]
    if isinstance(x, dict) or hasattr(x, "items"):
        return {k: _as_tree(v) for k, v in x.items()}
    return np.asarray(x)


def _jax_spmd_step(data, name, n_data, n_space):
    """One step of JAX's ``make_spmd_train_step`` of ``name`` on an
    ``n_data`` x ``n_space`` host layout, data row d on the window from
    state d, no noise or flip: the losses and the state after it."""
    jm, feats, variables, _ = data["models"][name]
    jcfg = JaxConfig()
    jcfg.training.noise_std = 0.0
    optimizer = jax_trainer.select_optimizer(jcfg)
    g0 = data["jax_graph"]
    state = jax_trainer.Trainer(jcfg, jm, optimizer=optimizer).init_state(
        jax.random.PRNGKey(0), g0, feats)
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
    graphs = shard_spatial_batch(
        [_jax_graph(data["geom"], data["fields"], data["mls"], start=d)
         for d in range(n_data)], mesh)
    state, losses = step(replicate_2d(state, mesh), graphs, LR)
    return jax.device_get(losses), jax.device_get(state)


def _adam(tree):
    """The optax state's Adam moments (the mapping holding ``mu``)."""
    if isinstance(tree, dict):
        if "mu" in tree:
            return tree
        tree = list(tree.values())
    if isinstance(tree, list):
        for sub in tree:
            found = _adam(sub)
            if found is not None:
                return found
    return None


def _moments(opt_state, module):
    """JAX's moments per index of the port's optimizer state, named
    through ``params_from_flax`` (the trees are the parameters')."""
    adam = _adam(_as_tree(opt_state))
    mu, nu = (params_from_flax(adam[k]) for k in ("mu", "nu"))
    names = {id(p): n for n, p in module.named_parameters()}
    order = [names[id(p)] for group in trainer.select_optimizer(
        Config(), module.parameters()).param_groups for p in group["params"]]
    return {i: {"exp_avg": mu[n], "exp_avg_sq": nu[n]}
            for i, n in enumerate(order)}


def _held_to_jax(got, want_losses, state, module):
    for k, v in want_losses.items():
        assert abs(float(got["losses"][k]) - float(v)) <= (
            F32_TOL * abs(float(v))), k
    want = _moments(state.opt_state, module)
    assert len(want) == len(got["moments"])
    for key in ("exp_avg", "exp_avg_sq"):
        largest = max(float(st[key].abs().max()) for st in want.values())
        for i, st in want.items():
            err = float((got["moments"][i][key] - st[key]).abs().max())
            assert err <= (MOMENT_RTOL * float(st[key].abs().max())
                           + F32_TOL * largest), (i, key, err)


@pytest.mark.parametrize("name", NAMES)
def test_train_step_1x2_matches_jax_and_the_single_process(data, ranks, name):
    """The 1 x 2 step against JAX's ``make_spmd_train_step`` on 1 x 2 host
    devices (losses, moments) and against the port's ``train_step`` on
    the whole window (losses, the first moment); both ranks' replicas
    equal bit for bit."""
    load, inputs = ranks
    got = load("steps", 2)[name]
    other = load("steps", 2, 1)[name]
    assert all(torch.equal(other["state"][k], v)
               for k, v in got["state"].items())
    spec = inputs["family_steps"][name]
    module = build_model(spec).module
    _held_to_jax(got, *_jax_spmd_step(data, name, 1, 2), module)
    cfg = copy.deepcopy(inputs["configs"]["jax"])
    tr = trainer.Trainer(cfg, build_model(spec))
    tr.epoch_count = 1
    state = tr.init_state()
    losses = tr.train_step(state, port_graph(inputs, mls=True), LR)
    for k, v in losses.items():
        assert abs(float(got["losses"][k]) - float(v)) <= F32_TOL * max(
            abs(float(v)), 1e-30), k
    moments = state.optimizer.state_dict()["state"]
    largest = max(float(st["exp_avg"].abs().max()) for st in moments.values())
    for i, st in moments.items():
        err = float((got["moments"][i]["exp_avg"] - st["exp_avg"]).abs().max())
        assert err <= F32_TOL * largest, (i, err, largest)


@pytest.mark.parametrize("name", STEPS_2X2)
def test_train_step_2x2_matches_jax(data, ranks, name):
    """The 2 x 2 step (each data row's space ranks on its own window)
    against JAX's ``make_spmd_train_step`` on 2 x 2 host devices; the 4
    replicas equal bit for bit."""
    load, inputs = ranks
    got = [load("steps", 4, r)[name] for r in range(4)]
    for other in got[1:]:
        assert all(torch.equal(other["state"][k], v)
                   for k, v in got[0]["state"].items())
    module = build_model(inputs["family_steps"][name]).module
    _held_to_jax(got[0], *_jax_spmd_step(data, name, 2, 2), module)


# ---- FvgnK's first INFLOW face ---------------------------------------------------

def _refs_single(inputs, case, world):
    """The single process's u_ref and l_ref for ``first_inflow``'s case."""
    g = port_graph(inputs)
    part = spmd.partition(g, world)
    inflow = g.face_type.reshape(-1) == NodeType.INFLOW
    no_inflow = g.replace(face_type=torch.where(
        inflow[:, None], torch.full_like(g.face_type, NodeType.NORMAL),
        g.face_type))
    if case == "batch":
        g = batch_graphs([g, no_inflow])
    elif case == "none":
        g = no_inflow
    else:
        owner = torch.from_numpy(part.owner["face"])
        g = g.replace(face_type=torch.where(
            (inflow & (owner != case))[:, None],
            torch.full_like(g.face_type, NodeType.NORMAL), g.face_type))
    model = build_model(inputs["fvgnk"])
    _, feats = model.transform_rollout(g)
    return g, model._refs(g, feats)


@pytest.mark.parametrize("world", [2, 4])
def test_fvgnk_reference_is_the_whole_graphs(ranks, world):
    """FvgnK's u_ref and l_ref on every rank's owned faces equal the single
    process's, bit for bit: with the mesh's INFLOW faces only where rank t
    owns them, for each t in turn (the others find none of their own and
    take rank t's), with none (u_ref 1), and on a batch of the mesh and
    its copy without INFLOW faces (per graph)."""
    load, inputs = ranks
    for case in list(range(world)) + ["none", "batch"]:
        g, (u, l_) = _refs_single(inputs, case, world)
        if case == "none":
            assert torch.equal(u, torch.ones_like(u))
        if case == "batch":
            assert not torch.equal(u[:g.num_faces // 2], torch.ones_like(
                u[:g.num_faces // 2]))
            assert torch.equal(u[g.num_faces // 2:],
                               torch.ones_like(u[g.num_faces // 2:]))
        seen = 0
        for r in range(world):
            got = load("first_inflow", world, r)[case]
            ids = got["ids"].long()
            assert torch.equal(got["u_ref"], u[ids]), (case, r)
            assert torch.equal(got["l_ref"], l_[ids]), (case, r)
            seen += len(ids)
        assert seen == int(g.face_mask.sum())


@pytest.mark.parametrize("world", [2, 4])
def test_first_owned_takes_the_least_global_id(ranks, world):
    """``halo.first_owned`` of random f64 values at the INFLOW faces: every
    rank holds the value of the INFLOW face of least global id, exactly."""
    load, inputs = ranks
    g = port_graph(inputs)
    values = torch.randn(g.num_faces, dtype=torch.float64,
                         generator=torch.Generator().manual_seed(5))
    first = int(torch.nonzero((g.face_type.reshape(-1) == NodeType.INFLOW)
                                  & g.face_mask)[0])
    for r in range(world):
        got = load("first_inflow", world, r)["random"]
        assert got["found"].tolist() == [True]
        assert got["value"].tolist() == [float(values[first])]


# ---- VertPotG's last write -------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_lastwrite_conversion_equals_the_single_process(ranks, world):
    """The converted face flux of random f64 cell fluxes on every rank's
    owned faces equals the single process's, bit for bit, faces whose two
    cells lie on different ranks among them; the gradient of the owned
    faces' weighted sum at each rank's owned cells equals the whole
    graph's, within 1e-12."""
    load, inputs = ranks
    g = port_graph(inputs)
    gen = torch.Generator().manual_seed(11)
    cf = torch.randn((g.num_cells, 3), dtype=torch.float64, generator=gen)
    cf[~g.cell_mask] = cf[-1].clone()
    w = torch.randn((g.num_faces, 1), dtype=torch.float64, generator=gen)
    x = cf.clone().requires_grad_(True)
    want = fvm.cell_flux_to_face_flux_lastwrite(x, g.cell_edge_index,
                                                g.face_index)
    fm = g.face_mask
    (grad,) = torch.autograd.grad((want[fm] * w[fm]).sum(), x)
    cut = seen = 0
    for r in range(world):
        got = load("lastwrite", world, r)
        ids = got["ids"].long()
        assert torch.equal(got["face_flux"], want.detach()[ids])
        cut += got["cut_owned"]
        seen += len(ids)
        cells = got["cell_ids"].long()
        torch.testing.assert_close(got["grad"], grad[cells], rtol=0,
                                   atol=1e-12 * float(grad.abs().max()))
    assert cut > 0 and seen == int(fm.sum())
