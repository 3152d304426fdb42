"""The trainer's validation rollout on a graph without index vectors: the
port's table route (K6 -> K7 -> cell MLP, K6 -> face MLP per block) against
its index route, and its ``validate`` against the JAX package's
``Trainer.validate``.

Two RCM-ordered cylinder meshes (518 and 538 cells) padded to one shape and
batched, FluxD at hidden 128 and 2 blocks, ``aggregation="pallas"``: the JAX
package runs its dense-table Pallas kernels in interpret mode, the port the
kernels' plain versions on the CPU. The JAX side's tables are f32, so that
its physics gathers (``fc3``, ``cf``) stay f32 as the port's index gathers
do. ``scale_init=None``: with random weights and the statistics' scales the
model amplifies any difference about fivefold per step.

Tolerance 4e-2, relative: bf16 latents through the kernels on either side,
whose roundings (2**-8 relative each) can fall differently, compounded by
the encoder, two blocks, the decoder and the steps of the rollout.
"""

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
import dataclasses
import gc
import weakref

import jax
import numpy as np
import pytest
import torch

from gnn_fluid_dynamics_tpu.data.pipeline import MeshDataset as JaxDataset
from gnn_fluid_dynamics_tpu.data.pipeline import Trajectory as JaxTrajectory
from gnn_fluid_dynamics_tpu.data.synthetic import (channel_flow_trajectory,
                                                   make_geometry)
from gnn_fluid_dynamics_tpu.models import get_model_class
from gnn_fluid_dynamics_tpu.models.base import ModelConfig as JaxModelConfig
from gnn_fluid_dynamics_tpu.models.base import feature_masks as jax_masks
from gnn_fluid_dynamics_tpu.models.normalizer import \
    StatsAccumulator as JaxStatsAccumulator
from gnn_fluid_dynamics_tpu.ops.reorder import rcm_reorder_geometry
from gnn_fluid_dynamics_tpu.training.config import Config
from gnn_fluid_dynamics_tpu.training.trainer import Trainer

from gnn_fluid_dynamics_tpu_torch.data.pipeline import (MeshDataset,
                                                        Trajectory,
                                                        rollout_batch)
from gnn_fluid_dynamics_tpu_torch.graph import to_static_bands
from gnn_fluid_dynamics_tpu_torch.models import arch
from gnn_fluid_dynamics_tpu_torch.models.base import ModelConfig, feature_masks
from gnn_fluid_dynamics_tpu_torch.models.flux import FluxD
from gnn_fluid_dynamics_tpu_torch.models.normalizer import StatsAccumulator
from gnn_fluid_dynamics_tpu_torch.ops import kernels
from gnn_fluid_dynamics_tpu_torch.rollout.engine import error_summary
from gnn_fluid_dynamics_tpu_torch.training import validate as validate_module
from gnn_fluid_dynamics_tpu_torch.training.validate import (validate,
                                                            validation_errors)
from gnn_fluid_dynamics_tpu_torch.weights import params_from_flax

HIDDEN, MP, STEPS = 128, 2, 4
BF16_TOL = 4e-2
KERNELS = ("fused_face_block", "fused_cell_block", "edges_to_vertices",
           "gather_face_cells", "vertices_to_cells", "table_dual",
           "table_single")


@pytest.fixture(scope="module")
def data():
    geoms = [rcm_reorder_geometry(make_geometry("cylinder", n_points=n, seed=s))
             for n, s in ((300, 0), (320, 1))]
    fields = [channel_flow_trajectory(g, num_timesteps=STEPS + 2, dt=0.01)
              for g in geoms]

    def trajs(cls):
        return [cls(mesh_id=f"sim{i}", geom=g, fields=f)
                for i, (g, f) in enumerate(zip(geoms, fields))]

    dj = JaxDataset(trajs(JaxTrajectory), with_banded=True,
                    banded_dtype="float32", pad_multiple=128)
    dt = MeshDataset(trajs(Trajectory), with_banded=True,
                     banded_dtype="float32", pad_multiple=128, device="cpu")
    return dj, dt


@pytest.fixture(scope="module")
def models(data):
    """The JAX FluxD (stats, seeded init) and the port's FluxD with the same
    weights; each accumulates its own statistics from its first batch."""
    dj, dt = data
    cfg = dict(name="FluxD", hidden_width=HIDDEN, mp_num=MP,
               aggregation="pallas", compute_dtype="bfloat16", scale_init=None)
    jm = get_model_class("FluxD")(JaxModelConfig(**cfg))
    gj = dj.get_batch(rollout_batch(dj))
    _, jfeats = jm.transform_rollout(gj)
    acc = JaxStatsAccumulator(jm.nmap)
    acc.update(jfeats, jax_masks(gj, jfeats))
    jm.set_stats(acc.finalize())
    trainer = Trainer(Config(), jm)
    state = trainer.init_state(jax.random.PRNGKey(0), gj, jfeats)

    tm = FluxD(ModelConfig(**cfg), device="cpu")
    gt = dt.get_batch(rollout_batch(dt))
    _, tfeats = tm.transform_rollout(gt)
    acc = StatsAccumulator(tm.nmap)
    acc.update(tfeats, feature_masks(gt, tfeats))
    tm.set_stats(acc.finalize())
    tm.module.load_state_dict(params_from_flax(
        {"params": state.params, "batch_stats": state.batch_stats}))
    return trainer, state, tm


class _Calls:
    """Counts the calls of every kernel wrapper the GN blocks reach (on the
    CPU no wrapper launches, so the launch counters stay at 0)."""

    def __init__(self, monkeypatch):
        self.n = dict.fromkeys(KERNELS, 0)
        for name in KERNELS:
            fn = getattr(kernels, name)

            def spy(*a, _name=name, _fn=fn, **k):
                self.n[_name] += 1
                return _fn(*a, **k)
            monkeypatch.setattr(kernels, name, spy)


def test_table_route_matches_index_route(data, models, monkeypatch):
    """One forward of the same model on the batch's table route and on its
    index route (``to_static_bands(derive_idx=True)``: fused K1-K3), on live
    rows, with the kernels each route must reach and no other. The model
    computes in f32 here: the fused kernels round their MLPs' activations to
    bf16 where the unfused MLPs keep the compute dtype, so in bf16 the two
    routes would also part by the MLPs' own bf16 roundings, which fall at
    other points on each route."""
    _, dt = data
    _, _, bf16_model = models
    tm = FluxD(dataclasses.replace(bf16_model.config, compute_dtype="float32"),
               device="cpu")
    tm.set_stats({k: {s: float(v) for s, v in st.items()}
                  for k, st in bf16_model.stats.items()})
    tm.module.load_state_dict(bf16_model.module.state_dict())
    table = to_static_bands(dt.get_batch(rollout_batch(dt)), derive_idx=False)
    index = to_static_bands(table, derive_idx=True)
    assert table.table_route and not index.table_route
    _, feats = tm.transform_rollout(table)
    calls = _Calls(monkeypatch)
    with torch.no_grad():
        got = tm.forward(table, feats)
        on_tables = dict(calls.n)
        calls.n = dict.fromkeys(KERNELS, 0)
        want = tm.forward(index, feats)
    assert on_tables == dict(dict.fromkeys(KERNELS, 0), table_dual=2 * MP,
                             table_single=MP)
    assert calls.n == dict(dict.fromkeys(KERNELS, 0), fused_face_block=MP,
                           fused_cell_block=MP, edges_to_vertices=MP)
    cm, fm = table.cell_mask, table.face_mask
    for key in ("cell_velocity_change", "face_velocity", "face_pressure",
                "face_flux", "cell_flux"):
        mask = cm if key.startswith("cell") else fm
        a, b = got[key][mask], want[key][mask]
        assert torch.isfinite(a).all(), key
        rel = float((a - b).abs().max() / b.abs().max())
        assert rel <= BF16_TOL, (key, rel)


@pytest.mark.parametrize("aggregation", ["segment", "banded", "gather"])
def test_plain_names_read_no_tables(data, models, monkeypatch, aggregation):
    """The JAX package's non-kernel backends take the port's plain route on
    the table route too: no kernel, the same outputs as ``"segment"``."""
    _, dt = data
    _, _, tm = models
    table = to_static_bands(dt.get_batch(rollout_batch(dt)), derive_idx=False)
    model = FluxD(dataclasses.replace(tm.config, aggregation=aggregation),
                  device="cpu")
    model.stats = tm.stats
    model.module.load_state_dict(tm.module.state_dict())
    _, feats = model.transform_rollout(table)
    calls = _Calls(monkeypatch)
    with torch.no_grad():
        got = model.forward(table, feats)
        want = model.forward(to_static_bands(table), feats)
    assert calls.n == dict.fromkeys(KERNELS, 0)
    for key in ("cell_velocity_change", "face_flux"):
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)


def test_training_refuses_the_kernel_route(models):
    _, _, tm = models
    x = torch.zeros(1)
    assert arch.kernel_route(tm.arch, x)
    assert not arch.kernel_route(tm.arch, x, train=True)


def test_validate_matches_jax_trainer(data, models):
    dj, dt = data
    trainer, state, tm = models
    plots = {}

    class Logger:
        def save_plots(self, evo, step, prefix):
            plots.update(evo)

    trainer.logger = Logger()
    want = trainer.validate(state, dj, STEPS)
    got = validate(tm, dt, STEPS)
    assert sorted(got) == sorted(want)
    assert np.isfinite(got["total_mean_error"])
    assert got["total_mean_error"] == pytest.approx(want["total_mean_error"],
                                                    rel=BF16_TOL)
    for key in ("velocity_error/mean_all", "pressure_error/mean_all",
                "divergence_error/mean_all"):
        assert got[key] == pytest.approx(want[key], rel=BF16_TOL), key
    # per-trajectory evolution, from the cached validation inputs
    _, evo = error_summary(validation_errors(tm, dt, STEPS), dt.sim_ids())
    for name in ("velocity_error", "pressure_error"):
        assert sorted(evo[name]) == sorted(plots[name]) == [
            "evo_all", "evo_sim0", "evo_sim1"]
        for sid in ("sim0", "sim1"):
            np.testing.assert_allclose(evo[name][f"evo_{sid}"],
                                       plots[name][f"evo_{sid}"],
                                       rtol=BF16_TOL, err_msg=(name, sid))


def test_validate_inputs_follow_the_dataset(data, models):
    """The validation inputs are cached per dataset, not per model: a second
    dataset (the same trajectories in the other order) gets its own batch,
    whose per-trajectory errors are the first one's swapped, and a freed
    dataset's inputs go with it."""
    _, dt = data
    _, _, tm = models
    first = validation_errors(tm, dt, 2)
    other = MeshDataset(list(reversed(dt.trajectories)), with_banded=True,
                        banded_dtype="float32", pad_multiple=128, device="cpu")
    assert other.sim_ids() == ["sim1", "sim0"]
    second = validation_errors(tm, other, 2)
    for name in ("velocity_error", "pressure_error"):
        torch.testing.assert_close(second[name], first[name].flip(1),
                                   rtol=1e-5, atol=0)
    ref = weakref.ref(other)
    # garbage of earlier tests (a traceback's frame holding a validation
    # dataset) is collected first, so that the count moves by this one
    gc.collect()
    cached = len(validate_module._VALID_INPUTS)
    del other
    gc.collect()
    assert ref() is None and len(validate_module._VALID_INPUTS) == cached - 1
