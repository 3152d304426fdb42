"""The port's VertPot family (VertPotA-G) against the JAX package's, with the
Flax variables carried over by ``params_from_flax``.

The JAX package's reference for every comparison is its ``"segment"``
route. Its fused Pallas route adds each GN block's residuals twice in
VertPot (its fused blocks return residualed latents to a module that adds
the residual itself), so it is never the reference here; the port's fused
route keeps the reference's semantics.

* The one-step total log loss of ``tests/test_golden.py`` (``PRNGKey(7)``
  weights on ``test_models.build_graph(grad_weights=True)``, hidden 32, 2
  blocks): within 1e-5 of the golden value and of the JAX package's
  (VertPotD within 2e-5: it measures 1.0013e-5, all of it from the
  train-mode BatchNorm of dt/V̄, a constant on that uniform mesh, whose
  output is the batch mean's rounding times 1/sqrt(eps) ~ 316 and so
  depends on the summation order; with the JAX package's batch statistics
  in place of the port's every total is within 1e-6 of JAX's); every loss
  component within 1e-4 relative of JAX's, or 1e-12 absolute where it is
  at f32 rounding level (the telescoped flux's continuity, ~1e-15); the
  port's own statistics within 1e-6 of JAX's.
* A rollout-mode forward on the RCM-ordered 300-point cylinder mesh (518
  cells, padded to 640) with order-1 MLS weights, f32 plain route, hidden
  32, 2 blocks, every BatchNorm moved off its init: each output within
  1e-5 of JAX's (largest difference over live rows relative to the
  output's largest magnitude).
* The fused route on the kernels' plain versions (``aggregation="pallas"``,
  bf16 latents; K3 -> K2 with both outputs -> K1 with both outputs per
  block), hidden 128, 2 blocks, against JAX's ``"segment"`` route in bf16:
  within 4e-2 (measured up to 1.9e-2).
* ``rollout_scan``: 4 steps against the JAX package's, errors and the final
  state within 1e-4 relative; VertPotA's and VertPotG's errors include
  ``divergence_raw_error``, at f32 rounding level, while
  ``divergence_error`` carries the z-score inverse's 3 x mean-flux offset.
* Train mode: the loss and the gradients' global norm of VertPotA and
  VertPotB within 1e-5 and 1e-4 relative of JAX's, with the JAX package's
  batch statistics.
* ``params_from_flax`` on the VertPot tree (top-level ``CellBlock_i``,
  ``FaceBlock_i``, ``decoder_vertex``, the BatchNorms at the top or under
  ``integrator``) at 3 blocks: every key mapped, none left over.
* VertPotA from ``config/e2e/vertpota.json`` through the port's config
  loader: its ``"banded"`` aggregation takes the plain route (the port's
  segment model's outputs exactly), and with the compute dtype set to f32
  one forward matches the JAX model on ``"segment"`` within 1e-5.
* The table route of the trainer's validation (unfused blocks: K6 es/er ->
  K7 -> cell MLP, K6 cf -> face MLP) against the index route's fused
  blocks, in f32, within 4e-2 (``test_torch_validate.py``'s tolerance).
"""

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
import dataclasses
import functools
import pathlib

import jax
import numpy as np
import pytest
import torch

from gnn_fluid_dynamics_tpu.data.synthetic import (channel_flow_trajectory,
                                                   make_geometry)
from gnn_fluid_dynamics_tpu.graph import from_geometry as jax_from_geometry
from gnn_fluid_dynamics_tpu.models import get_model_class as jax_model_class
from gnn_fluid_dynamics_tpu.models import normalizer as jax_norm
from gnn_fluid_dynamics_tpu.models.base import ModelConfig as JaxModelConfig
from gnn_fluid_dynamics_tpu.models.base import feature_masks as jax_masks
from gnn_fluid_dynamics_tpu.ops.reorder import rcm_reorder_geometry
from test_torch_flux_family import (check_bf16_fused_route, check_golden,
                                    check_golden_with_jax_statistics,
                                    check_rollout_forward, check_rollout_scan,
                                    check_train_mode,
                                    jax_batch_statistics)  # noqa: F401
from test_torch_fvgn_family import (_golden_graphs, _jax_golden, _rel,
                                    cylinder)  # noqa: F401

from gnn_fluid_dynamics_tpu_torch.data.pipeline import (MeshDataset,
                                                        Trajectory,
                                                        rollout_batch)
from gnn_fluid_dynamics_tpu_torch.graph import from_geometry, to_static_bands
from gnn_fluid_dynamics_tpu_torch.models.base import ModelConfig, feature_masks
from gnn_fluid_dynamics_tpu_torch.models.normalizer import StatsAccumulator
from gnn_fluid_dynamics_tpu_torch.models.registry import get_model_class
from gnn_fluid_dynamics_tpu_torch.models.vertpot import (
    calc_cell_flux_from_vertices)
from gnn_fluid_dynamics_tpu_torch.ops import kernels
from gnn_fluid_dynamics_tpu_torch.rollout import engine
from gnn_fluid_dynamics_tpu_torch.training import train as train_cli
from gnn_fluid_dynamics_tpu_torch.training.config import load_config
from gnn_fluid_dynamics_tpu_torch.weights import params_from_flax

ROOT = pathlib.Path(__file__).resolve().parents[1]
VARIANTS = ("VertPotA", "VertPotB", "VertPotC", "VertPotD", "VertPotE",
            "VertPotF", "VertPotG")
# VertPotD's golden: the BatchNorm of a constant, see the module docstring
GOLDEN_ATOL = {"VertPotD": 2e-5}
F32_TOL, BF16_TOL = 1e-5, 4e-2
# the raw telescoped flux's divergence: three f32 differences of the same
# potentials summed, so a few ulps of the fluxes, squared
RAW_DIVERGENCE_MAX = 1e-12
OUTPUTS = {
    "VertPotA": ("cell_velocity_change", "cell_flux", "face_velocity",
                 "face_pressure"),
    "VertPotB": ("cell_velocity_change", "cell_flux", "face_velocity",
                 "face_pressure"),
    "VertPotC": ("cell_velocity_change", "cell_flux", "face_pressure"),
    "VertPotD": ("cell_velocity_change", "face_velocity", "face_pressure",
                 "face_flux", "cell_flux"),
    "VertPotE": ("cell_velocity_change", "face_velocity", "face_pressure",
                 "face_flux"),
    "VertPotF": ("cell_velocity_change", "face_velocity", "face_pressure",
                 "face_flux", "cell_flux"),
    "VertPotG": ("cell_velocity_change", "cell_flux", "face_velocity",
                 "face_pressure", "face_flux"),
}


@pytest.mark.parametrize("name", VARIANTS)
def test_golden_one_step_loss(name):
    check_golden(name, GOLDEN_ATOL.get(name, 1e-5))


@pytest.mark.parametrize("name", VARIANTS)
def test_golden_with_the_jax_batch_statistics(name, jax_batch_statistics):
    check_golden_with_jax_statistics(name)


@pytest.mark.parametrize("name", VARIANTS)
def test_rollout_forward_matches_jax(cylinder, name):
    check_rollout_forward(cylinder, name, OUTPUTS[name])


@pytest.mark.parametrize("name", VARIANTS)
def test_fused_route_matches_jax_segment_in_bf16(cylinder, name):
    check_bf16_fused_route(cylinder, name, OUTPUTS[name])


@pytest.mark.parametrize("name", VARIANTS)
def test_rollout_scan_matches_jax(cylinder, name):
    errors = check_rollout_scan(cylinder, name)
    assert ("divergence_raw_error" in errors) == (name in ("VertPotA",
                                                          "VertPotG"))
    if "divergence_raw_error" in errors:
        raw = errors["divergence_raw_error"]
        assert float(raw.max()) <= RAW_DIVERGENCE_MAX
        assert float(errors["divergence_error"].min()) > 1e6 * float(raw.max())


@pytest.mark.parametrize("name", ["VertPotA", "VertPotB"])
def test_train_mode_loss_and_gradient_norm(name, jax_batch_statistics):
    check_train_mode(name)


def test_cell_flux_from_vertices_telescopes():
    """Each cell's three potential differences sum to 0 in exact arithmetic,
    and their order is the reference's [v1-v2, v2-v0, v0-v1]."""
    _, gt = _golden_graphs()
    psi = torch.randn(gt.num_vertices, 1, generator=torch.Generator()
                      .manual_seed(0), dtype=torch.float64)
    cf = calc_cell_flux_from_vertices(psi, gt)
    assert cf.shape == (gt.num_cells, 3)
    assert float(cf.sum(dim=1).abs().max()) <= 1e-15
    v = gt.vertex_face[:, 0].long()
    torch.testing.assert_close(cf[0], torch.stack(
        [psi[v[1], 0] - psi[v[2], 0], psi[v[2], 0] - psi[v[0], 0],
         psi[v[0], 0] - psi[v[1], 0]]), rtol=0, atol=0)


@pytest.mark.parametrize("name,mp", [("VertPotA", 3), ("VertPotD", 3),
                                     ("VertPotE", 2), ("VertPotB", 2)])
def test_params_from_flax_maps_the_vertpot_tree(name, mp):
    """Every key of the Flax tree lands on the port's state dict and every
    entry of the state dict is filled: the top-level ``CellBlock_i`` become
    ``blocks.i.cell_block`` (inside a ``GNBlock_i`` a ``CellBlock_0`` stays
    ``cell_block``)."""
    gj, _ = _golden_graphs()
    jm = jax_model_class(name)(JaxModelConfig(name=name, hidden_width=32,
                                              mp_num=mp))
    jm.set_stats(_jax_golden(name)[0].stats)
    tg, feats = jm.transform_features(gj, None, mode="train")
    variables = jm.init(jax.random.PRNGKey(3), tg, feats)
    assert f"CellBlock_{mp - 1}" in variables["params"]
    sd = params_from_flax(variables)
    tm = get_model_class(name)(ModelConfig(hidden_width=32, mp_num=mp),
                               device="cpu")
    assert sorted(sd) == sorted(tm.module.state_dict())
    tm.module.load_state_dict(sd)
    k = variables["params"][f"CellBlock_{mp - 1}"]["MLP_0"]["Dense_1"]["kernel"]
    np.testing.assert_array_equal(
        sd[f"blocks.{mp - 1}.cell_block.mlp.dense1.weight"].numpy(),
        np.asarray(k).T)
    assert "decoder_vertex.dense2.bias" in sd


def _calls(monkeypatch):
    """The kernel wrappers the model calls, in order, with ":dual" for both
    outputs."""
    log = []
    for name in ("fused_face_block", "fused_cell_block", "edges_to_vertices",
                 "gather_face_cells", "vertices_to_cells", "table_dual",
                 "table_single"):
        fn = getattr(kernels, name)

        def spy(*a, _name=name, _fn=fn, **k):
            log.append(_name + (":dual" if k.get("dual_out") else ""))
            return _fn(*a, **k)
        monkeypatch.setattr(kernels, name, spy)
    return log


@pytest.mark.parametrize("name", ["VertPotA", "VertPotE"])
def test_fused_route_calls_k3_k2_dual_k1_dual_per_block(cylinder, name,
                                                        monkeypatch):
    _, _, _, gt = cylinder
    tm = get_model_class(name)(ModelConfig(hidden_width=128, mp_num=3,
                                           aggregation="pallas",
                                           compute_dtype="bfloat16"),
                               device="cpu")
    _, feats = tm.transform_rollout(gt)
    acc = StatsAccumulator(tm.nmap)
    acc.update(feats, feature_masks(gt, feats))
    tm.set_stats(acc.finalize())
    log = _calls(monkeypatch)
    with torch.no_grad():
        out = tm.forward(gt, feats)
    assert log == ["edges_to_vertices", "fused_cell_block:dual",
                   "fused_face_block:dual"] * 3
    assert torch.isfinite(out["cell_velocity_change"]).all()


# ---- the shipped config --------------------------------------------------------

@pytest.fixture(scope="module")
def shipped():
    """config/e2e/vertpota.json through the port's loader, the JAX model of
    the same config on ``"segment"`` with seeded weights and the cylinder
    window's statistics."""
    cfg = load_config(str(ROOT / "config/e2e/vertpota.json"))
    geom = rcm_reorder_geometry(make_geometry("cylinder", n_points=300, seed=0))
    fields = channel_flow_trajectory(geom, num_timesteps=2, dt=0.01)
    gj = jax_from_geometry(geom, fields, dt=0.01, pad_multiple=128)
    gt = from_geometry(geom, fields, dt=0.01, pad_multiple=128, device="cpu")
    m = cfg.model
    jm = jax_model_class("VertPotA")(JaxModelConfig(
        name=m.name, hidden_width=m.hidden_width, mp_num=m.mp_num,
        aggregation="segment", compute_dtype="float32"))
    _, jfeats = jm.transform_rollout(gj)
    acc = jax_norm.StatsAccumulator(jm.nmap)
    acc.update(jfeats, jax_masks(gj, jfeats))
    jm.set_stats(acc.finalize())
    variables = jm.init(jax.random.PRNGKey(0), gj, jfeats)
    stats = {k: {s: float(v) for s, v in d.items()}
             for k, d in jm.stats.items()}
    return cfg, gj, gt, jm, variables, jfeats, stats


def _port_model(cfg, variables, stats, **changes):
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                             **changes))
    tm = train_cli.build_model(cfg, "cpu")
    tm.set_stats(stats)
    tm.module.load_state_dict(params_from_flax(variables))
    return tm


def test_shipped_config_builds_on_the_plain_route(shipped):
    cfg, _, gt, _, variables, _, stats = shipped
    assert (cfg.model.name, cfg.model.hidden_width, cfg.model.mp_num,
            cfg.model.aggregation, cfg.model.compute_dtype) == (
        "VertPotA", 128, 15, "banded", "bfloat16")
    tm = _port_model(cfg, variables, stats)
    seg = _port_model(cfg, variables, stats, aggregation="segment")
    _, feats = tm.transform_rollout(gt)
    with torch.no_grad():
        got, want = tm.forward(gt, feats), seg.forward(gt, feats)
    for key in OUTPUTS["VertPotA"]:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
        assert torch.isfinite(got[key]).all(), key


def test_shipped_config_in_f32_matches_jax(shipped):
    cfg, gj, gt, jm, variables, jfeats, stats = shipped
    tm = _port_model(cfg, variables, stats, compute_dtype="float32")
    _, feats = tm.transform_rollout(gt)
    jout, _ = jm.forward(variables, gj, jfeats, mode="rollout")
    with torch.no_grad():
        tout = tm.forward(gt, feats)
    cm, fm = gt.cell_mask.numpy(), gt.face_mask.numpy()
    for key in OUTPUTS["VertPotA"]:
        assert _rel(tout[key], jout[key], cm if key.startswith("cell")
                    else fm) <= F32_TOL, key


# ---- the validation's table route ----------------------------------------------

@functools.lru_cache(maxsize=None)
def _valid_set():
    geoms = [rcm_reorder_geometry(make_geometry("cylinder", n_points=n, seed=s))
             for n, s in ((300, 0), (320, 1))]
    trajs = [Trajectory(mesh_id=f"sim{i}", geom=g,
                        fields=channel_flow_trajectory(g, num_timesteps=4,
                                                       dt=0.01))
             for i, g in enumerate(geoms)]
    return MeshDataset(trajs, with_banded=True, banded_dtype="float32",
                       pad_multiple=128, device="cpu")


def test_table_route_matches_index_route(monkeypatch):
    """VertPotA on the validation batch: the table route's unfused blocks
    (K6 es/er -> K7 -> cell MLP, K6 cf -> face MLP; the kernels' plain
    versions) against the index route's fused blocks, in f32, on live rows;
    and a 2-step rollout on the table route keeps the raw divergence at
    rounding level."""
    ds = _valid_set()
    tm = get_model_class("VertPotA")(ModelConfig(hidden_width=128, mp_num=2,
                                                 aggregation="pallas"),
                                     device="cpu")
    table = to_static_bands(ds.get_batch(rollout_batch(ds)), derive_idx=False)
    index = to_static_bands(table, derive_idx=True)
    _, feats = tm.transform_rollout(table)
    acc = StatsAccumulator(tm.nmap)
    acc.update(feats, feature_masks(table, feats))
    tm.set_stats(acc.finalize())
    log = _calls(monkeypatch)
    with torch.no_grad():
        got = tm.forward(table, feats)
        on_tables, log[:] = list(log), []
        want = tm.forward(index, feats)
    assert on_tables == ["table_dual", "table_single", "table_dual"] * 2
    assert log == ["edges_to_vertices", "fused_cell_block:dual",
                   "fused_face_block:dual"] * 2
    cm, fm = table.cell_mask, table.face_mask
    for key in OUTPUTS["VertPotA"]:
        mask = cm if key.startswith("cell") else fm
        a, b = got[key][mask], want[key][mask]
        assert torch.isfinite(a).all(), key
        assert float((a - b).abs().max() / b.abs().max()) <= BF16_TOL, key
    gv, gp = ds.trajectory_targets([m for m, _ in rollout_batch(ds)], 0, 2)
    errors, _ = engine.rollout_scan(tm, table, feats, gv, gp,
                                    engine.RolloutConfig(num_steps=2))
    assert errors["divergence_raw_error"].shape == (2, 2)
    assert float(errors["divergence_raw_error"].max()) <= RAW_DIVERGENCE_MAX
