"""The port's FluxD against the JAX package's: one rollout-mode forward and a
5-step rollout, with the Flax weights carried over by ``params_from_flax``.

The mesh is a small RCM-ordered cylinder channel (518 cells, padded to 640),
hidden 128 and 2 GN blocks. ``aggregation="pallas"`` runs the JAX package's
fused Pallas kernels in interpret mode and the port's fused path on the CPU
(the kernels' plain versions); its latents are bf16 whatever the compute dtype.

Tolerance, as the largest difference over the live rows of an output relative
to that output's largest magnitude: 1e-5 for the f32 plain path (the same math
up to f32 summation order); 4e-2 for any path with bf16 latents (each of the
MLPs' bf16 roundings, 2**-8 relative, can fall differently, and the encoder,
two GN blocks and the decoder compound them; measured up to 2.6e-2).

The rollout test uses the reference's constant output scales
(``scale_init=None``): with random weights and the statistics' scales the
model amplifies any difference about five-fold per step, so a 5-step
comparison would measure the random model, not the port.
"""

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
import jax
import numpy as np
import pytest
import torch

from gnn_fluid_dynamics_tpu.data.synthetic import (channel_flow_trajectory,
                                                   make_geometry)
from gnn_fluid_dynamics_tpu.graph import from_geometry as jax_from_geometry
from gnn_fluid_dynamics_tpu.graph import to_static_bands
from gnn_fluid_dynamics_tpu.models import get_model_class
from gnn_fluid_dynamics_tpu.models.base import ModelConfig as JaxModelConfig
from gnn_fluid_dynamics_tpu.models.base import feature_masks as jax_feature_masks
from gnn_fluid_dynamics_tpu.models.normalizer import \
    StatsAccumulator as JaxStatsAccumulator
from gnn_fluid_dynamics_tpu.ops.reorder import rcm_reorder_geometry
from gnn_fluid_dynamics_tpu.rollout import engine as jax_engine

from gnn_fluid_dynamics_tpu_torch.graph import from_geometry
from gnn_fluid_dynamics_tpu_torch.models.base import ModelConfig, feature_masks
from gnn_fluid_dynamics_tpu_torch.models.flux import FluxD
from gnn_fluid_dynamics_tpu_torch.models.normalizer import StatsAccumulator
from gnn_fluid_dynamics_tpu_torch.rollout import engine
from gnn_fluid_dynamics_tpu_torch.weights import params_from_flax

HIDDEN, MP = 128, 2
STEPS = 5
F32_TOL, BF16_TOL = 1e-5, 4e-2
OUTPUTS = ("cell_velocity_change", "face_velocity", "face_pressure",
           "face_flux", "cell_flux")


@pytest.fixture(scope="module")
def mesh():
    geom = rcm_reorder_geometry(make_geometry("cylinder", n_points=300, seed=0))
    fields = channel_flow_trajectory(geom, num_timesteps=STEPS + 2, dt=0.01)
    window = {k: v[:2] for k, v in fields.items()}
    gj = to_static_bands(jax_from_geometry(geom, window, dt=0.01,
                                           pad_multiple=128, with_banded=True))
    gt = from_geometry(geom, window, dt=0.01, pad_multiple=128, device="cpu")
    pad = ((0, 0), (0, gt.num_cells - geom["cell_pos"].shape[0]), (0, 0))
    gv = np.pad(fields["cell_velocity"][1:STEPS + 1], pad)
    gp = np.pad(fields["cell_pressure"][1:STEPS + 1], pad)
    return gj, gt, gv, gp


def _models(mesh, aggregation, dtype, scale_init="stats"):
    """The JAX FluxD (stats, seeded init) and the port's FluxD with the same
    weights; each accumulates its own statistics."""
    gj, gt, _, _ = mesh
    jm = get_model_class("FluxD")(JaxModelConfig(
        name="FluxD", hidden_width=HIDDEN, mp_num=MP, aggregation=aggregation,
        compute_dtype=dtype, scale_init=scale_init))
    _, jfeats = jm.transform_rollout(gj)
    acc = JaxStatsAccumulator(jm.nmap)
    acc.update(jfeats, jax_feature_masks(gj, jfeats))
    jm.set_stats(acc.finalize())
    variables = jm.init(jax.random.PRNGKey(0), gj, jfeats)

    tm = FluxD(ModelConfig(hidden_width=HIDDEN, mp_num=MP,
                           aggregation=aggregation, compute_dtype=dtype,
                           scale_init=scale_init), device="cpu")
    _, tfeats = tm.transform_rollout(gt)
    acc = StatsAccumulator(tm.nmap)
    acc.update(tfeats, feature_masks(gt, tfeats))
    tm.set_stats(acc.finalize())
    tm.module.load_state_dict(params_from_flax(variables))
    return jm, variables, jfeats, tm, tfeats


def _rel_err(got, want, mask):
    got = got.detach().float().numpy()[mask]
    want = np.asarray(want, np.float32)[mask]
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


CASES = [("segment", "float32", F32_TOL), ("segment", "bfloat16", BF16_TOL),
         ("pallas", "float32", BF16_TOL), ("pallas", "bfloat16", BF16_TOL)]


@pytest.mark.parametrize("aggregation,dtype,tol", CASES)
def test_forward_matches_jax(mesh, aggregation, dtype, tol):
    gj, gt, _, _ = mesh
    jm, variables, jfeats, tm, tfeats = _models(mesh, aggregation, dtype)
    for key in ("cell_x", "cell_y", "face_x", "face_y"):
        np.testing.assert_allclose(tfeats[key].numpy(), np.asarray(jfeats[key]),
                                   rtol=1e-6, atol=1e-7, err_msg=key)
    jout, _ = jm.forward(variables, gj, jfeats, mode="rollout")
    with torch.no_grad():
        tout = tm.forward(gt, tfeats)
    cm, fm = gt.cell_mask.numpy(), gt.face_mask.numpy()
    for key in OUTPUTS:
        mask = cm if key.startswith("cell") else fm
        assert _rel_err(tout[key], jout[key], mask) <= tol, key


@pytest.mark.parametrize("scale_init", [None, "stats",
                                        (("flux", 0.02), ("pressure", 0.5))])
def test_scale_init_matches_jax(mesh, scale_init):
    gj, gt, _, _ = mesh
    jm, variables, jfeats, tm, tfeats = _models(mesh, "segment", "float32",
                                                scale_init)
    fresh = FluxD(tm.config, device="cpu")
    fresh.set_stats({k: {s: float(v) for s, v in d.items()}
                     for k, d in tm.stats.items()})
    jparams = variables["params"]
    for name, mod in fresh.module.scales().items():
        key = {"velocity_x": "velocity_scale_x", "velocity_y": "velocity_scale_y",
               "pressure": "pressure_scale", "flux": "flux_scale",
               "diffusion": "diffusion_scale"}[name]
        np.testing.assert_array_equal(mod.scale.detach().numpy(),
                                      np.asarray(jparams[key]["scale"]))
    jout, _ = jm.forward(variables, gj, jfeats, mode="rollout")
    with torch.no_grad():
        tout = tm.forward(gt, tfeats)
    assert _rel_err(tout["face_pressure"], jout["face_pressure"],
                    gt.face_mask.numpy()) <= F32_TOL


@pytest.mark.parametrize("aggregation,dtype,tol",
                         [CASES[0], CASES[3]])
def test_rollout_matches_jax(mesh, aggregation, dtype, tol):
    gj, gt, gv, gp = mesh
    jm, variables, jfeats, tm, tfeats = _models(mesh, aggregation, dtype,
                                                scale_init=None)
    cfg = jax_engine.RolloutConfig(num_steps=STEPS, compute_error=True)
    jerr, jfields = jax_engine.rollout_scan(jm, variables, gj, jfeats, gv, gp,
                                            cfg)
    terr, tfields = engine.rollout_scan(
        tm, gt, tfeats, torch.from_numpy(gv), torch.from_numpy(gp),
        engine.RolloutConfig(num_steps=STEPS, compute_error=True))
    for key in ("velocity_error", "pressure_error", "divergence_error"):
        assert terr[key].shape == (STEPS, 1)
        np.testing.assert_allclose(terr[key].numpy(), np.asarray(jerr[key]),
                                   rtol=tol, err_msg=key)
    assert _rel_err(tfields["final_cell_state"], jfields["final_cell_state"],
                    gt.cell_mask.numpy()) <= tol
    summary, evo = engine.error_summary(terr)
    want, _ = jax_engine.error_summary(jerr)
    assert summary["total_mean_error"] == pytest.approx(
        want["total_mean_error"], rel=tol)
    assert len(evo["velocity_error"]["evo_all"]) == STEPS


def test_stats_match_jax(mesh):
    jm, _, _, tm, _ = _models(mesh, "segment", "float32")
    assert sorted(tm.stats) == sorted(jm.stats)
    for key in jm.stats:
        for s in ("mean", "std", "min", "max"):
            assert float(tm.stats[key][s]) == float(jm.stats[key][s]), (key, s)


def test_state_dict_round_trip(mesh):
    """``params_from_flax`` fills every parameter of the port's module, and
    nothing else (strict load), with Dense kernels transposed."""
    _, variables, _, tm, _ = _models(mesh, "segment", "float32")
    sd = params_from_flax(variables)
    assert sorted(sd) == sorted(tm.module.state_dict())
    k = variables["params"]["EncodeProcessDecode_0"]["GNBlock_1"][
        "FaceBlock_0"]["MLP_0"]["Dense_0"]["kernel"]
    np.testing.assert_array_equal(
        sd["epd.blocks.1.face_block.mlp.dense0.weight"].numpy(), np.asarray(k).T)


def test_rollout_needs_a_card_unless_cpu():
    cfg = ModelConfig(hidden_width=32, mp_num=1)
    if torch.cuda.is_available():
        assert FluxD(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FluxD(cfg)
    assert FluxD(cfg, device="cpu").device.type == "cpu"


def test_rollout_rejects_a_graph_on_another_device(mesh):
    _, gt, _, _ = mesh
    tm = FluxD(ModelConfig(hidden_width=32, mp_num=1), device="cpu")
    _, feats = tm.transform_rollout(gt)
    tm.device = torch.device("meta")
    with pytest.raises(ValueError, match="graph is on"):
        engine.rollout_scan(tm, gt, feats, config=engine.RolloutConfig(
            num_steps=1, compute_error=False))
