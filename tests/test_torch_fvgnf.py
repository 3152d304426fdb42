"""The port's FvgnF (and FvgnA) against the JAX package's: one rollout-mode
forward and a 5-step rollout with the error metrics, with the Flax variables
(params and BatchNorm statistics) carried over by ``params_from_flax``.

The mesh is the small RCM-ordered cylinder channel of
``tests/test_torch_fluxd.py`` (518 cells, padded to 640), hidden 128 and 2
applications of the shared GN block. The integrator's BatchNorm gets a
scale, bias, running mean and running variance away from Flax's init (1, 0,
0, 1), so that their mapping is exercised.

``aggregation="pallas"`` runs the JAX package's Pallas kernels in interpret
mode: for FvgnF the unfused ones (the step scalar refuses the fused block),
the edge->vertex sum, the 3-vertex mean and the owner/neighbour gather; for
FvgnA the fused ones. The port takes the matching kernel route on the CPU,
through the kernels' plain versions.

Tolerance, as the largest difference over the live rows of an output
relative to that output's largest magnitude: 1e-5 for the f32 plain route
(the same math up to f32 summation order); 4e-2 for any route with bf16
latents or MLPs (each bf16 rounding, 2**-8 relative, can fall differently
where an f32 sum was taken in another order, and the encoder, the block's
applications and the decoder compound them), as for FluxD.
"""

import jax
import numpy as np
import pytest
import torch

from gnn_fluid_dynamics_tpu.data.synthetic import (channel_flow_trajectory,
                                                   make_geometry)
from gnn_fluid_dynamics_tpu.graph import from_geometry as jax_from_geometry
from gnn_fluid_dynamics_tpu.graph import to_static_bands
from gnn_fluid_dynamics_tpu.models import get_model_class as jax_model_class
from gnn_fluid_dynamics_tpu.models.base import ModelConfig as JaxModelConfig
from gnn_fluid_dynamics_tpu.models.base import feature_masks as jax_feature_masks
from gnn_fluid_dynamics_tpu.models.normalizer import \
    StatsAccumulator as JaxStatsAccumulator
from gnn_fluid_dynamics_tpu.ops.reorder import rcm_reorder_geometry
from gnn_fluid_dynamics_tpu.rollout import engine as jax_engine

from gnn_fluid_dynamics_tpu_torch.data.node_types import NodeType
from gnn_fluid_dynamics_tpu_torch.graph import from_geometry
from gnn_fluid_dynamics_tpu_torch.models.base import ModelConfig, feature_masks
from gnn_fluid_dynamics_tpu_torch.models.normalizer import StatsAccumulator
from gnn_fluid_dynamics_tpu_torch.models.registry import (MODEL_REGISTRY,
                                                          get_model_class)
from gnn_fluid_dynamics_tpu_torch.ops import kernels
from gnn_fluid_dynamics_tpu_torch.rollout import engine
from gnn_fluid_dynamics_tpu_torch.weights import params_from_flax

HIDDEN, MP = 128, 2
STEPS = 5
F32_TOL, BF16_TOL = 1e-5, 4e-2
OUTPUTS = ("cell_velocity_change", "face_velocity", "face_pressure",
           "_norm_face_area")
# the integrator's BatchNorm, away from Flax's init
BN_PARAMS = {"scale": 1.3, "bias": -0.2}
BN_STATS = {"mean": 0.4, "var": 2.5}
BN_PATH = ("integrator", "face_area_norm", "MaskedBatchNorm_0", "BatchNorm_0")


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


def _set_batch_norm(variables):
    """``variables`` with the integrator's BatchNorm set to BN_PARAMS and
    BN_STATS (Flax variables are immutable trees of dicts: rebuilt)."""
    def put(tree, path, leaves):
        if not path:
            return {k: np.full_like(np.asarray(v), leaves.get(k, v))
                    for k, v in tree.items()}
        return {**tree, path[0]: put(tree[path[0]], path[1:], leaves)}
    return {"params": put(dict(variables["params"]), BN_PATH, BN_PARAMS),
            "batch_stats": put(dict(variables["batch_stats"]), BN_PATH,
                               BN_STATS)}


def _models(mesh, name, aggregation, dtype):
    """The JAX model (stats, seeded init, BatchNorm moved off its init) and
    the port's with the same variables; each accumulates its own
    statistics."""
    gj, gt, _, _ = mesh
    jm = jax_model_class(name)(JaxModelConfig(
        name=name, hidden_width=HIDDEN, mp_num=MP, aggregation=aggregation,
        compute_dtype=dtype))
    _, jfeats = jm.transform_rollout(gj)
    acc = JaxStatsAccumulator(jm.nmap)
    acc.update(jfeats, jax_feature_masks(gj, jfeats))
    jm.set_stats(acc.finalize())
    variables = _set_batch_norm(jm.init(jax.random.PRNGKey(0), gj, jfeats))

    tm = get_model_class(name)(ModelConfig(
        name=name, hidden_width=HIDDEN, mp_num=MP, aggregation=aggregation,
        compute_dtype=dtype), device="cpu")
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


def _forward_matches(mesh, name, aggregation, dtype, tol):
    gj, gt, _, _ = mesh
    jm, variables, jfeats, tm, tfeats = _models(mesh, name, aggregation, dtype)
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


@pytest.mark.parametrize("aggregation,dtype,tol", CASES)
def test_forward_matches_jax(mesh, aggregation, dtype, tol):
    _forward_matches(mesh, "FvgnF", aggregation, dtype, tol)


def test_fvgna_fused_forward_matches_jax(mesh):
    """FvgnA has no step scalar: on the kernel route its blocks are fused
    (K3 -> K2 -> K1), against the JAX package's fused Pallas blocks."""
    _forward_matches(mesh, "FvgnA", "pallas", "bfloat16", BF16_TOL)


def test_kernel_route_launches_nothing_on_the_cpu(mesh):
    """The kernel route of FvgnF reaches K3, K5 and K4 (their plain versions
    here, which count no launch), and FvgnA's K1-K3."""
    _, gt, _, _ = mesh
    before = [f.launches for f in (kernels.fused_face_block,
                                   kernels.fused_cell_block,
                                   kernels.edges_to_vertices,
                                   kernels.gather_face_cells,
                                   kernels.vertices_to_cells)]
    for name in ("FvgnF", "FvgnA"):
        tm = get_model_class(name)(ModelConfig(
            hidden_width=HIDDEN, mp_num=MP, aggregation="pallas"),
            device="cpu")
        _, feats = tm.transform_rollout(gt)
        acc = StatsAccumulator(tm.nmap)
        acc.update(feats, feature_masks(gt, feats))
        tm.set_stats(acc.finalize())
        with torch.no_grad():
            out = tm.forward(gt, feats)
        assert torch.isfinite(out["face_velocity"]).all()
    after = [f.launches for f in (kernels.fused_face_block,
                                  kernels.fused_cell_block,
                                  kernels.edges_to_vertices,
                                  kernels.gather_face_cells,
                                  kernels.vertices_to_cells)]
    assert after == before


@pytest.mark.parametrize("aggregation,dtype,tol", [CASES[0], CASES[3]])
def test_rollout_matches_jax(mesh, aggregation, dtype, tol):
    """5 steps with the error metrics, whose divergence is of the predicted
    face velocity with the INFLOW faces clamped to their targets."""
    gj, gt, gv, gp = mesh
    jm, variables, jfeats, tm, tfeats = _models(mesh, "FvgnF", aggregation,
                                                dtype)
    cfg = jax_engine.RolloutConfig(num_steps=STEPS, compute_error=True)
    jerr, jfields = jax_engine.rollout_scan(jm, variables, gj, jfeats, gv, gp,
                                            cfg)
    terr, tfields = engine.rollout_scan(
        tm, gt, tfeats, torch.from_numpy(gv), torch.from_numpy(gp),
        engine.RolloutConfig(num_steps=STEPS, compute_error=True))
    for key in ("velocity_error", "pressure_error", "divergence_error"):
        assert terr[key].shape == (STEPS, 1)
        assert float(terr[key].abs().max()) > 0.0, key
        np.testing.assert_allclose(terr[key].numpy(), np.asarray(jerr[key]),
                                   rtol=tol, err_msg=key)
    assert _rel_err(tfields["final_cell_state"], jfields["final_cell_state"],
                    gt.cell_mask.numpy()) <= tol


def test_divergence_metric_clamps_inflow_faces(mesh):
    """The face-velocity branch replaces the INFLOW faces' predicted velocity
    by their targets, and only those."""
    _, gt, _, _ = mesh
    tm = get_model_class("FvgnF")(ModelConfig(hidden_width=16, mp_num=1),
                                  device="cpu")
    _, feats = tm.transform_rollout(gt)
    rng = np.random.default_rng(0)
    uf = torch.from_numpy(rng.normal(size=(gt.num_faces, 2)).astype(np.float32))
    inflow = gt.face_type.reshape(-1) == NodeType.INFLOW
    assert inflow.any()
    div = engine._divergence_metric({"face_velocity": uf}, feats, gt)
    uf2 = uf.clone()
    uf2[inflow] = 1e3
    torch.testing.assert_close(
        engine._divergence_metric({"face_velocity": uf2}, feats, gt), div,
        rtol=0, atol=0)
    torch.testing.assert_close(
        engine._divergence_metric({}, feats, gt),
        torch.zeros_like(gt.cell_volume), rtol=0, atol=0)


def test_state_dict_round_trip_with_batch_stats(mesh):
    """``params_from_flax`` fills every parameter and buffer of FvgnF's
    module, the BatchNorm's running statistics included, and nothing else
    (strict load); the one shared block is ``blocks.0``."""
    _, variables, _, tm, _ = _models(mesh, "FvgnF", "segment", "float32")
    sd = params_from_flax(variables)
    assert sorted(sd) == sorted(tm.module.state_dict())
    bn = "integrator.face_area_norm.masked_batch_norm.batch_norm."
    for key, want in (("weight", BN_PARAMS["scale"]), ("bias", BN_PARAMS["bias"]),
                      ("running_mean", BN_STATS["mean"]),
                      ("running_var", BN_STATS["var"])):
        np.testing.assert_array_equal(sd[bn + key].numpy(),
                                      np.float32([want]))
        np.testing.assert_array_equal(
            tm.module.state_dict()[bn + key].numpy(), np.float32([want]))
    assert not any(k.startswith("epd.blocks.1.") for k in sd)
    k = variables["params"]["EncodeProcessDecode_0"]["GNBlock_0"][
        "CellBlock_0"]["MLP_0"]["Dense_0"]["kernel"]
    assert np.asarray(k).shape == (HIDDEN + HIDDEN // 2 + 1, HIDDEN)
    np.testing.assert_array_equal(
        sd["epd.blocks.0.cell_block.mlp.dense0.weight"].numpy(), np.asarray(k).T)


def test_step_scalars_are_one_based():
    tm = get_model_class("FvgnF")(ModelConfig(hidden_width=16, mp_num=4),
                                  device="cpu")
    np.testing.assert_array_equal(
        tm.module.epd.step_scalars.numpy().reshape(-1),
        np.float32([0.25, 0.5, 0.75, 1.0]))
    assert len(tm.module.epd.blocks) == 1


def test_registry():
    assert sorted(MODEL_REGISTRY) == ["FluxA", "FluxD", "FvgnA", "FvgnF",
                                      "MgnA", "MgnB", "MgnC"]
    assert get_model_class("FvgnF").name == "FvgnF"
    with pytest.raises(KeyError, match="not ported yet"):
        get_model_class("StreamFuncA")
    with pytest.raises(KeyError, match="unknown model"):
        get_model_class("NoSuchModel")
    with pytest.raises(NotImplementedError, match="FluxIntegrator"):
        get_model_class("FluxA")(ModelConfig(hidden_width=16, mp_num=1),
                                 device="cpu")
